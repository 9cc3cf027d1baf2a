"""Device operations by category, from their names in the profiler's trace.

The categories of ``profile_models.py`` (first match wins), with the port's
two kernel families split into forward and backward. B3's backward
launches the forward's chunk-state kernel instantiated with ``BWD = true``
(``ssd_chunk_state_kernel<64, true>``), so that instance counts as
backward.
"""
from __future__ import annotations

import re

CATEGORIES = [
    ("copy_h2d", re.compile(r"^Memcpy HtoD")),
    ("copy_d2h", re.compile(r"^Memcpy DtoH")),
    ("copy_other", re.compile(r"^Memcpy|^Memset", re.I)),
    ("b2_bwd", re.compile(r"flash_bwd")),
    ("b2_fwd", re.compile(r"flash")),
    ("b3_bwd", re.compile(r"ssd_bwd_|ssd_chunk_state_kernel<\d+, true>")),
    ("b3_fwd", re.compile(r"ssd_")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass|sm90_", re.I)),
    ("elementwise", re.compile(".")),
]

#: Categories that move bytes between host and card.
HOST_COPIES = ("copy_h2d", "copy_d2h")
#: Categories that are no kernel (copies and memsets).
NOT_KERNELS = ("copy_h2d", "copy_d2h", "copy_other")


def category(name: str) -> str:
    """The category of a device operation named ``name``."""
    return next(c for c, pat in CATEGORIES if pat.search(name))
