"""Production mesh construction and the card's constants.

A port of ``repro.launch.mesh``. The meshes are functions, not module
state, so that importing this module starts no process group.

The reference also carries ``LATENCY_HIDING_XLA_FLAGS`` and
``apply_latency_hiding_flags``: flags that ask XLA's scheduler to overlap
collectives and host copies with compute inside a compiled graph. They have
no torch counterpart, and the port has no copy of them. Eager collectives
run on NCCL's own stream already; the port posts its overlapped transfers
by hand, as the reference's ``StreamingExecutor`` does: the next layer's
gather (``fsdp_stream``) or host copy (``host_offload``) is issued before
the current layer computes (:func:`repro_torch.core.tiering.tiered_scan`).
"""
from __future__ import annotations

import torch


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production meshes over ``device``'s type: (16, 16)
    with axes ``data, model`` (256 cards), or (2, 16, 16) with ``pod``
    first. Needs a process group of that many ranks (the dry-run's is a
    fake one)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device: str = "cuda"):
    """A mesh of ``shape`` over the current process group (of that many
    ranks; one for (1, 1)), on ``device``'s type ("cpu" runs over
    ``gloo``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


# The card's constants, for the bounds of chip_smoke.py: NVIDIA H100 SXM
# (nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W"), the data sheet's dense
# peaks at 700 W. "tf32" is the tensor cores' TF32 rate, which the SSD
# kernels use in three passes. A card set below 700 W runs slower under
# load; its measured times are printed beside its power limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12         # HBM3, per card
SMS = 132                         # streaming multiprocessors, per card
NVLINK_BYTES_PER_S = 450e9        # NVLink 4, one direction, per card
CARDS_PER_NODE = 8                # one NVLink domain (HGX H100)
