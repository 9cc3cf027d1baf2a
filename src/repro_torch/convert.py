"""Carry state from the reference package into the port.

The reference's objects hold numpy arrays; this module reads them by their
attributes (duck typing) and imports nothing of the reference, so importing
the port never loads JAX.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.exec import StreamStage, host_tensor, resolve_device
from repro_torch.core.metadata import Tier


def tensor_from_numpy(a: Any) -> torch.Tensor:
    """A CPU tensor of a numpy array, bf16 (``ml_dtypes``) included."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def stages_from_reference(
    stages: Sequence[Any], x0: Any, *, device: str | torch.device = "cuda",
) -> tuple[list[StreamStage], torch.Tensor]:
    """The port's stages for the reference's ``StreamStage`` list.

    Keeps each stage's name, op, tier and kwargs, and turns its numpy
    payloads (and ``x0``) into host tensors, pinned for a CUDA ``device``.
    """
    pin = resolve_device(device).type == "cuda"
    out = [
        StreamStage(
            name=st.name,
            op=st.op,
            params={k: host_tensor(tensor_from_numpy(a), pin=pin)
                    for k, a in st.params.items()},
            tier=Tier(st.tier.value),
            kwargs=dict(st.kwargs),
        )
        for st in stages
    ]
    return out, host_tensor(tensor_from_numpy(x0), pin=pin)
