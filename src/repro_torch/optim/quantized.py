"""Block-quantized (int8) optimizer-state storage, 8-bit Adam style.

A port of ``repro.optim.quantized``. Where the moments cannot live on the
remote tier, they are stored as int8 codes with a float32 scale per block
of 256: 2.25 bytes per moment pair per parameter instead of 8. Codes keep
the parameter's shape; the scales drop the last dim to ``last // BLOCK``.

Small leaves (under 1 MiB) and leaves whose last dim is not a multiple of
the block stay float32: DOLMA's small objects, kept local. ``torch.round``
rounds half to even, as ``jnp.round`` does, so the codes equal the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 256
MIN_QUANT_BYTES = 1 << 20


@dataclasses.dataclass
class QTensor:
    """int8 ``codes`` (the logical tensor's shape) and float32 ``scale``
    (``shape[:-1] + (last // BLOCK,)``). Its leaves are keyed ``.codes``
    and ``.scale``, as ``jax.tree_util.keystr`` keys the reference's."""

    codes: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.codes.shape

    @property
    def dtype(self):
        return torch.float32


def quantizable(shape, dtype=None) -> bool:
    """Whether a float32 leaf of ``shape`` is stored as int8 codes."""
    if not shape or shape[-1] % BLOCK:
        return False
    return int(np.prod(shape, dtype=np.int64)) * 4 >= MIN_QUANT_BYTES


def quantize(x: torch.Tensor) -> QTensor | torch.Tensor:
    if not quantizable(tuple(x.shape)):
        return x.float()
    return quantize_blocks(x)


def per_127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as a true division, the reference's: the divisor a
    tensor on ``amax``'s device. On a card PyTorch multiplies by the
    rounded reciprocal of a Python-number divisor instead, which puts 5 %
    of the scales one unit in the last place off the CPU's (ROADMAP C11)."""
    return amax / amax.new_full((), 127.0)


def quantize_blocks(x: torch.Tensor) -> QTensor:
    """``x`` as int8 codes and a scale per block of its last dim, whatever
    its size (a rank's shard of a leaf :func:`quantizable` as a whole)."""
    lead = x.shape[:-1]
    xb = x.float().reshape(*lead, x.shape[-1] // BLOCK, BLOCK)
    scale = per_127(xb.abs().amax(dim=-1))
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(xb / safe[..., None]), -127, 127)
    return QTensor(codes=codes.to(torch.int8).reshape(x.shape), scale=scale)


def dequantize(q: QTensor | torch.Tensor) -> torch.Tensor:
    if not isinstance(q, QTensor):
        return q.float()
    lead = q.codes.shape[:-1]
    xb = q.codes.float().reshape(*lead, q.scale.shape[-1], -1)
    return (xb * q.scale[..., None]).reshape(q.codes.shape)


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)
