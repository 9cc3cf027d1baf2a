"""The public kernel API of the port, layout-matched to ``repro.kernels.ops``.

Each function dispatches on its tensors' device: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the kernel's plain version.
``ssd`` waits for the port of the SSD scan kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_gpu
from repro_torch.kernels.streaming_matmul import streaming_matmul


def matmul(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    return streaming_matmul(x, w, **kw)


def attention(q, k, v, *, causal=True, window=None, scale=None,
              block_q=512, block_k=512):
    """q: (B,Sq,H,D), k/v: (B,Sk,KV,*) -> (B,Sq,H,Dv) (the layout of
    ``repro.models.flash.flash_attention``). The block arguments only
    validate the shapes (see :func:`flash_attention_gpu`)."""
    o = flash_attention_gpu(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale,
        block_q=block_q, block_k=block_k,
    )
    return o.transpose(1, 2)
