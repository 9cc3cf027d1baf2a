"""The public kernel API of the port, layout-matched to ``repro.kernels.ops``.

Each function dispatches on its tensors' device: a CUDA tensor launches the
hand-written kernel, a CPU tensor takes the kernel's plain version. ``ssd``
also does the cheap chunking and cumsum prep that feeds the SSD kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_gpu
from repro_torch.kernels.ssd_scan import ssd_chunk_scan_gpu
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


def ssd_prep(xh, Bm, Cm, dt, A, *, chunk: int = 128):
    """The SSD kernel's five inputs, as the reference's ``ops.ssd`` makes
    them: x, B and C per head and dt chunked to (B,H,nc,Q,...), and the
    inclusive cumsum of dt*A inside each chunk, all float32 and contiguous.

    xh: (B,L,H,P); Bm/Cm: (B,L,G,N); dt: (B,L,H) float32 post-softplus;
    A: (H,) negative. Head h reads group ``h // (H // G)``. The chunk is
    ``min(chunk, L)`` and must divide L.
    """
    B, L, H, P = xh.shape
    G = Bm.shape[2]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"ssd: sequence length {L} is not divisible by the "
                         f"chunk {Q}")
    nc = L // Q
    rep = H // G

    def chunked(t):  # (B,L,H,...) -> (B,H,nc,Q,...), float32, contiguous
        t = t.reshape(B, nc, Q, *t.shape[2:]).movedim(3, 1)
        return t.to(torch.float32).contiguous()

    return (chunked(xh), chunked(Bm.repeat_interleave(rep, dim=2)),
            chunked(Cm.repeat_interleave(rep, dim=2)), chunked(dt),
            torch.cumsum(chunked(dt * A), dim=-1))


def ssd(xh, Bm, Cm, dt, A, *, chunk: int = 128) -> torch.Tensor:
    """Mamba2 SSD through the chunk kernels: :func:`ssd_prep`'s inputs
    (see there for the shapes) to y (B,L,H,P) float32."""
    B, L, H, P = xh.shape
    y = ssd_chunk_scan_gpu(*ssd_prep(xh, Bm, Cm, dt, A, chunk=chunk))
    return y.movedim(1, 3).reshape(B, L, H, P)
