"""Plain PyTorch versions of the hand-written kernels.

They are the kernels' ground truth: the wrappers take them for tensors on
the CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. Counterpart of ``repro.kernels.ref`` (matmul and flash; the SSD scan
waits for its kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: The reference's finite mask value (``repro.models.flash.NEG_INF``): finite
#: so that a fully masked row never forms ``exp(-inf - -inf) = nan``.
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in float32, then cast to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                        scale=None):
    """Dense attention oracle, (B,Sq,H,D) layout -> (B,Sq,H,Dv).

    A port of ``repro.models.flash.reference_attention``: scores in the
    input type (computed in float32 and rounded, as XLA does), softmax in
    float32, ``p`` cast to ``v``'s type for the value product. K/V head
    ``h // (H // KV)`` serves query head ``h``.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    if H != KV:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s.to(q.dtype).float() * scale
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    m = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    s = torch.where(m[None, None], s, torch.tensor(NEG_INF, dtype=s.dtype,
                                                    device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhv->bqhv", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def flash_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B,H,Sq,D), k/v: (B,KV,Sk,*) -> (B,H,Sq,Dv)."""
    o = reference_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale,
    )
    return o.transpose(1, 2)


#: The bf16 bound's relative and row-scaled terms (see tolerance_ratio).
BF16_REL = 2.0 ** -6
BF16_ROW = 2.0 ** -4


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor,
                    tol: float) -> torch.Tensor:
    """``|got - want|`` over the bound a kernel's ``got`` is held to against
    its plain version's ``want``, per element: above 1 (or NaN) misses.

    Every dtype is held to the reference's own test tolerance,
    ``tol + tol * |want|``. For bf16 that tolerance (0.5 for the matmul,
    3e-2 for flash) is as large as a typical output at full width, where it
    would pass a kernel that skips a tile. So bf16 is also held to
    ``BF16_REL * |want| + BF16_ROW * rms``, with ``rms`` the root mean
    square of ``want`` over its last dim (one output row). Reason: bf16
    keeps 8 significant bits. The two sides round different intermediates:
    the output (one unit of 2^-8 of the value), and for flash p and the
    scores, which the plain version rounds to bf16 as the reference does
    while the kernel keeps them in float32 (a few hundredths of the row's
    scale in the tails). A skipped 128-key or 128-deep tile moves elements
    by a tenth of the row's scale or more.
    """
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bound = tol + tol * w.abs()
    if want.dtype == torch.bfloat16:
        rms = w.square().mean(dim=-1, keepdim=True).sqrt()
        bound = torch.minimum(bound, BF16_REL * w.abs() + BF16_ROW * rms)
    # a row of exact zeros (one that meets no live tile) has a zero bound
    return torch.where(diff == 0, torch.zeros_like(diff), diff / bound)


def outside_tolerance(got: torch.Tensor, want: torch.Tensor,
                      tol: float) -> torch.Tensor:
    """Mask of the elements where ``got`` misses :func:`tolerance_ratio`'s
    bound; NaN always misses."""
    return ~(tolerance_ratio(got, want, tol) <= 1.0)
