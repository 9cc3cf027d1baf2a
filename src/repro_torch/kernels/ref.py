"""Plain PyTorch versions of the hand-written kernels.

They are the kernels' ground truth: the wrappers take them for tensors on
the CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. Counterpart of ``repro.kernels.ref``.
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


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, tol: float,
                    extra: torch.Tensor | None = None) -> torch.Tensor:
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

    ``extra`` (broadcast against ``want``) is added to the bound where an
    error term of the computation is known per element (see
    :func:`flash_dq_rounding_bound`).
    """
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bound = tol + tol * w.abs()
    if want.dtype == torch.bfloat16:
        rms = w.square().mean(dim=-1, keepdim=True).sqrt()
        bound = torch.minimum(bound, BF16_REL * w.abs() + BF16_ROW * rms)
    if extra is not None:
        bound = bound + extra
    # a row of exact zeros (one that meets no live tile) has a zero bound
    return torch.where(diff == 0, torch.zeros_like(diff), diff / bound)


def outside_tolerance(got: torch.Tensor, want: torch.Tensor, tol: float,
                      extra: torch.Tensor | None = None) -> torch.Tensor:
    """Mask of the elements where ``got`` misses :func:`tolerance_ratio`'s
    bound; NaN always misses."""
    return ~(tolerance_ratio(got, want, tol, extra) <= 1.0)


def flash_dq_rounding_bound(q, k, o, do, *, causal=True, window=None,
                            scale=None) -> torch.Tensor:
    """Per element of dq (B,Sq,H,D), the error that o's rounding to its
    type carries into a flash backward: each row's ``delta = sum(do * o)``
    is off by up to ``2^-8 sum|do * o|`` (o rounded on either side of a
    comparison), and dq's row takes ``scale * delta`` times the row's
    attention-weighted mean key ``kbar = softmax(q k^T) k``. Where a row's
    dq nearly cancels, that term is far above ``BF16_ROW * rms``.
    ``kbar`` is computed in float32 with :func:`reference_attention`; the
    layout is the models' (B,S,H,D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    kbar = reference_attention(q.float(), k.float(), k.float(),
                               causal=causal, window=window, scale=scale)
    delta_err = 2.0 ** -8 * (do.float() * o.float()).abs().sum(
        -1, keepdim=True)
    return scale * delta_err * kbar.abs()


def flash_dk_rounding_bound(q, k, o, do, *, causal=True, window=None,
                            scale=None) -> torch.Tensor:
    """Per element of dk (B,Sk,KV,D), the same error of each row's
    ``delta`` (:func:`flash_dq_rounding_bound`: o rounded to its type on
    either side of a comparison) as dk receives it: ``dk_j`` sums ``scale
    p_ij delta_i q_i`` over the query rows of every head of its group, so
    the bound is ``scale sum_i p_ij delta_err_i |q_i|``. It grows with the
    group: at granite-34b's 48 heads over one KV head a key's sum runs over
    98304 rows. p is the float32 softmax of the scaled scores under the
    masks; the layout is the models' (B,S,H,D), one head at a time."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    delta_err = 2.0 ** -8 * (do.float() * o.float()).abs().sum(-1)  # (B,Sq,H)
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        live &= j <= i
    if window is not None:
        live &= j > i - window
    out = torch.zeros((B, Sk, KV, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            qh = q[b, :, h].float()
            s = (qh @ k[b, :, h // G].float().T) * scale
            p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
            p = torch.nan_to_num(p)  # a row with no live key
            out[b, :, h // G] += p.T @ (delta_err[b, :, h, None] * qh.abs())
    return scale * out


def ssd_grad_ratio(got: torch.Tensor, want: torch.Tensor,
                   tol: float) -> torch.Tensor:
    """``|got - want|`` over B3's backward bound, per element (above 1, or
    NaN, misses): the forward's ``tol + tol * |want|`` with its absolute
    term scaled to the gradient (times its root mean square), since the
    five gradients run from 1e-2 to 1e3 in magnitude."""
    rms = want.float().pow(2).mean().sqrt()
    return (got - want).abs() / (tol * rms + tol * want.abs())


def ssd_ref(xc, bc, cc, dtc, cum):
    """Recurrent oracle on the SSD kernel's chunk tensors, in float32.

    xc: (B,H,nc,Q,P), bc/cc: (B,H,nc,Q,N), dtc/cum: (B,H,nc,Q) ->
    (B,H,nc,Q,P). A port of ``repro.kernels.ref.ssd_ref``: recovers
    ``dt*A`` from the chunkwise inclusive cumsum and runs the O(L)
    recurrence ``S_t = exp(dA_t) S_{t-1} + dt_t x_t B_t^T``,
    ``y_t = S_t C_t`` over the flattened sequence.
    """
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    dA = torch.cat([cum[..., :1], cum[..., 1:] - cum[..., :-1]], dim=-1)

    def flat(t):  # (B,H,nc,Q,...) -> (B,H,L,...)
        return t.float().reshape(B, H, nc * Q, *t.shape[4:])

    xf, bf, cf, dtf, dAf = flat(xc), flat(bc), flat(cc), flat(dtc), flat(dA)
    S = torch.zeros((B, H, P, N), dtype=torch.float32, device=xc.device)
    ys = []
    for t in range(nc * Q):
        S = S * torch.exp(dAf[:, :, t])[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, :, t], bf[:, :, t], xf[:, :, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", cf[:, :, t], S))
    return torch.stack(ys, dim=2).reshape(B, H, nc, Q, P)
