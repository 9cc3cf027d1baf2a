"""Blocked (flash) attention for the models, forward only.

A port of the forward part of ``repro.models.flash``. The layout is the
models' (B, S, H, D). Which computation runs is decided by the tensors'
device alone:

* On a CUDA tensor :func:`flash_attention` launches kernel B2
  (``csrc/flash_attention.cu``) through :func:`repro_torch.kernels.ops.
  attention`, or raises where :func:`b2_route` says B2 does not cover the
  call. It never runs the plain version on the card.
* On a CPU tensor it computes :func:`blocked_flash`, the reference's jnp
  flash in plain torch: queries in up to ``n_strips`` strips, each scanning
  only the KV blocks between its sliding-window edge and its diagonal, with
  an online softmax in float32 over ``block_k``-key blocks. K and V are
  padded to a whole block with the padding masked by ``kv_len``. The scores
  are rounded to the input type before they are scaled, and each block's
  ``p @ v`` to v's type, where the reference's einsums round them.

:func:`reference_attention` is the dense oracle (the reference's, ported in
:mod:`repro_torch.kernels.ref`). The backward (``_flash_bwd``) waits for the
training slice (ROADMAP A9).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, reference_attention

DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
DEFAULT_STRIPS = 8

__all__ = ["MaskSpec", "b2_route", "blocked_flash", "flash_attention",
           "reference_attention"]


class MaskSpec(NamedTuple):
    causal: bool = True
    window: int | None = None   # sliding-window width
    q_offset: int = 0           # absolute position of query row 0 minus key 0
    kv_len: int | None = None   # valid KV length (rest is padding)


def _block_mask(qpos: torch.Tensor, ki: torch.Tensor,
                spec: MaskSpec) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], ki.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if spec.causal:
        m &= ki[None, :] <= (qpos[:, None] + spec.q_offset)
    if spec.window is not None:
        m &= ki[None, :] > (qpos[:, None] + spec.q_offset - spec.window)
    if spec.kv_len is not None:
        m &= (ki < spec.kv_len)[None, :]
    return m


def _tile_scores(q, ks, spec: MaskSpec, scale, qpos, ki) -> torch.Tensor:
    """q: (B,KV,G,bq,D)  ks: (B,KV,bk,D) -> masked float32 (B,KV,G,bq,bk)."""
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float(), ks.float())
    s = s.to(q.dtype).float() * scale
    return torch.where(_block_mask(qpos, ki, spec)[None, None, None], s,
                       NEG_INF)


def _strip_fwd(q, k, v, spec: MaskSpec, scale, block_k: int, kb0: int,
               nkb: int, qpos: torch.Tensor):
    """One query strip. q: (B,KV,G,R,D); scans nkb KV blocks. -> (o, lse)."""
    B, KV, G, R, _ = q.shape
    Dv = v.shape[3]
    acc = torch.zeros((B, KV, G, R, Dv), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, KV, G, R), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, KV, G, R), dtype=torch.float32, device=q.device)
    for kb in range(kb0, kb0 + nkb):
        ks = k[:, :, kb * block_k:(kb + 1) * block_k]
        vs = v[:, :, kb * block_k:(kb + 1) * block_k]
        ki = kb * block_k + torch.arange(block_k, device=q.device)
        s = _tile_scores(q, ks, spec, scale, qpos, ki)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bksv->bkgqv", p.to(v.dtype).float(),
                          vs.float())
        acc = acc * alpha[..., None] + pv.to(v.dtype).float()
        m_run = m_new
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    o = (acc / l_safe[..., None]).to(q.dtype)
    return o, m_run + torch.log(l_safe)


def _strip_plan(Sq: int, Sk: int, spec: MaskSpec, block_k: int,
                n_strips: int) -> list[tuple[int, int, int, int]]:
    """[(row_start, rows, kb0, nkb)]: causal strips scan only the KV blocks
    between their sliding-window low edge and their diagonal."""
    n = min(n_strips, Sq) if spec.causal else 1
    while Sq % n:
        n -= 1
    rows = Sq // n
    plan = []
    for s in range(n):
        if spec.causal:
            hi = max(min((s + 1) * rows + spec.q_offset, Sk), 1)
        else:
            hi = Sk
        lo = 0
        if spec.causal and spec.window is not None:
            lo = max(s * rows + spec.q_offset - spec.window + 1, 0)
        kb0 = lo // block_k
        nkb = max(-(-hi // block_k) - kb0, 1)
        plan.append((s * rows, rows, kb0, nkb))
    return plan


def _fwd_all(q, k, v, spec: MaskSpec, scale, block_k: int, n_strips: int):
    Sq, Sk = q.shape[3], k.shape[2]
    os, lses = [], []
    for start, rows, kb0, nkb in _strip_plan(Sq, Sk, spec, block_k, n_strips):
        qpos = start + torch.arange(rows, device=q.device)
        o_s, lse_s = _strip_fwd(q[:, :, :, start:start + rows], k, v, spec,
                                scale, block_k, kb0, nkb, qpos)
        os.append(o_s)
        lses.append(lse_s)
    return torch.cat(os, dim=3), torch.cat(lses, dim=3)


def blocked_flash(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, scale: float | None = None,
                  block_k: int = DEFAULT_BLOCK_K,
                  n_strips: int = DEFAULT_STRIPS) -> torch.Tensor:
    """The plain version: the reference's ``flash_attention`` in torch, on
    any device. q: (B,Sq,H,D), k: (B,Sk,KV,D), v: (B,Sk,KV,Dv) ->
    (B,Sq,H,Dv)."""
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qT = q.transpose(1, 2).reshape(B, KV, G, Sq, D)
    kT = k.transpose(1, 2)
    vT = v.transpose(1, 2)
    block_k = min(block_k, Sk)
    kv_len = None
    if Sk % block_k:
        pad = block_k - Sk % block_k
        kT = torch.nn.functional.pad(kT, (0, 0, 0, pad))
        vT = torch.nn.functional.pad(vT, (0, 0, 0, pad))
        kv_len = Sk
    spec = MaskSpec(causal=causal, window=window, q_offset=q_offset,
                    kv_len=kv_len)
    o, _ = _fwd_all(qT, kT, vT, spec, scale, block_k, n_strips)
    return o.reshape(B, H, Sq, Dv).transpose(1, 2)


def b2_route(dtype: torch.dtype, D: int, Dv: int, q_offset: int) -> str:
    """The rule for a call on the card: the B2 kernel variant that computes
    it (:func:`repro_torch.kernels.flash_attention._variant`), or a
    ValueError where B2 does not cover it.

    B2 has no query offset: its causal tile skip assumes query row i lines
    up with key i, so ``q_offset != 0`` raises (ROADMAP B2's ``q_offset``
    gap, and C3: only with an offset can a row meet no live key). Its
    tiles hold a q/k head dim D up to 192 (MLA's 128 + 64) in multiples of
    4, and a v head dim Dv up to 128. B2 masks keys at or
    beyond Sk itself, so the plain version's ``kv_len`` padding has no
    counterpart on the card.
    """
    if q_offset != 0:
        raise ValueError(
            f"flash_attention: q_offset={q_offset} on a card; kernel B2 has "
            f"no query offset (ROADMAP B2, the q_offset gap; C3)")
    if D % 4 or D > fa.MAX_D or Dv > fa.MAX_DV:
        raise ValueError(
            f"flash_attention: head dims D={D}, Dv={Dv} on a card; kernel B2 "
            f"takes D % 4 == 0, D <= {fa.MAX_D} and Dv <= {fa.MAX_DV} "
            f"(ROADMAP B2)")
    return fa._variant(dtype, D, Dv)


def _b2(q, k, v, *, causal: bool, window: int | None, q_offset: int,
        scale: float) -> torch.Tensor:
    """The call on the card: B2 at blocks the shape satisfies (the kernel
    tiles at its own sizes; the blocks only validate)."""
    b2_route(q.dtype, q.shape[3], v.shape[3], q_offset)
    return ops.attention(q, k, v, causal=causal, window=window, scale=scale,
                         block_q=q.shape[1], block_k=k.shape[1])


def flash_attention(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Sk, KV, D)
    v: torch.Tensor,           # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    scale: float | None = None,
    block_k: int = DEFAULT_BLOCK_K,
    n_strips: int = DEFAULT_STRIPS,
) -> torch.Tensor:
    """GQA flash attention; returns (B, Sq, H, Dv). B2 on a card (or a
    ValueError, see :func:`b2_route`), :func:`blocked_flash` on the CPU;
    ``block_k`` and ``n_strips`` shape only the latter."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cuda":
        return _b2(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return blocked_flash(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale, block_k=block_k,
                         n_strips=n_strips)
