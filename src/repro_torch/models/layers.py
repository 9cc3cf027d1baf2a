"""Core layers: RMSNorm, RoPE, GQA attention (full, sliding window, decode,
cross), the SwiGLU MLP, the tied embedding and head.

A port of ``repro.models.layers`` (``cross_entropy`` waits for the training
slice, ROADMAP A9). Parameters are nested dicts of tensors, as in the
reference. The projections are plain ``x @ w``, as there; full-sequence
attention goes through :func:`repro_torch.models.flash.flash_attention`
(kernel B2 on a card), decode and masked attention through :func:`_sdpa`.
Where the reference computes in bf16, the port rounds at the same points:
einsum outputs in the input type, RoPE's sin and cos cast to x's type.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.flash import flash_attention

Params = dict[str, Any]


def _init(gen: torch.Generator, shape, dtype, scale=None, *,
          stack: int | None = None) -> torch.Tensor:
    """A normal draw in float32 times ``scale`` (``1/sqrt(shape[0])`` by
    default), cast to ``dtype``; with ``stack`` the draw is ``stack``
    independent copies along a new leading dim. Drawn on the generator's
    device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (stack, *shape) if stack is not None else tuple(shape)
    return torch.randn(full, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(scale).to(dtype)


# -- RMSNorm ---------------------------------------------------------------

def rmsnorm_init(d: int, dtype, *, stack: int | None = None,
                 device: torch.device | str) -> Params:
    shape = (stack, d) if stack is not None else (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


# -- rotary ------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S). The angles are float32;
    sin and cos are cast to x's type before they multiply."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.float()[..., None, None] * freqs  # (...,S,1,half)
    sin, cos = torch.sin(angles).to(x.dtype), torch.cos(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# -- GQA attention ----------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ModelConfig, *,
                   stack: int | None = None) -> Params:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _init(gen, (d, H * Dh), cfg.dtype, stack=stack),
        "wk": _init(gen, (d, KV * Dh), cfg.dtype, stack=stack),
        "wv": _init(gen, (d, KV * Dh), cfg.dtype, stack=stack),
        "wo": _init(gen, (H * Dh, d), cfg.dtype, stack=stack),
    }


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def _sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,Dh)  k,v: (B,Sk,KV,Dh)  mask: broadcastable (B,1,Sq,Sk).

    Dense attention as the reference computes it: the raw scores rounded
    to q's type (the einsum's output type) before they are scaled, softmax
    in float32, the probabilities cast to q's type."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = scores.to(q.dtype).float() / math.sqrt(Dh)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return out.to(q.dtype).reshape(B, Sq, H, Dh)


def causal_mask(Sq: int, Sk: int, *, window: int | None = None,
                offset: int = 0, device: torch.device | str = "cpu",
                ) -> torch.Tensor:
    """(1,1,Sq,Sk) causal (optionally banded) mask. ``offset`` = Sk - Sq."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None, None]


def gqa_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    kv: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Self- (kv=None) or cross- (kv = encoder output) attention."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rope(_split_heads(x @ p["wq"], H, Dh), positions, cfg.rope_theta)
    if kv is None:
        k = rope(_split_heads(x @ p["wk"], KV, Dh), positions, cfg.rope_theta)
        v = _split_heads(x @ p["wv"], KV, Dh)
    else:
        k = _split_heads(kv @ p["wk"], KV, Dh)
        v = _split_heads(kv @ p["wv"], KV, Dh)
        if kv_positions is not None:
            k = rope(k, kv_positions, cfg.rope_theta)
        causal = False
    if mask is None:
        out = flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window if kv is None else None)
    else:
        out = _sdpa(q, k, v, mask, cfg)
    return out.reshape(B, S, H * Dh) @ p["wo"]


def write_slot(cache: torch.Tensor, new: torch.Tensor,
               slot: torch.Tensor) -> None:
    """``new`` (B,1,...) into ``cache`` (B,S,...) at ``slot`` in place, as
    the reference writes a decode step's K/V or latent: at a 0-d ``slot``
    for every lane, clamped to the last slot (``dynamic_update_slice``
    clamps a write past the end); at a per-lane ``(B,)`` slot, a lane past
    the cache keeps what it has, as the reference's scatter drops an
    out-of-range write (it rewrites the value already in its clamped slot:
    a mask, not boolean indexing, so the host never waits)."""
    S = cache.shape[1]
    row = slot.clamp(max=S - 1)
    if slot.ndim == 0:
        cache.index_copy_(1, row.reshape(1), new)
        return
    lanes = torch.arange(cache.shape[0], device=cache.device)
    keep = (slot >= S).reshape(-1, *([1] * (new.ndim - 2)))
    cache[lanes, row] = torch.where(keep, cache[lanes, row], new[:, 0])


def gqa_decode_step(
    p: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,d); cache: (B,S_cache,KV,Dh); pos: a 0-d
    tensor or a per-lane ``(B,)`` vector, on x's device.

    For SWA the cache is a ring buffer of width ``sliding_window`` indexed
    by ``pos % window``; otherwise it holds the full context and the new
    K/V land at ``pos``. A per-lane ``pos`` decodes every lane at its own
    position: lane b's K/V land at ``pos[b]`` and its mask covers only its
    own slots, so each lane's arithmetic is independent of the others and
    bit-identical to running that lane alone at the same batch shape.

    At a position at or past a full cache's length the write follows the
    reference: a scalar position writes the last slot, and a lane past the
    cache writes nothing. The mask is the reference's either way.

    Unlike the reference, the new K/V are written into ``cache_k`` and
    ``cache_v`` in place (no copy of the cache per step); the returned
    caches are those same tensors.
    """
    B = x.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_cache = cache_k.shape[1]
    per_lane = pos.ndim > 0
    positions = pos.reshape(B, 1) if per_lane else pos.reshape(1, 1).expand(
        B, 1)
    q = rope(_split_heads(x @ p["wq"], H, Dh), positions, cfg.rope_theta)
    k_new = rope(_split_heads(x @ p["wk"], KV, Dh), positions, cfg.rope_theta)
    v_new = _split_heads(x @ p["wv"], KV, Dh)

    idx = torch.arange(S_cache, device=x.device)
    lane_pos = positions[:, 0].long() if per_lane else pos.long()
    slot = lane_pos % S_cache if cfg.sliding_window else lane_pos
    write_slot(cache_k, k_new, slot)
    write_slot(cache_v, v_new, slot)
    if per_lane:
        if cfg.sliding_window:
            valid = (idx[None, :] <= slot[:, None]) | (
                lane_pos[:, None] >= S_cache)
        else:
            valid = idx[None, :] <= lane_pos[:, None]
        mask = valid[:, None, None, :]
    else:
        if cfg.sliding_window:  # ring: all valid once wrapped
            valid = (idx <= slot) | (lane_pos >= S_cache)
        else:
            valid = idx <= lane_pos
        mask = valid[None, None, None, :]
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    return out.reshape(B, 1, H * Dh) @ p["wo"], cache_k, cache_v


# -- SwiGLU MLP -----------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             *, stack: int | None = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": _init(gen, (d, ff), cfg.dtype, stack=stack),
        "w_up": _init(gen, (d, ff), cfg.dtype, stack=stack),
        "w_down": _init(gen, (ff, d), cfg.dtype, stack=stack),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# -- embedding / head ------------------------------------------------------

def padded_vocab(cfg: ModelConfig, multiple: int = 2048) -> int:
    return -(-cfg.vocab_size // multiple) * multiple


def embed_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    V = padded_vocab(cfg)
    return {"embedding": _init(gen, (V, cfg.d_model), cfg.dtype, scale=1.0)}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["embedding"][tokens.long()]


def logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,V_padded) float32, the tied embedding as the head;
    the padded vocabulary columns hold the finite ``NEG_INF``."""
    e = p["embedding"]
    out = (x @ e.t().to(x.dtype)).float()
    V = padded_vocab(cfg)
    if V != cfg.vocab_size:
        out[..., cfg.vocab_size:] = NEG_INF
    return out
