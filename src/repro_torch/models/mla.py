"""Multi-head Latent Attention (DeepSeek-V2/V3).

A port of ``repro.models.mla``. Prefill uses the decompressed formulation
through :func:`repro_torch.models.flash.flash_attention` (kernel B2 on a
card, at deepseek-v3's head dims D = 128 + 64 and Dv = 128); decode uses
the absorbed formulation whose cache is the compressed latent
(``kv_lora_rank`` + ``qk_rope_head_dim`` per token), written in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    _init,
    rmsnorm,
    rmsnorm_init,
    rope,
    write_slot,
)
from repro_torch.models.sharding import constrain, replicate_like

Params = dict[str, Any]


def mla_init(gen: torch.Generator, cfg: ModelConfig, *,
             stack: int | None = None) -> Params:
    """MLA's projections and latent norms, or ``stack`` of them stacked."""
    d, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rdim, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt, dev = cfg.dtype, gen.device
    return {
        "wq_a": _init(gen, (d, qr), dt, stack=stack),
        "q_ln": rmsnorm_init(qr, dt, stack=stack, device=dev),
        "wq_b": _init(gen, (qr, H * (nope + rdim)), dt, stack=stack),
        "wkv_a": _init(gen, (d, kr + rdim), dt, stack=stack),
        "kv_ln": rmsnorm_init(kr, dt, stack=stack, device=dev),
        "wkv_b": _init(gen, (kr, H * (nope + vh)), dt, stack=stack),
        "wo": _init(gen, (H * vh, d), dt, scale=1.0 / math.sqrt(H * vh),
                    stack=stack),
    }


def _project_q(p, x, cfg, positions):
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(p["q_ln"], x @ p["wq_a"])
    q = (cq @ p["wq_b"]).reshape(B, S, H, nope + rdim)
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def _project_kv_latent(p, x, cfg, positions):
    kr = cfg.kv_lora_rank
    ckv = x @ p["wkv_a"]  # (B,S,kr+rdim)
    c_kv = rmsnorm(p["kv_ln"], ckv[..., :kr])
    # RoPE through a dummy head axis, as the reference applies it
    k_rope = rope(ckv[..., None, kr:], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor) -> torch.Tensor:
    """Decompressed MLA for prefill (full causal attention)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rdim, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(p, x, cfg, positions)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, nope + vh)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q = torch.cat([q_nope, q_rope], dim=-1)  # (B,S,H,nope+rdim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rdim)],
                  dim=-1)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    v = constrain(v, "batch", None, "heads", None)
    out = flash_attention(q, k, v, causal=True,
                          scale=1.0 / math.sqrt(nope + rdim))
    out = constrain(out, "batch", None, "heads", None)
    return out.reshape(B, S, H * vh) @ p["wo"]


def mla_decode_step(
    p: Params,
    x: torch.Tensor,
    cache_c: torch.Tensor,   # (B, S_max, kv_lora_rank)
    cache_kr: torch.Tensor,  # (B, S_max, qk_rope_head_dim)
    pos: torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed one-token decode against the compressed-latent cache.

    ``pos`` is a 0-d tensor (the whole batch at one position) or a per-lane
    ``(B,)`` vector (each lane's latent lands at its own slot and is masked
    to its own prefix). The new latent is written into ``cache_c`` and
    ``cache_kr`` in place by :func:`~repro_torch.models.layers.write_slot`
    (ROADMAP C6's rule past the cache's length), so a re-run of the step on
    the same cache rewrites the same slots; the returned caches are those
    same tensors.
    """
    B = x.shape[0]
    H = cfg.n_heads
    nope, rdim, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    S_max = cache_c.shape[1]
    per_lane = pos.ndim > 0
    positions = (pos.reshape(B, 1) if per_lane
                 else pos.reshape(1, 1).expand(B, 1))
    q_nope, q_rope = _project_q(p, x, cfg, positions)  # (B,1,H,*)
    c_new, kr_new = _project_kv_latent(p, x, cfg, positions)
    lane_pos = positions[:, 0].long() if per_lane else pos.long()
    write_slot(cache_c, c_new, lane_pos)
    write_slot(cache_kr, kr_new, lane_pos)
    cache_c = constrain(cache_c, "batch", "kv_len", None)
    cache_kr = constrain(cache_kr, "batch", "kv_len", None)

    wkv_b = p["wkv_b"].reshape(kr, H, nope + vh)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    # absorb W_uk into q: score directly against the latent cache
    q_c = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)  # (B,1,H,kr)
    scale = 1.0 / math.sqrt(nope + rdim)
    scores = (torch.einsum("bqhl,bsl->bhqs", q_c, cache_c)
              + torch.einsum("bqhr,bsr->bhqs", q_rope, cache_kr)
              ).float() * scale
    idx = replicate_like(torch.arange(S_max, device=x.device), x)
    valid = (idx <= lane_pos[..., None]).reshape(-1, 1, 1, S_max)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, cache_c)  # (B,1,H,kr)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, w_uv)       # (B,1,H,vh)
    return out.reshape(B, 1, H * vh) @ p["wo"], cache_c, cache_kr
