"""Core layers the ssm family needs: RMSNorm, the tied embedding and head.

A port of part of ``repro.models.layers``. Parameters are nested dicts of
tensors, as in the reference. Attention, RoPE and the MLP wait for the
dense-decoder slice.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import NEG_INF

Params = dict[str, Any]


def _init(gen: torch.Generator, shape, dtype, scale=None, *,
          stack: int | None = None) -> torch.Tensor:
    """A normal draw in float32 times ``scale`` (``1/sqrt(shape[0])`` by
    default), cast to ``dtype``; with ``stack`` the draw is ``stack``
    independent copies along a new leading dim. Drawn on the generator's
    device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (stack, *shape) if stack is not None else tuple(shape)
    return (torch.randn(full, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


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
