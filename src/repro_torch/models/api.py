"""Family dispatch and batch construction (real tensors, and shape-only
stand-ins on the ``meta`` device).

A port of ``repro.models.api``. The reference's ``jax.ShapeDtypeStruct``
and ``jax.eval_shape`` trees become trees of ``meta`` tensors: shapes and
types, no storage.
"""
from __future__ import annotations

import types
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.exec import resolve_device
from repro_torch.models import encdec, transformer


def get_model(cfg: ModelConfig) -> types.ModuleType:
    """The module implementing the uniform model API for ``cfg``."""
    if cfg.family in ("encdec", "audio"):
        return encdec
    return transformer


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict[str, Any]:
    """Meta-tensor stand-ins for one train/prefill batch (no allocation)."""
    B, S = cell.global_batch, cell.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs: dict[str, Any] = {"tokens": meta((B, S), torch.int32),
                             "labels": meta((B, S), torch.int32)}
    if cfg.family in ("encdec", "audio"):
        specs["frames"] = meta((B, cfg.frontend_len, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        specs["patches"] = meta((B, cfg.frontend_len, cfg.d_model), cfg.dtype)
    return specs


def decode_specs(cfg: ModelConfig, cell: ShapeCell) -> tuple[Any, Any]:
    """(cache, tokens) stand-ins for a serve step at context
    ``cell.seq_len``: the model's decode cache built on the ``meta``
    device."""
    B, S = cell.global_batch, cell.seq_len
    cache = get_model(cfg).init_decode_cache(cfg, B, S, device="meta")
    return cache, torch.empty((B, 1), dtype=torch.int32, device="meta")


def make_batch(cfg: ModelConfig, gen: torch.Generator, batch: int, seq: int,
               *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """A random batch drawn from ``gen``, on ``device``: token ids (int32),
    the labels (the tokens), and the stub frontend's embeddings (batch,
    frontend_len, d_model), N(0, 1) in the model's dtype: ``frames`` for
    the enc-dec family, ``patches`` for the vlm family."""
    dev = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32, device=gen.device).to(dev)
    out = {"tokens": tokens, "labels": tokens}
    stub = {"encdec": "frames", "audio": "frames", "vlm": "patches"}
    if cfg.family in stub:
        out[stub[cfg.family]] = torch.randn(
            (batch, cfg.frontend_len, cfg.d_model), generator=gen,
            dtype=torch.float32, device=gen.device).to(cfg.dtype).to(dev)
    return out
