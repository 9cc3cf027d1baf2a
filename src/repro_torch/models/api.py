"""Family dispatch and batch construction.

A port of part of ``repro.models.api``; ``batch_specs`` and
``decode_specs`` wait for the sharding slice (ROADMAP A11).
"""
from __future__ import annotations

import types
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import resolve_device
from repro_torch.models import encdec, transformer


def get_model(cfg: ModelConfig) -> types.ModuleType:
    """The module implementing the uniform model API for ``cfg``."""
    if cfg.family in ("encdec", "audio"):
        return encdec
    return transformer


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
