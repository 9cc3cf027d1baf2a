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
from repro_torch.models import transformer


def get_model(cfg: ModelConfig) -> types.ModuleType:
    """The module implementing the uniform model API for ``cfg``."""
    if cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"get_model: the {cfg.family} family (models/encdec.py) waits for "
            f"ROADMAP A9")
    return transformer


def make_batch(cfg: ModelConfig, gen: torch.Generator, batch: int, seq: int,
               *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """A random batch drawn from ``gen``, on ``device``: token ids (int32),
    the labels (the tokens), and for the vlm family the stub frontend's
    patch embeddings (batch, frontend_len, d_model), N(0, 1) in the
    model's dtype."""
    if cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"make_batch: the {cfg.family} family's frames wait for "
            f"ROADMAP A9")
    dev = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32, device=gen.device).to(dev)
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        out["patches"] = torch.randn(
            (batch, cfg.frontend_len, cfg.d_model), generator=gen,
            dtype=torch.float32, device=gen.device).to(cfg.dtype).to(dev)
    return out
