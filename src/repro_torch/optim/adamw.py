"""AdamW with DOLMA-tiered moment storage.

A port of ``repro.optim.adamw``. Optimizer moments are the textbook DOLMA
remote object: as large as the parameters, touched once a step (read and
written), never read by the forward pass. They are stored per
``moment_style``: float32, bf16, or int8 block-quantized
(:mod:`repro_torch.optim.quantized`); a host-offload placement moves
float32 moments to pinned host memory instead
(:func:`repro_torch.core.tiering.place_state`, and the train step's
streamed update, :func:`repro_torch.train.step.make_train_step`).

The math is float32 whatever the parameters' type. :func:`update` applies
:func:`leaf_update` to every leaf with the scalars of
:func:`step_scalars`; the train step's streamed update calls the same two
functions on leaves fetched from the remote tier, so every placement gives
the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
from torch.distributed.tensor import DTensor

from repro_torch.optim.quantized import (
    BLOCK,
    QTensor,
    dequantize,
    quantizable,
    quantize,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_style: str = "f32"     # f32 | bf16 | int8
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    mult = torch.where(step < cfg.warmup_steps, warm,
                       cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
    return cfg.lr * mult


def encode(cfg: AdamWConfig, x32: torch.Tensor):
    """A float32 moment in its ``moment_style``."""
    if cfg.moment_style == "bf16":
        return x32.to(torch.bfloat16)
    if cfg.moment_style == "int8":
        return quantize(x32)
    return x32


def leaves(tree: Any, key: str = "") -> Iterator[tuple[str, Any]]:
    """``(keystr, leaf)`` of nested dicts in sorted key order, a
    :class:`QTensor` counted as one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{key}[{k!r}]")
    else:
        yield key, tree


def unflatten(template: Any, values: dict[str, Any], key: str = "") -> Any:
    """``template``'s nested dicts with each leaf taken from ``values`` by
    its keystr."""
    if isinstance(template, dict):
        return {k: unflatten(v, values, f"{key}[{k!r}]")
                for k, v in template.items()}
    return values[key]


def init(cfg: AdamWConfig, params: Any) -> dict:
    def zeros(p):
        """``encode`` of a float32 zero moment, made in its stored type
        (no float32 leaf of the parameter's size: a full-width expert
        weight's would take 15 GB)."""
        if cfg.moment_style == "int8" and quantizable(tuple(p.shape)):
            return QTensor(
                torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                torch.zeros((*p.shape[:-1], p.shape[-1] // BLOCK),
                            dtype=torch.float32, device=p.device))
        dtype = torch.bfloat16 if cfg.moment_style == "bf16" else torch.float32
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    vals = dict(leaves(params))
    return {
        "m": unflatten(params, {k: zeros(p) for k, p in vals.items()}),
        "v": unflatten(params, {k: zeros(p) for k, p in vals.items()}),
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(iter(vals.values())).device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """The leaves' joint L2 norm. A DTensor leaf's sum of squares is its
    shards' sum, reduced over the mesh dims that split it only (a replica
    is counted once); the leaves are added in order either way."""
    return torch.sqrt(sum(_whole(torch.sum(torch.square(x.float())))
                          for _, x in leaves(tree)))


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """The step's shared factors: the clip ``scale``, ``lr`` and the bias
    corrections ``bc1`` and ``bc2`` (``step`` is the new step count)."""
    sf = step.float()
    return {
        "scale": torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0),
        "lr": schedule(cfg, step),
        "bc1": 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf),
        "bc2": 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf),
    }


def leaf_update(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor, m, v,
                s: dict[str, torch.Tensor]):
    """One leaf's AdamW step in float32 -> (p, m, v), p in its own type and
    the moments re-encoded."""
    g = g.float() * s["scale"]
    m32 = cfg.b1 * dequantize(m) + (1 - cfg.b1) * g
    v32 = cfg.b2 * dequantize(v) + (1 - cfg.b2) * g * g
    upd = (m32 / s["bc1"]) / (torch.sqrt(v32 / s["bc2"]) + cfg.eps)
    p32 = p.float()
    p_new = p32 - s["lr"] * (upd + cfg.weight_decay * p32)
    return p_new.to(p.dtype), encode(cfg, m32), encode(cfg, v32)


def update(cfg: AdamWConfig, grads: Any, state: dict, params: Any
           ) -> tuple[Any, dict, dict]:
    """One AdamW step (float32 math; moments re-encoded per
    ``moment_style``) -> (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    s = step_scalars(cfg, step, gnorm)
    g_of, m_of, v_of = (dict(leaves(t)) for t in (grads, state["m"],
                                                   state["v"]))
    new_p, new_m, new_v = {}, {}, {}
    for k, p in leaves(params):
        new_p[k], new_m[k], new_v[k] = leaf_update(cfg, p, g_of[k], m_of[k],
                                                   v_of[k], s)
    return (unflatten(params, new_p),
            {"m": unflatten(params, new_m), "v": unflatten(params, new_v),
             "step": step},
            {"grad_norm": gnorm, "lr": s["lr"]})


__all__ = ["AdamWConfig", "global_norm", "init", "schedule", "update"]
