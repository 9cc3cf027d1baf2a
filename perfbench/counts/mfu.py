"""The model FLOPs of one train step, counted from the configuration's
shapes: the forward's products once and the backward's twice (three times
the forward), recomputation not counted. Each family's forward count lives
in ``counts/flops_<family>.py`` (``forward_flops(model, batch, seq)``),
found by the family's name."""
from __future__ import annotations

import importlib


def step_flops(model: dict, batch: int, seq: int) -> float | None:
    """Model FLOPs of one train step of ``batch`` x ``seq`` tokens; None
    for a family that has no count."""
    try:
        mod = importlib.import_module(f"perfbench.counts.flops_{model['family']}")
    except ModuleNotFoundError:
        return None
    return 3.0 * mod.forward_flops(model, batch, seq)
