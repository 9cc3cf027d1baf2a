"""Faults planted under the timed path, which the check has to catch: each
wraps the program's step function ``step(params, opt, batch) -> (params,
opt, metrics)``."""
from __future__ import annotations

import torch


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def unchanged(step):
    """A step that returns its state unchanged (the step runs on a copy,
    since it writes REMOTE leaves in place)."""
    def f(params, opt, batch):
        _, _, metrics = step(_clone(params), _clone(opt), batch)
        return params, opt, metrics
    return f


def half_batch(step):
    """A step that leaves out the second half of the batch's rows: the mean
    is taken over the rest."""
    def f(params, opt, batch):
        return step(params, opt, {k: v[:v.shape[0] // 2]
                                  for k, v in batch.items()})
    return f


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
