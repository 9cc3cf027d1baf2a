"""The system under test: the port's train step (``repro_torch``), built
for a cell and driven one step at a time, and the readings the check
takes of its state.

The step is ``make_train_step``'s, its state placed by ``place_state``
under the traffic's ``tiering``: a ``host_offload`` plan keeps the leaves
beyond the local budget in pinned host memory, streams REMOTE layer
weights through the layer loop's dual buffer, and updates REMOTE leaves
slice by slice with their write-back. This module is the only one of the
benchmark that imports the program.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import TieringConfig, place_state
from repro_torch.optim import adamw
from repro_torch.train.step import TrainStepConfig, make_train_step

from perfbench import weights


def build_kernels() -> dict[str, float]:
    """Build the port's CUDA kernels that are not built yet (into
    ``build/`` in the checkout); returns the seconds of each build run."""
    from repro_torch.kernels import _build
    return _build.build_all()


def model_config(model: dict) -> ModelConfig:
    """The program's configuration of a configuration file."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in fields and k != "dtype"}
    return ModelConfig(dtype=getattr(torch, model["dtype"]), **kw)


def opt_config(opt: dict) -> adamw.AdamWConfig:
    fields = {f.name for f in dataclasses.fields(adamw.AdamWConfig)}
    return adamw.AdamWConfig(**{k: v for k, v in opt.items() if k in fields})


class Program:
    """The port's train step over one cell's state. ``params`` is the
    drawn parameter tree; the step takes it over (placed, and REMOTE
    leaves copied into pinned host memory)."""

    def __init__(self, model: dict, traffic: dict, specs: list,
                 params: dict, device):
        self.specs, self.device = specs, device
        cfg = model_config(model)
        t = traffic["tiering"]
        tiering = TieringConfig(mode=t["mode"],
                                local_fraction=t.get("local_fraction", 1.0),
                                prefetch=t["prefetch"])
        self.opt_cfg = opt_config(traffic["optimizer"])
        opt = adamw.init(self.opt_cfg, params)
        self.params, self.opt, self.plan = place_state(params, opt, tiering,
                                                       device=device)
        step_cfg = TrainStepConfig.from_tiering(
            tiering, remat=traffic["step"]["remat"],
            microbatches=traffic["step"]["microbatches"])
        self.step_fn = make_train_step(cfg, step_cfg, self.opt_cfg,
                                       plan=self.plan)

    def step(self, batch: dict) -> torch.Tensor:
        """One train step; returns its loss (on the device)."""
        self.params, self.opt, metrics = self.step_fn(self.params, self.opt,
                                                      batch)
        return metrics["loss"]

    def placement(self) -> dict:
        """The plan's summary and its REMOTE parameters (none untiered)."""
        if self.plan is None:
            return {"remote_params": []}
        return {**self.plan.summary(), "remote_params": sorted(
            n for n in self.plan.remote_names() if n.startswith("params"))}

    def first_grad_norms(self) -> dict[str, float]:
        """Each unit's norm of the clipped gradient AdamW took in the first
        step, from the first moment after it: m = (1 - b1) g."""
        out = {}
        for s in self.specs:
            n = weights.unit_norms(weights.leaf(self.opt["m"], s), s,
                                   self.device)
            out.update({k: v / (1 - self.opt_cfg.b1) for k, v in n.items()})
        return out

    def update_norms(self, seed: int) -> dict[str, float]:
        """Each unit's norm of its parameters' change since the draw of
        ``seed`` (REMOTE leaves read from host memory)."""
        out = {}
        for s in self.specs:
            first = weights.draw_leaf(s, seed, self.device)
            out.update(weights.unit_norms(weights.leaf(self.params, s), s,
                                          self.device, minus=first))
            del first
        return out
