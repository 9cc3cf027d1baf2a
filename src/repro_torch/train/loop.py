"""Training loop: data prefetch, async checkpoints, straggler watchdog.

A port of ``repro.train.loop``. Fault tolerance:

  * async checkpoints every ``ckpt_every`` steps (delta-encoded, atomic);
  * start-up restores the latest checkpoint;
  * a step-time watchdog flags stragglers (> ``straggler_factor`` x the
    rolling median); the fault-injection tests read its events;
  * the data stream is a deterministic function of (seed, step), so a
    replay after a restore is exact.

``jax.jit(..., donate_argnums)`` becomes an eager step that rebinds the
parameters and moments it returns (REMOTE ones updated in place). The
placement is the step config's ``tiering`` (:class:`~repro_torch.core.
tiering.TieringConfig`; None, the default, keeps every leaf on the
device), applied after the restore by
:func:`~repro_torch.core.tiering.place_state`.

Under a device mesh (:func:`~repro_torch.models.sharding.use_mesh`) every
rank runs the loop: the state, drawn alike on every rank from the seed (or
restored whole from a checkpoint of any mesh), is laid out by the spec
trees (:func:`~repro_torch.models.sharding.distribute_tree`) before it is
placed, and each batch lands in its sharded layout
(:func:`~repro_torch.data.pipeline.device_put_fn`).
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import resolve_device
from repro_torch.core.tiering import TieringConfig, place_state
from repro_torch.data.pipeline import (
    PrefetchingLoader,
    SyntheticTokenDataset,
    device_put_fn,
    to_device_fn,
)
from repro_torch.models.sharding import (
    batch_pspec_tree,
    current_mesh,
    distribute_tree,
    get_rules,
    opt_pspec_tree,
    params_pspec_tree,
)
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import (
    TrainStepConfig,
    init_train_state,
    make_train_step,
)


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    straggler_factor: float = 3.0
    straggler_window: int = 20


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    step_times: list
    straggler_events: list
    restored_from: int | None


def train(
    model_cfg: ModelConfig,
    step_cfg: TrainStepConfig,
    opt_cfg: AdamWConfig,
    loop_cfg: LoopConfig,
    *,
    on_step: Callable[[int, dict], None] | None = None,
    fault_hook: Callable[[int], None] | None = None,
    device: str | torch.device = "cuda",
    dataset: SyntheticTokenDataset | None = None,
) -> LoopResult:
    """Run the loop on ``device``. Returns the loss and timing history.

    The parameters are drawn from a generator on ``device`` seeded with
    ``loop_cfg.seed``; the batches come from ``dataset`` (anything with
    ``batch_at(step)``), by default a :class:`SyntheticTokenDataset` of
    ``loop_cfg``'s batch, sequence and seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(loop_cfg.seed)
    params, opt_state = init_train_state(gen, model_cfg, step_cfg, opt_cfg,
                                         device=dev)

    ckpt = CheckpointManager(loop_cfg.ckpt_dir) if loop_cfg.ckpt_dir else None
    start_step = 0
    restored_from = None
    if ckpt is not None:
        restored = ckpt.restore(params, opt_state)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            start_step = restored["step"]
            restored_from = start_step
    mesh = current_mesh()
    if mesh is not None:
        pspecs = params_pspec_tree(
            params, expert_sharding=model_cfg.expert_sharding, mesh=mesh)
        params = distribute_tree(params, pspecs, mesh)
        opt_state = distribute_tree(
            opt_state, opt_pspec_tree(opt_state, pspecs, mesh), mesh)
    params, opt_state, plan = place_state(
        params, opt_state, step_cfg.tiering or TieringConfig(), device=dev)
    train_step = make_train_step(model_cfg, step_cfg, opt_cfg, plan=plan)

    if dataset is None:
        dataset = SyntheticTokenDataset(model_cfg, loop_cfg.batch,
                                        loop_cfg.seq, seed=loop_cfg.seed)
    put_fn = (to_device_fn(dev, model_cfg.dtype) if mesh is None else
              device_put_fn(mesh, lambda b: batch_pspec_tree(b, mesh),
                            dtype=model_cfg.dtype))
    loader = PrefetchingLoader(dataset, start_step=start_step, put_fn=put_fn)

    losses: list[float] = []
    times: list[float] = []
    stragglers: list[dict] = []
    window: collections.deque = collections.deque(
        maxlen=loop_cfg.straggler_window)

    try:
        step = start_step
        while step < loop_cfg.steps:
            data_step, batch = next(loader)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            step = data_step + 1
            losses.append(loss)
            times.append(dt)

            # straggler watchdog
            if len(window) >= 5:
                med = statistics.median(window)
                if dt > loop_cfg.straggler_factor * med:
                    stragglers.append({"step": step, "dt": dt, "median": med})
            window.append(dt)

            if on_step is not None:
                on_step(step, metrics)
            if fault_hook is not None:
                fault_hook(step)  # tests raise here to simulate node failure
            if ckpt is not None and step % loop_cfg.ckpt_every == 0:
                ckpt.save(step, params, opt_state, metadata={
                    "rules": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in get_rules().items()},
                    "arch": model_cfg.name,
                    "seed": loop_cfg.seed,
                })
            if step % loop_cfg.log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
    finally:
        loader.close()
        if ckpt is not None:
            ckpt.wait()

    return LoopResult(
        final_step=step,
        losses=losses,
        step_times=times,
        straggler_events=stragglers,
        restored_from=restored_from,
    )
