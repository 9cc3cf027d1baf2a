#!/usr/bin/env python3
"""Time one model's forward and train step built from two trees of the
port, in turns on one card, and give a verdict on each.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 step_ab.py [--arch seamless-m4t-medium] [--layers N]
        [--rounds R] PARENT CHANGE

PARENT and CHANGE are roots of checkouts: this one (``.``), or another
commit unpacked with ``git archive`` into a git-ignored directory. Each
measurement runs in a fresh process that imports that tree's
``repro_torch`` (its kernels built into the tree's own ``build/``): the
architecture at full width (and full depth, or its first ``--layers``) in
its dtype, weights drawn on the card from seed 0, the step-0 batch of
``SyntheticTokenDataset`` (2 rows of ``SEQ`` tokens, and the enc-dec
family's frames), ``forward`` under ``no_grad`` and ``make_train_step``'s
step (remat "full", AdamW float32 moments, every leaf on the card), each
the best of ``RUNS`` after a warm run, host clock around a synchronised
call. Each round runs parent, change, change, parent: two pairs, each
side first once. It prints every run, and for each metric the medians,
the parent's spread (the distance between its quartiles), the pairs the
change won, and a verdict: "gain" (the change wins at least nine tenths
of the pairs and the medians differ by more than the spread), "no
regression" (the change's median exceeds the parent's by no more than
the spread, or every change run is faster than every parent run),
"unresolved" (a larger difference, but within the change's own spread),
else "regression". It exits non-zero unless every run gives the same
first loss (the trees must compute the same step).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUNS = 5
SEQ = {"seamless-m4t-medium": 512}  # its 1024 frames are the config's


def best_ms(fn) -> list[float]:
    import torch

    fn()  # warm
    out = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def worker(arch: str, layers: int | None) -> None:
    """One tree's measurement (``repro_torch`` from ``PYTHONPATH``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenDataset, to_device_fn
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = get_model(cfg)
    data = SyntheticTokenDataset(cfg, 2, SEQ.get(arch, 2048), seed=0)
    batch = to_device_fn("cuda", cfg.dtype)(data.batch_at(0))
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    with torch.no_grad():
        fwd = best_ms(lambda: model.forward(params, batch, cfg))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, TrainStepConfig(), opt_cfg)
    state = {"p": params, "o": adamw.init(opt_cfg, params)}
    losses = []

    def one():
        state["p"], state["o"], metrics = step(state["p"], state["o"], batch)
        losses.append(float(metrics["loss"]))

    steps = best_ms(one)
    print(json.dumps({"fwd_ms": fwd, "step_ms": steps, "loss": losses[0],
                      "torch": torch.__version__}))


def quartiles(xs: list[float]) -> tuple[float, float]:
    q = statistics.quantiles(xs, n=4)
    return q[0], q[2]


def verdict(parent: list[float], change: list[float],
            pairs: list[tuple[float, float]]) -> str:
    """The verdict on one metric (lower is better) from each side's runs
    and the (parent, change) pairs."""
    lo, hi = quartiles(parent)
    spread = hi - lo
    diff = statistics.median(change) - statistics.median(parent)
    won = sum(c < p for p, c in pairs)
    line = (f"median parent {statistics.median(parent):.3f} ms, change "
            f"{statistics.median(change):.3f} ms ({diff:+.3f}), parent "
            f"spread {spread:.3f} ms, change won {won} of {len(pairs)} pairs")
    if won >= 0.9 * len(pairs) and -diff > spread:
        return f"{line}: gain"
    if diff <= spread or max(change) < min(parent):
        return f"{line}: no regression"
    c_lo, c_hi = quartiles(change)
    return f"{line}: " + ("unresolved" if diff <= c_hi - c_lo
                          else "regression")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seamless-m4t-medium")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args()
    if args.worker:
        worker(args.arch, args.layers)
        return
    parent, change = (Path(t).resolve() for t in args.trees)
    runs: dict[str, list[dict]] = {"parent": [], "change": []}
    pairs: list[dict] = []
    for r in range(args.rounds):
        got = {}
        for side in ("parent", "change", "change", "parent"):
            tree = parent if side == "parent" else change
            env = dict(os.environ, PYTHONPATH=str(tree / "src"),
                       CUBLAS_WORKSPACE_CONFIG=":4096:8")
            cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
                   "--arch", args.arch]
            if args.layers:
                cmd += ["--layers", str(args.layers)]
            out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                                 text=True, timeout=1200)
            if out.returncode:
                raise SystemExit(f"step_ab FAILED: {tree}:\n"
                                 f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
            run = json.loads(out.stdout.strip().splitlines()[-1])
            runs[side].append(run)
            got.setdefault(side, []).append(run)
            print(f"[step_ab] round {r} {side} ({tree.name}): forward best "
                  f"{min(run['fwd_ms']):.3f} ms, step best "
                  f"{min(run['step_ms']):.3f} ms, loss {run['loss']:.6f}",
                  flush=True)
        pairs += [{"parent": got["parent"][0], "change": got["change"][0]},
                  {"parent": got["parent"][1], "change": got["change"][1]}]
    tag = args.arch + (f" ({args.layers} layers)" if args.layers else "")
    for metric, key in (("forward", "fwd_ms"), ("step", "step_ms")):
        side = {k: [min(r[key]) for r in rs] for k, rs in runs.items()}
        for k, xs in side.items():
            print(f"[step_ab] {tag} {metric} {k} bests {xs}")
        print(f"[step_ab] {tag} {metric}: " + verdict(
            side["parent"], side["change"],
            [(min(p["parent"][key]), min(p["change"][key])) for p in pairs]))
    losses = {run["loss"] for rs in runs.values() for run in rs}
    if len(losses) != 1:
        raise SystemExit(f"step_ab FAILED: the trees' first losses differ: "
                         f"{sorted(losses)}")


if __name__ == "__main__":
    main()
