#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. A run:

1. sets up: builds the port's kernels into ``build/`` (the first run in a
   checkout), draws the weights on the card from the seed, places the
   train state as the cell's traffic says (``tiering``), and runs the
   checked first steps through the same step and feed as the window, each
   on a batch of its own; then reads what the check needs of the state;
2. runs whole train steps for ``--seconds`` (the window), each ending in
   a synchronise; with ``--trace 1`` under ``torch.profiler``;
3. frees the program's state and runs the plain reference over the
   checked steps on the same weights and batches, and compares
   (:mod:`perfbench.check`);
4. prints the compared numbers beside their limits as the last lines on
   standard error, and one JSON line as the last line on standard output.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones. A run on a machine without the
cards, one that finds JAX or the JAX package loaded, and a traced run whose
window holds no device operation or leaves a listed per-layer metric
unread, prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux: from
    ``/proc``; elsewhere, now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
# before torch starts cuBLAS: the port's deterministic step needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("USE_FLAX", "0")
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import check, spec, trace, weights  # noqa: E402
from perfbench.reference import common  # noqa: E402
from perfbench.traffic import TokenStream  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch`` is another name)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def device_info(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        host_empty = getattr(torch._C, "_host_emptyCache", None)
        if host_empty is not None:
            host_empty()


def reference_readings(cell, ref, specs, stream, seed: int, device,
                       prec: str = "f32") -> dict:
    """The plain reference over the checked steps, from the weights of
    ``seed``: each step's loss, each unit's first clipped gradient norm,
    each unit's change after the steps."""
    tree = weights.draw(specs, seed, device)
    units = {}
    for s in specs:
        t = weights.leaf(tree, s)
        for name, i in weights.units(s):
            units[name] = t if i is None else t[i]
    del tree
    n = cell.traffic["checked_steps"]
    out = common.train(ref.loss, units,
                       [stream.batch(i) for i in range(1, n + 1)],
                       cell.model, cell.traffic["optimizer"], prec)
    update = {}
    for s in specs:
        first = weights.draw_leaf(s, seed, device)
        for name, i in weights.units(s):
            x0 = first if i is None else first[i]
            update[name] = float(torch.linalg.vector_norm(
                out["units"][name].double() - x0.double()))
        del first
    return {"losses": out["losses"], "first_grad": out["first_grad"],
            "update": update}


def checked_program(cell, specs, stream, seed: int, device, fault=None):
    """The program built for ``cell`` on the weights of ``seed``, driven
    through the checked first steps (the window's own step and feed), and
    its readings: each step's loss, each unit's first clipped gradient
    norm, each unit's change since the draw. ``fault`` wraps the step
    function (the control's readings and the tests)."""
    from perfbench.program import Program

    prog = Program(cell.model, cell.traffic, specs,
                   weights.draw(specs, seed, device), device)
    if fault is not None:
        prog.step_fn = fault(prog.step_fn)
    log(f"cell {cell.name}: {cell.traffic['batch']} x {cell.traffic['seq']} "
        f"tokens a step; placement {json.dumps(prog.placement())}")
    losses, first_grad = [], None
    for i in range(1, cell.traffic["checked_steps"] + 1):
        losses.append(float(prog.step(stream.batch(i))))
        if i == 1:
            first_grad = prog.first_grad_norms()
    return prog, {"losses": losses, "first_grad": first_grad,
                  "update": prog.update_norms(seed)}


class NoResult(RuntimeError):
    """A run that has to end with no result line."""


def per_layer(tl, cell, need: bool) -> dict:
    """The cell's per-layer metrics, each read from the traced window
    ``tl`` by its reader. A reader that finds nothing returns None, and
    its metric is left out; with ``need`` (a run on the card) that, or a
    window in which no operation ran on the device, is a fault of the
    trace: ``NoResult``."""
    if need and not tl.ops:
        raise NoResult("the traced window holds no device operation")
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(tl, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        elif need:
            raise NoResult(f"per-layer metric {m['name']} read nothing in "
                           f"{cell.name}'s traced window")
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             fault=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``fault``
    wraps the program's step function (the tests)."""
    if torch.device(device).type == "cuda":
        from perfbench.program import build_kernels
        built = build_kernels()
        log(f"device {torch.cuda.get_device_name(0)}; {power_limit()}; torch "
            f"{torch.__version__} (CUDA {torch.version.cuda}); kernels "
            f"{'built: ' + json.dumps(built) if built else 'found built'}")
    ref = spec.reference(cell.model["family"])
    specs = ref.param_specs(cell.model)
    stream = TokenStream(cell.traffic, cell.model["vocab_size"], seed, device)
    prog, readings = checked_program(cell, specs, stream, seed, device, fault)
    n_check = cell.traffic["checked_steps"]
    losses = readings["losses"]
    # the allocator keeps its cached blocks: the window starts warm
    gc.collect()
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    setup_s = t0 - T_START
    steps, failed, ends = 0, 0, []
    with trace.traced(traced) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            w0 = time.perf_counter()
            while True:
                loss = prog.step(stream.batch(n_check + steps + 1))
                _sync(device)
                steps += 1
                failed += not math.isfinite(float(loss))
                ends.append(time.perf_counter() - w0)
                if ends[-1] >= seconds:
                    break
            window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {steps} steps in {window_s:.3f} s, peak "
        f"{peak / GIB:.3f} GiB, set-up {setup_s:.3f} s; step seconds "
        + json.dumps([round(b - a, 4) for a, b in zip([0.0] + ends, ends)]))
    del prog, loss
    _free(device)

    result = {"correct": False, "attempted": steps, "failed": failed,
              "metrics": {}, "device": {**device_info(device),
                                        "memory_peak_bytes": int(peak)}}
    e2e = {m["name"]: m for m in cell.end_to_end}
    if not traced:
        values = {"train_tokens_per_s": steps * cell.tokens_per_step
                  / window_s, "peak_hbm_gib": peak / GIB,
                  "setup_s": setup_s}
        result["metrics"] = {k: {"value": values[spec.base(k)],
                                 "unit": m["unit"]} for k, m in e2e.items()}
    else:
        tl = trace.timeline(prof.results, steps)
        del prof
        result["device"]["busy_s"] = trace.length(tl.busy()) / 1e9
        result["device"]["window_s"] = tl.seconds
        result["metrics"] = per_layer(tl, cell, need=cuda)
        result["breakdown"] = tl.breakdown()
        del tl
    t_ref = time.perf_counter()
    ref_readings = reference_readings(cell, ref, specs, stream, seed, device)
    found = check.gaps(readings, ref_readings)
    correct, compared = check.judge(found, cell.limits)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s; losses program "
        f"{losses}, reference {ref_readings['losses']}; worst units "
        + json.dumps({k: v[1] for k, v in found.items()}))
    result["correct"] = correct and failed == 0
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in compared.items()}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found; no result", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    except NoResult as e:
        print(f"perfbench: {e}; no result", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that must not be: {bad}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
