#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card, at a
cell's own size (not a benchmark run: no window).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 4,5,6] [--out FILE]

For each seed of ``--seeds``: the program's checked steps and the plain
reference's, and the three compared numbers (the lower readings). For each
of ``--control-seeds``: the reference computed with float8 e4m3 products
(the precision below the configurations' bf16) put in the program's
place, against the float32 reference (the control, which has to come out
not correct). For each of ``--fault-seeds``: the program with half of
each batch left out (:mod:`perfbench.faults`). A step that returns its
state unchanged reads 1 on ``grad_gap`` and ``update_gap`` by their
definition and needs no run. One JSON line a reading, also appended to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench import run  # noqa: E402  (sets the paths and environment)
from perfbench import check, faults, spec  # noqa: E402
from perfbench.traffic import TokenStream  # noqa: E402


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def readings(cell, seed: int, kind: str, device) -> dict:
    """The compared numbers of one seed: ``kind`` is "program", "control"
    or a fault's name."""
    ref = spec.reference(cell.model["family"])
    specs = ref.param_specs(cell.model)
    stream = TokenStream(cell.traffic, cell.model["vocab_size"], seed, device)
    if kind == "control":
        got = run.reference_readings(cell, ref, specs, stream, seed, device,
                                     prec="fp8")
    else:
        prog, got = run.checked_program(
            cell, specs, stream, seed, device,
            None if kind == "program" else faults.FAULTS[kind])
        del prog
    run._free(device)
    want = run.reference_readings(cell, ref, specs, stream, seed, device)
    run._free(device)
    found = check.gaps(got, want)
    correct, _ = check.judge(found, cell.limits)
    top = {}
    for key in ("first_grad", "update"):
        g, w = got[key], want[key]
        floor = sorted(w.values())[len(w) // 2]
        top[key] = sorted(((abs(g[k] - w[k]) / max(w[k], floor), k, g[k],
                            w[k]) for k in w if k in g), reverse=True)[:5]
    return {"cell": cell.name, "seed": seed, "kind": kind,
            "correct_at_limits": correct, "top": top,
            **{k: v[0] for k, v in found.items()},
            "where": {k: v[1] for k, v in found.items()},
            "losses": got["losses"], "ref_losses": want["losses"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = "cuda"
    from perfbench.program import build_kernels
    build_kernels()
    jobs = ([(s, "program") for s in args.seeds]
            + [(s, "control") for s in args.control_seeds]
            + [(s, "half_batch") for s in args.fault_seeds])
    for seed, kind in jobs:
        line = json.dumps(readings(cell, seed, kind, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
