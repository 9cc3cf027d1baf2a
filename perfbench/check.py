"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, on the same drawn weights and batches.

Three numbers, each against its limit in ``limits/<cell>.json``:

* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: the first step's clipped gradient as AdamW took it, by
  unit: the largest gap between the program's norm and the reference's,
  over the reference's norm of that unit or the median unit's, whichever
  is larger;
* ``update_gap``: the same of each unit's change after the checked
  steps. Units whose reference gradient is under a thousandth of the
  median unit's are left out: AdamW moves them by round-off alone.

A unit that one side has and the other lacks, or a reading that is not a
finite number, reads as an infinite gap.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "grad_gap", "update_gap")
#: A unit whose reference gradient is below this share of the median unit's
#: is left out of ``update_gap``.
STILL = 1e-3


def _norm_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst unit's gap and its name."""
    if set(prog) != set(ref):
        return math.inf, "units differ: " + ", ".join(
            sorted(set(prog) ^ set(ref))[:4])
    floor = statistics.median(ref.values())
    worst, at = 0.0, ""
    for k, r in ref.items():
        if keep is not None and k not in keep:
            continue
        p = prog[k]
        gap = abs(p - r) / max(r, floor) if math.isfinite(p) else math.inf
        if not gap <= worst:
            worst, at = gap, k
    return worst, at


def gaps(prog: dict, ref: dict) -> dict[str, tuple[float, str]]:
    """Each compared number, with where it was read, of the program's
    readings ``prog`` against the reference's ``ref`` (each: ``losses``,
    ``first_grad``, ``update``)."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss = (math.inf, "steps differ")
    else:
        loss = max(((abs(p - r) / abs(r) if math.isfinite(p) else math.inf,
                     f"step {i}") for i, (p, r) in enumerate(
                        zip(prog["losses"], ref["losses"]), start=1)),
                   key=lambda t: t[0])
    g_ref = ref["first_grad"]
    floor = statistics.median(g_ref.values())
    moving = {k for k, g in g_ref.items() if g >= STILL * floor}
    return {"loss_gap": loss,
            "grad_gap": _norm_gap(prog["first_grad"], g_ref),
            "update_gap": _norm_gap(prog["update"], ref["update"], moving)}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit."""
    out = {n: {"value": found[n][0], "limit": limits[n]} for n in NAMES}
    return all(v["value"] <= v["limit"] for v in out.values()), out
