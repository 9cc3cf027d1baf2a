"""The work of one call of each of the port's kernels in a cell's train
step, from the configuration's shapes and the traffic's batch: every B2
call of a step attends over the same (batch, heads, seq), so one call's
count serves each launch."""
from __future__ import annotations

from perfbench.counts import peaks, work


def attention_call(model: dict, traffic: dict) -> dict:
    H = model["n_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    return dict(B=traffic["batch"], H=H, Sq=traffic["seq"], Sk=traffic["seq"],
                KV=model["n_kv_heads"], D=D, Dv=D, causal=True, window=None,
                itemsize=2)


def b2_fwd_bound_s(model: dict, traffic: dict) -> float:
    return peaks.bound_s(*work.flash_work(**attention_call(model, traffic)),
                         peaks.BF16_FLOPS)


def b2_bwd_bound_s(model: dict, traffic: dict) -> float:
    return peaks.bound_s(*work.flash_bwd_work(**attention_call(model,
                                                               traffic)),
                         peaks.BF16_FLOPS)


def roofline_share(calls: int, bound_s: float, time_ns: int) -> float | None:
    """Percent: the calls' least time over the time their kernels took;
    None where no call ran."""
    if calls == 0 or time_ns <= 0:
        return None
    return 100.0 * calls * bound_s / (time_ns / 1e9)
