"""The expert-paging loop of ``benchmarks/fig_expert_paging.py``, with the
package it drives and the weights it serves as arguments, so that one loop
runs through the JAX reference and through the port. Not a test module.

The loop's numbers (hit rate, misses, prefetch commits, sync fetches,
simulated degradation, the residency advice) follow from the router's
decisions at every step, so they equal the committed ``BENCH_pr10.json``
only on the reference's weights: the caller makes them with ``jax.random``,
skews the router as the benchmark does, and carries them over. Output
files, trace export and prints are left out; the loop's own asserts are
kept. This module imports neither package itself.
"""
from __future__ import annotations

import importlib

import numpy as np

HIT_RATE_FLOOR = 0.80
DEGRADATION_TARGET = 0.16   # the paper's §6.1 knee
OVERSUB_FLOOR = 4.0
HOT_FRACTION = 0.2
HOT_SCALE = 4.0

# (arch, n_experts override, resident_max), as the benchmark's CONFIGS
CONFIGS = [
    ("deepseek-v3-671b", 32, 8),
    ("mixtral-8x7b", 32, 8),
]
MAX_NEW = 48        # the benchmark's decode length without --smoke
PROMPT_SHAPE = (2, 8)


def n_hot(n_experts: int) -> int:
    """How many experts (the first) the benchmark's skewed router favours."""
    return max(int(n_experts * HOT_FRACTION), 1)


def paging_row(pkg, cfg, params, prompts: np.ndarray, *, resident_max: int,
               max_new: int = MAX_NEW) -> dict:
    """``run_config``'s body through ``pkg``: an untiered engine, then a
    paged engine under a 4x-oversubscribed HBM budget for two waves split
    by ``reset()``. ``params`` are the model's, router already skewed;
    ``cfg`` is float32. Returns the benchmark's row plus the tokens."""
    S = pkg.serving
    n_experts = cfg.n_experts
    n_moe = cfg.n_layers - cfg.first_k_dense
    slab_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 4
    total_expert_bytes = n_moe * n_experts * slab_bytes
    hbm_budget = total_expert_bytes // int(OVERSUB_FLOOR)
    resident_bytes = n_moe * resident_max * slab_bytes
    assert resident_bytes <= hbm_budget, (
        f"{cfg.name}: resident set {resident_bytes}B does not fit the "
        f"oversubscribed budget {hbm_budget}B"
    )

    ref_eng = S.ServingEngine(cfg, params, S.EngineConfig(max_batch=2,
                                                          max_len=64))
    ref = ref_eng.generate(prompts, max_new=max_new)

    paging = importlib.import_module(f"{pkg.name}.serving.expert_paging")
    eng = S.ServingEngine(cfg, params, S.EngineConfig(
        max_batch=2, max_len=64, hbm_budget_bytes=hbm_budget,
        expert_paging=paging.ExpertPagingConfig(resident_max=resident_max,
                                                throttle=0.0)))
    wave1 = eng.generate(prompts, max_new=max_new)
    eng.reset()  # cold restart: wave 2 warm-starts from the surviving EMA
    wave2 = eng.generate(prompts, max_new=max_new)
    eng.pool.check_no_orphans()

    bit_identical = bool(np.array_equal(ref, wave1)
                         and np.array_equal(ref, wave2))
    store = eng.expert_store
    st = store.stats()
    oversub = total_expert_bytes / hbm_budget
    sizing = importlib.import_module(f"{pkg.name}.core.sizing")
    advice = sizing.advise_expert_residency(
        eng.expert_pager.ema,
        bytes_per_expert=store.slab_bytes,
        fetch_us_per_expert=store.mean_fetch_us() or 1.0,
        compute_us_per_step=store.pcfg.compute_us_per_step,
        experts_per_step=store.experts_per_step(),
        degradation_target=DEGRADATION_TARGET,
        hbm_budget_bytes=hbm_budget,
    )
    store.close()

    row = {
        "arch": cfg.name,
        "expert_sharding": cfg.expert_sharding,
        "n_experts": n_experts,
        "n_hot": n_hot(n_experts),
        "n_moe_layers": n_moe,
        "resident_max": resident_max,
        "slab_bytes": slab_bytes,
        "total_expert_bytes": total_expert_bytes,
        "hbm_budget_bytes": hbm_budget,
        "oversubscription": oversub,
        "bit_identical": bit_identical,
        "hit_rate": st["hit_rate"],
        "degradation": st["degradation"],
        "hits": st["hits"],
        "misses": st["misses"],
        "prefetch_commits": st["prefetch_commits"],
        "sync_fetches": st["sync_fetches"],
        "bytes_fetched": st["bytes_fetched"],
        "steps": st["steps"],
        "advice": advice.summary(),
    }

    # the acceptance bar — hard asserts, not just reported numbers
    assert bit_identical, f"{cfg.name}: paged tokens diverged from untiered"
    assert oversub >= OVERSUB_FLOOR, f"{cfg.name}: oversubscription {oversub}"
    assert row["hit_rate"] >= HIT_RATE_FLOOR, (
        f"{cfg.name}: expert hit-rate {row['hit_rate']:.3f} < "
        f"{HIT_RATE_FLOOR}"
    )
    assert row["degradation"] <= DEGRADATION_TARGET, (
        f"{cfg.name}: paged degradation {row['degradation']:.3f} > "
        f"{DEGRADATION_TARGET}"
    )
    return {**row, "tokens": (ref, wave1, wave2)}

