"""The port's continuous-batching scheduler against the JAX reference, on
the CPU.

* The reference's edge cases (``tests/test_scheduler.py``: join-on-arrival
  mid-decode, EOS retirement freeing per-tenant pool arenas, shed/re-admit
  under pool pressure, bit-identity against sequential single-tenant runs,
  submit validation) pointed at the port, the engine on the reference's
  reduced granite-8b parameters carried over by
  ``convert.params_from_reference``.
* ``admission_log`` ``==`` the reference's on the same arrivals (every
  field is numpy: the advisor, the simulator, the pool), and every
  completed request's tokens and steps equal, the wall-clock ``wall_us``
  aside.
* ``benchmarks/fig_serving_mt.py``'s loop through the port
  (``_torch_serving_parity.fig_serving_mt``) gives ``BENCH_pr9.json``
  exactly, the wall-clock ``latency_us`` aside.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import get_model as ref_get_model

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.serving import (
    ContinuousScheduler,
    EngineConfig,
    Request,
    SchedulerConfig,
    ServingEngine,
)

import _torch_serving_parity as P

KIB = 1024


@pytest.fixture(scope="module")
def reference_setup():
    cfg = ref_reduced_config(ref_get_config("granite-8b"), dtype=jnp.float32)
    params = ref_get_model(cfg).init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, P.param_bytes(params)


@pytest.fixture(scope="module")
def setup(reference_setup):
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    params = params_from_reference(reference_setup[1], device="cpu")
    return cfg, params, P.param_bytes(params)


def _engine(cfg, params, total, *, max_batch=3, max_len=48, budget_frac=0.2):
    return ServingEngine(cfg, params, EngineConfig(
        max_batch=max_batch, max_len=max_len,
        hbm_budget_bytes=int(total * budget_frac),
        pool_nodes=1, pool_stripe_bytes=4 * KIB,
    ))


def _scfg(**over):
    base = dict(readvise_every=4, node_capacity_bytes=16 * KIB,
                min_nodes=1, max_nodes=4, window=4, decay=0.5)
    base.update(over)
    return SchedulerConfig(**base)


def test_join_mid_decode_next_step(setup):
    """A request arriving while another tenant decodes joins the very next
    shared step — no wave barrier, and both decode concurrently."""
    cfg, params, total = setup
    sched = ContinuousScheduler(_engine(cfg, params, total), _scfg())
    sched.submit(Request(tenant="alpha",
                         prompt=np.array([5, 9, 2], np.int32), max_new=10))
    for _ in range(3):
        assert sched.step()
    sched.submit(Request(tenant="beta",
                         prompt=np.array([7, 1], np.int32), max_new=4))
    sched.drain(max_steps=200)
    (a,) = sched.tenants["alpha"].completed
    (b,) = sched.tenants["beta"].completed
    # beta was granted a lane at the first step after its arrival...
    assert b["start_step"] == 3
    assert b["first_token_step"] == b["start_step"] + 2  # prompt len 2
    # ...while alpha was still mid-decode (true interleaving, no barrier)
    assert a["done_step"] > b["start_step"]
    assert len(b["tokens"]) == 4 and len(a["tokens"]) == 10


def test_eos_retirement_frees_arena(setup):
    """EOS retirement frees the tenant's pool arena extents: the per-tenant
    KV entries disappear and the allocator audit stays orphan-free."""
    cfg, params, total = setup
    prompt = np.array([5, 9, 2], np.int32)
    # learn the (deterministic, greedy) first generated token
    probe = ContinuousScheduler(_engine(cfg, params, total), _scfg())
    probe.submit(Request(tenant="solo", prompt=prompt, max_new=1))
    probe.drain(max_steps=50)
    first_tok = int(probe.tenants["solo"].completed[0]["tokens"][0])

    eng = _engine(cfg, params, total)
    if not eng._demoted_cache_names():
        pytest.skip("budget did not demote any cache tier for this config")
    sched = ContinuousScheduler(eng, _scfg(readvise_every=2))
    sched.submit(Request(tenant="solo", prompt=prompt, max_new=8,
                         eos_token=first_tok))
    # run up to the admission pass while the request is still in prefill:
    # the controller offloads the tenant's demoted KV into its own arena
    for _ in range(2):
        assert sched.step()
    assert eng.tenant_kv_names("solo"), "admission never offloaded tenant KV"
    stats = eng.pool.arena_stats()
    assert stats.get("solo", {}).get("live_bytes", 0) > 0
    sched.drain(max_steps=100)
    (done,) = sched.tenants["solo"].completed
    # retired on EOS, not max_new
    assert done["tokens"].tolist() == [first_tok]
    # ...and the arena is empty again, with no leaked extents anywhere
    assert eng.tenant_kv_names("solo") == []
    # a fully-freed arena drops out of the stats (or reports zero live)
    assert eng.pool.arena_stats().get("solo", {}).get("live_bytes", 0) == 0
    audit = eng.pool.check_no_orphans()
    assert audit["objects"] == 0


def test_shed_tenant_readmitted_after_load_drops(setup):
    """Under pool pressure the heavy tenant is shed (queued work waits, no
    lanes granted) and automatically re-admitted once the fleet working set
    decays — its requests still complete."""
    cfg, params, total = setup
    eng = _engine(cfg, params, total, max_batch=3, max_len=64)
    sched = ContinuousScheduler(eng, _scfg(
        readvise_every=4, node_capacity_bytes=8 * KIB, max_nodes=2,
    ))
    # light tenant keeps steady short work; heavy tenant floods long work
    for k in range(3):
        sched.submit(Request(
            tenant="light",
            prompt=np.array([3 + k, 7, 11], np.int32), max_new=3))
    for k in range(3):
        sched.submit(Request(
            tenant="heavy",
            prompt=(np.arange(40, dtype=np.int32) % 50) + 1 + k,
            max_new=8))
    sched.drain(max_steps=1000)
    for _ in range(4):
        sched.readvise()

    heavy = sched.tenants["heavy"]
    assert heavy.shed_count >= 1, "pool pressure never shed the heavy tenant"
    shed_entries = [e for e in sched.admission_log
                    if not e["tenants"]["heavy"]["admitted"]]
    assert shed_entries, "no admission entry recorded the shed"
    # while shed, its work queued rather than being dropped...
    assert any(e["tenants"]["heavy"]["queue_depth"] > 0
               for e in shed_entries)
    # ...and after the load dropped it was re-admitted and completed
    assert sched.admission_log[-1]["tenants"]["heavy"]["admitted"]
    assert len(heavy.completed) == 3
    assert len(sched.tenants["light"].completed) == 3
    # every admitted tenant met the per-tenant SLO at every admission point
    for e in sched.admission_log:
        for _t, row in e["tenants"].items():
            if row["admitted"] and row["advised_budget_bytes"] is not None:
                assert row["resim_degradation"] <= 0.16 + 1e-9


def test_bit_identical_to_sequential_oracle(setup):
    """Interleaved multi-tenant tokens match each request run alone through
    a fresh engine at the same batch shape, bit for bit."""
    cfg, params, total = setup
    reqs = [
        Request(tenant="alpha", prompt=np.array([5, 9, 2], np.int32),
                max_new=5),
        Request(tenant="beta", prompt=np.array([7, 1], np.int32), max_new=6),
        Request(tenant="alpha", prompt=np.array([11, 4, 8, 3], np.int32),
                max_new=4),
    ]
    sched = ContinuousScheduler(_engine(cfg, params, total), _scfg())
    sched.submit(dataclasses.replace(reqs[0]))
    sched.step()  # alpha/1 already decoding when the others arrive
    sched.submit(dataclasses.replace(reqs[1]))
    sched.submit(dataclasses.replace(reqs[2]))
    sched.drain(max_steps=200)
    got = {r["request_id"]: r["tokens"]
           for rs in sched.results().values() for r in rs}
    assert len(got) == 3

    oracle = ContinuousScheduler(_engine(cfg, params, total), _scfg())
    for req in reqs:
        rid = oracle.submit(dataclasses.replace(req))
        oracle.drain(max_steps=200)
        done = oracle.tenants[req.tenant].completed[-1]
        assert done["request_id"] == rid
        np.testing.assert_array_equal(got[rid], done["tokens"])


def test_submit_validation(setup):
    """Oversized and empty prompts are rejected up front."""
    cfg, params, total = setup
    sched = ContinuousScheduler(
        _engine(cfg, params, total, max_len=16), _scfg())
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(tenant="t",
                             prompt=np.arange(1, 15, dtype=np.int32),
                             max_new=8))
    with pytest.raises(ValueError, match="empty"):
        sched.submit(Request(tenant="t",
                             prompt=np.array([], np.int32), max_new=2))


# -- parity with the reference's scheduler ------------------------------------
PKGS = (P.package("repro"), P.package("repro_torch"))


def _shed_mix(S, sched) -> None:
    """test_shed_tenant_readmitted_after_load_drops's arrivals."""
    for k in range(3):
        sched.submit(S.Request(
            tenant="light",
            prompt=np.array([3 + k, 7, 11], np.int32), max_new=3))
    for k in range(3):
        sched.submit(S.Request(
            tenant="heavy",
            prompt=(np.arange(40, dtype=np.int32) % 50) + 1 + k,
            max_new=8))
    sched.drain(max_steps=1000)
    for _ in range(4):
        sched.readvise()


def _join_mix(S, sched) -> None:
    """Arrivals while other lanes decode, then a drain."""
    sched.submit(S.Request(tenant="alpha",
                           prompt=np.array([5, 9, 2], np.int32), max_new=6))
    for _ in range(3):
        sched.step()
    sched.submit(S.Request(tenant="beta",
                           prompt=np.array([7, 1], np.int32), max_new=9))
    sched.submit(S.Request(tenant="alpha",
                           prompt=np.array([11, 4, 8, 3], np.int32),
                           max_new=4))
    sched.drain(max_steps=200)
    sched.readvise()


MIXES = {
    "shed": (_shed_mix, dict(max_batch=3, max_len=64),
             dict(readvise_every=4, node_capacity_bytes=8 * KIB,
                  max_nodes=2)),
    "join": (_join_mix, dict(max_batch=3, max_len=48),
             dict(readvise_every=2)),
}


def _scheduler(S, cfg, params, total, engine_kw, scfg_kw):
    eng = S.ServingEngine(cfg, params, S.EngineConfig(
        hbm_budget_bytes=int(total * 0.2), pool_nodes=1,
        pool_stripe_bytes=4 * KIB, **engine_kw))
    base = dict(readvise_every=4, node_capacity_bytes=16 * KIB,
                min_nodes=1, max_nodes=4, window=4, decay=0.5)
    base.update(scfg_kw)
    return S.ContinuousScheduler(eng, S.SchedulerConfig(**base))


def _without_wall_clock(results: dict) -> dict:
    return {t: [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in r.items() if k != "wall_us"} for r in rs]
            for t, rs in results.items()}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_admission_log_matches_reference(mix, reference_setup, setup):
    """The same arrivals through both schedulers: every admission pass
    (admitted and shed tenants, advised budgets, remote bytes, re-simulated
    degradation, queue depths, lanes, target nodes, migration) ``==``
    field by field; completed requests' tokens and steps equal (``wall_us``
    is wall clock and excluded), as are the pools' arena stats."""
    drive, engine_kw, scfg_kw = MIXES[mix]
    P.restart_resource_names(*PKGS)  # one count per package
    ref = _scheduler(ref_serving, *reference_setup, engine_kw, scfg_kw)
    got = _scheduler(P.package("repro_torch").serving, *setup, engine_kw,
                     scfg_kw)
    drive(ref_serving, ref)
    drive(P.package("repro_torch").serving, got)
    assert len(got.admission_log) == len(ref.admission_log) > 0
    for mine, want in zip(got.admission_log, ref.admission_log):
        assert mine.keys() == want.keys()
        for key in want:
            assert mine[key] == want[key], (want["step"], key)
    if mix == "shed":
        assert any(e["shed"] for e in ref.admission_log)
    assert _without_wall_clock(got.results()) == _without_wall_clock(
        ref.results())
    assert got.engine.pool.stats() == ref.engine.pool.stats()
    for tenant in ref.tenants:
        assert (got.tenants[tenant].shed_count
                == ref.tenants[tenant].shed_count)


def test_bench_pr9_reproduced(setup):
    """``benchmarks/fig_serving_mt.py``'s loop through the port gives the
    committed ``BENCH_pr9.json`` (its wall-clock ``latency_us`` aside):
    nodes_trajectory, 'crest' shed 10 times, completed {acme 16, blue 16,
    crest 6}, max_admitted_degradation 0.15647851562499993, 25 admission
    passes, and every request's tokens bit-identical to the sequential
    oracle (``bit_identical``; the loop asserts it)."""
    cfg, params, _total = setup
    got = P.fig_serving_mt(P.package("repro_torch"), cfg, params)
    assert P.bench_mismatches(got["serving_mt"], "BENCH_pr9") == []
    assert got["serving_mt"]["bit_identical"] is True
