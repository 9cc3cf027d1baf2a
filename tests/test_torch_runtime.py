"""The port's dual-buffer runtime, trace-driven pipeline, sizing advisor,
telemetry and two-level scheduler, against the JAX reference.

The reference's own cases (``tests/test_runtime.py``, ``test_pipeline.py``,
``test_sizing.py``, ``test_telemetry.py`` and the ``TwoLevelScheduler``
cases of ``test_fabric.py``) are ported here pointed at ``repro_torch``,
one section each; the runtime helpers of two sections carry the section's
prefix. ``test_tiering_config_auto_plan`` plans torch tensors where the
reference plans jax arrays. Then the placement paths this slice closes:
``PlacementPolicy.plan(local_fraction="auto")``, slab-aware
``stripe_bytes`` planning and ``TieringConfig(local_fraction="auto")``
give the reference's plans on the same inputs. Every number is compared
with ``==``: the runtime is numpy in both packages.
"""
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objects as ref_objects
from repro.core import placement as ref_placement
from repro.core import sizing as ref_sizing
from repro.core import tiering as ref_tiering

from repro_torch.core import (
    ETHERNET_25G,
    INFINIBAND_100G,
    NULL_TELEMETRY,
    DataObject,
    DolmaRuntime,
    MemoryPool,
    MetricsSnapshot,
    ObjectCatalog,
    ObjectKind,
    RemoteStore,
    SimClock,
    Telemetry,
    TwoLevelScheduler,
    validate_chrome_trace,
)
from repro_torch.core import objects as pt_objects
from repro_torch.core import placement as pt_placement
from repro_torch.core import sizing as pt_sizing
from repro_torch.core import tiering as pt_tiering
from repro_torch.core.dual_buffer import run_iterative
from repro_torch.core.placement import PlacementPolicy, demotion_order
from repro_torch.core.sizing import (
    MODEL_TOLERANCE,
    CostModel,
    ModelConfig,
    WorkloadProfile,
    advise_local_size,
    synthetic_profile,
)
from repro_torch.core.tiering import TieringConfig, plan_for_params
from repro_torch.hpc import (
    WORKLOADS,
    pooled_runtime,
    profile_workload,
    run_workload,
)

import _torch_hpc_parity as H
from _hypothesis_compat import given, settings, st

KB = 1 << 10
MIB = 1 << 20
SCALE = 0.2
SIM = 1000.0 / SCALE


# -- the runtime (ported from tests/test_runtime.py) ------------------------------------------

@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_bit_exact_vs_oracle(name):
    cls = WORKLOADS[name]
    oracle = run_workload(cls(scale=0.2, seed=3),
                          DolmaRuntime(local_fraction=1.0), n_iters=3)
    tiered = run_workload(
        cls(scale=0.2, seed=3),
        DolmaRuntime(local_fraction=0.2, dual_buffer=True, sim_scale=SIM),
        n_iters=3,
    )
    assert tiered.checksum == pytest.approx(oracle.checksum, rel=1e-9)
    assert tiered.elapsed_us >= oracle.elapsed_us  # tiering never free


@pytest.mark.parametrize("name", ["CG", "MG", "FT"])
def test_dual_buffer_helps(name):
    cls = WORKLOADS[name]
    times = {}
    for dual in (True, False):
        rt = DolmaRuntime(local_fraction=0.3, dual_buffer=dual, sim_scale=SIM,
                          policy=PlacementPolicy(all_large_remote=True))
        times[dual] = run_workload(cls(scale=0.2, seed=1), rt, 4).elapsed_us
    assert times[True] < times[False]


def test_simulation_deterministic():
    def run():
        rt = DolmaRuntime(local_fraction=0.2, sim_scale=SIM)
        return run_workload(WORKLOADS["CG"](scale=0.2, seed=5), rt, 3)

    a, b = run(), run()
    assert a.elapsed_us == b.elapsed_us
    assert a.checksum == b.checksum


def test_ethernet_slower_than_infiniband():
    def run(fabric):
        rt = DolmaRuntime(local_fraction=0.1, fabric=fabric, sim_scale=SIM)
        return run_workload(WORKLOADS["MG"](scale=0.2, seed=1), rt, 3).elapsed_us

    assert run(ETHERNET_25G) > run(INFINIBAND_100G)


def test_sync_writes_slower():
    def run(sync):
        rt = DolmaRuntime(local_fraction=0.1, sync_writes=sync, sim_scale=SIM,
                          dual_buffer=False)
        return run_workload(WORKLOADS["MG"](scale=0.2, seed=1), rt, 3).elapsed_us

    assert run(True) >= run(False)


class TestRemoteStore:
    def test_read_after_write_ordering(self):
        store = RemoteStore()
        store.alloc("x", np.arange(16, dtype=np.float64))
        store.write("x", np.full(16, 7.0), timeline="w")  # async
        data, t_read = store.read("x", timeline="r")
        # RAW: the read completes after the pending write
        assert np.all(data.view(np.float64) == 7.0)
        obj = store._objects["x"]
        assert t_read >= obj.pending_write_until

    def test_fence_waits_for_writes(self):
        store = RemoteStore()
        store.alloc("x", np.zeros(1 << 16))
        end = store.write("x", np.ones(1 << 16))
        t = store.fence(timeline="main")
        assert t >= end

    def test_atomics(self):
        store = RemoteStore()
        assert store.atomic_fetch_add("ctr", 5) == 0
        assert store.atomic_fetch_add("ctr", 2) == 5
        assert store.atomic_cas("ctr", 7, 11)
        assert not store.atomic_cas("ctr", 7, 13)
        assert store.atomic_read("ctr") == 11

    def test_snapshot_restore(self):
        store = RemoteStore()
        store.alloc("x", np.arange(8.0))
        blobs = store.snapshot_objects()
        store.write("x", np.zeros(8))
        store.restore_objects(blobs)
        assert np.all(store._objects["x"].data == np.arange(8.0))


def test_resident_cache_reduces_refetch():
    """Second iteration fetches less than the first (resident portion)."""
    rt = DolmaRuntime(local_fraction=0.5, sim_scale=SIM,
                      policy=PlacementPolicy(all_large_remote=True),
                      dual_buffer=False)
    rt.alloc("a", np.zeros(1 << 18))
    rt.finalize()
    durations = []
    for _ in range(2):
        t0 = rt.clock.now(rt.timeline)
        with rt.step():
            rt.fetch("a")
        durations.append(rt.clock.now(rt.timeline) - t0)
    assert durations[1] < durations[0]


def test_peak_local_within_capacity():
    rt = DolmaRuntime(local_fraction=0.3, sim_scale=SIM)
    rt.alloc("a", np.zeros(1 << 18))
    rt.alloc("b", np.zeros(1 << 16))
    rt.finalize()
    with rt.step():
        rt.fetch("a")
        rt.fetch("b")
    assert rt.peak_local_bytes() <= rt.local_capacity_bytes()


# -- the trace-driven pipeline (ported from tests/test_pipeline.py) ---------------------------

def _pipe_rt(frac, **kw):
    kw.setdefault("policy", PlacementPolicy(all_large_remote=True))
    return DolmaRuntime(local_fraction=frac, sim_scale=SIM, **kw)


# -- bit-exactness ---------------------------------------------------------
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_pipeline_bit_identical_vs_oracle(name):
    """Pipeline on/off both reproduce the untiered oracle bit-for-bit."""
    cls = WORKLOADS[name]
    oracle = run_workload(cls(scale=SCALE, seed=7),
                          DolmaRuntime(local_fraction=1.0), n_iters=3)
    for pipeline in (False, True):
        tiered = run_workload(cls(scale=SCALE, seed=7),
                              _pipe_rt(0.1, pipeline=pipeline), n_iters=3)
        assert tiered.checksum == oracle.checksum  # bit-identical, no approx


def test_pipeline_bit_identical_on_pool():
    oracle = run_workload(WORKLOADS["CG"](scale=SCALE, seed=7),
                          DolmaRuntime(local_fraction=1.0), n_iters=3)
    rt = pooled_runtime(3, local_fraction=0.1, sim_scale=SIM, pipeline=True,
                        policy=PlacementPolicy(all_large_remote=True))
    res = run_workload(WORKLOADS["CG"](scale=SCALE, seed=7), rt, n_iters=3)
    assert res.checksum == oracle.checksum
    assert res.stats["prefetch"]["batched_reads"] > 0


# -- monotonicity ----------------------------------------------------------
@pytest.mark.parametrize("name", ["CG", "MG", "BT"])
def test_pipelined_never_slower_than_serial(name):
    """Property: pipelined elapsed <= serial elapsed at every swept local
    fraction (serial = no prefetch at all, sync one-op-at-a-time reads)."""
    cls = WORKLOADS[name]
    for frac in (0.05, 0.1, 0.25, 0.5):
        serial = run_workload(cls(scale=SCALE, seed=1),
                              _pipe_rt(frac, dual_buffer=False), 4)
        pipe = run_workload(cls(scale=SCALE, seed=1),
                            _pipe_rt(frac, pipeline=True), 4)
        assert pipe.elapsed_us <= serial.elapsed_us * (1 + 1e-9), frac


def test_pipeline_beats_cross_iteration_prefetch_at_small_fraction():
    """The tentpole claim, as a cheap regression guard: at a small local
    fraction the trace-driven pipeline clearly beats the legacy dual
    buffer (the full sweep lives in benchmarks/fig_pipeline.py)."""
    cls = WORKLOADS["CG"]
    base = run_workload(cls(scale=SCALE, seed=1),
                        _pipe_rt(0.02, dual_buffer=True), 10)
    pipe = run_workload(cls(scale=SCALE, seed=1),
                        _pipe_rt(0.02, pipeline=True), 10)
    assert pipe.elapsed_us * 1.3 < base.elapsed_us


# -- trace recording + prediction ------------------------------------------
def test_trace_records_fetch_commit_order_and_predicts():
    rt = _pipe_rt(0.2, pipeline=True)
    rt.alloc("a", np.zeros(1 << 16))
    rt.alloc("b", np.zeros(1 << 16))
    rt.finalize()
    with rt.step():
        rt.fetch("a")
        rt.fetch("b")
        rt.commit("b", np.ones(1 << 16))
    assert rt.last_trace() == [("fetch", "a"), ("fetch", "b"), ("commit", "b")]
    assert rt.predicted_order() == ["a", "b"]
    with rt.step():
        rt.fetch("a")
        rt.fetch("b")
    stats = rt.stats()["prefetch"]
    # second step fetched in predicted order -> both served by the pipeline
    assert stats["trace_hits"] == 2
    assert stats["prediction_len"] == 2


def test_trace_miss_falls_back_to_demand_fetch():
    rt = _pipe_rt(0.2, pipeline=True)
    rt.alloc("a", np.zeros(1 << 16))
    rt.alloc("b", np.zeros(1 << 16))
    rt.finalize()
    with rt.step():
        rt.fetch("a")
    with rt.step():
        rt.fetch("b")  # never predicted: demand path, still correct
    stats = rt.stats()["prefetch"]
    assert stats["trace_misses"] >= 2
    # the mispredicted window entry for "a" was dropped on re-prediction
    with rt.step():
        rt.fetch("b")
    assert rt.predicted_order() == ["b"]


def test_reuse_distance_recorded():
    rt = _pipe_rt(0.2, pipeline=True)
    rt.alloc("a", np.zeros(1 << 16))
    rt.alloc("b", np.zeros(1 << 16))
    rt.finalize()
    for _ in range(2):
        with rt.step():
            rt.fetch("a")
            rt.fetch("b")
    # a,b,a,b -> each object re-used two fetch events after its last use
    assert rt.stats()["reuse_distances"] == {"a": 2, "b": 2}


# -- Belady-from-trace eviction --------------------------------------------
def test_belady_evicts_farthest_reuse_first():
    rt = _pipe_rt(0.2, pipeline=True)
    rt.alloc("a", np.zeros(1 << 16))
    rt.finalize()
    rt._prediction = ["x", "y", "z"]
    rt._pred_index = {"x": 0, "y": 1, "z": 2}
    rt._trace_pos = 1  # next predicted fetch is y
    rt._resident = {"x": 100, "y": 100, "z": 100}
    rt.cache_region_bytes = 300
    # requester at distance 0 (y): only strictly-farther residents go; x is
    # the farthest (wraps to next iteration) so it is evicted before z
    got = rt._evict_for(100, next_use=0, protect=set())
    assert got == 100
    assert rt._resident["y"] == 100      # the requester's peer: kept
    assert rt._resident["x"] == 0        # farthest: evicted first
    assert rt._resident["z"] == 100      # z (distance 1) not needed


def test_unpredicted_resident_is_first_victim():
    rt = _pipe_rt(0.2, pipeline=True)
    rt.alloc("a", np.zeros(1 << 16))
    rt.finalize()
    rt._prediction = ["x"]
    rt._pred_index = {"x": 0}
    rt._trace_pos = 0
    rt._resident = {"x": 100, "stale": 200}
    rt.cache_region_bytes = 300
    got = rt._evict_for(150, next_use=0, protect=set())
    assert got == 150
    assert rt._resident["stale"] == 0
    assert rt._resident["x"] == 100


# -- batched scatter-gather reads ------------------------------------------
def test_store_batch_read_orders_completions_and_amortizes_base():
    clock = SimClock()
    store = RemoteStore(clock=clock, fabric=INFINIBAND_100G)
    store.alloc("a", np.zeros(1 << 18))
    store.alloc("b", np.zeros(1 << 18))
    store.alloc("c", np.zeros(1 << 18))
    reqs = [("a", 1 << 18), ("b", 1 << 18), ("c", 1 << 18)]
    done = store.stream_read_batch(reqs, chunk_bytes=1 << 16, issue_at=0.0)
    # earlier window entries complete first (cumulative stream)
    assert done["a"] < done["b"] < done["c"]
    # one posted op spanning all extents: base paid once, so the batch beats
    # three separately posted streams on a fresh identical store
    solo_store = RemoteStore(clock=SimClock(), fabric=INFINIBAND_100G)
    t = 0.0
    for name in "abc":
        solo_store.alloc(name, np.zeros(1 << 18))
        t = solo_store.stream_read(name, nbytes=1 << 18, chunk_bytes=1 << 16,
                                   issue_at=t, mode="pipelined")
    assert done["c"] < t
    assert store.stats()["n_ops"] == 1  # one scatter-gather op


def test_pool_batch_read_spreads_nodes_and_respects_raw():
    clock = SimClock()
    pool = MemoryPool(4, clock=clock, fabric=INFINIBAND_100G,
                      stripe_bytes=1 << 16)
    data = np.arange(1 << 16, dtype=np.float64)  # 512 KiB -> 8 extents
    pool.alloc("a", data)
    pool.alloc("b", data)
    end_w = pool.write("a", data * 2, timeline="w")
    done = pool.stream_read_batch([("a", data.nbytes), ("b", data.nbytes)],
                                  chunk_bytes=1 << 16, issue_at=0.0)
    assert done["a"] >= end_w  # RAW: batch ordered after the pending write
    # the batch streamed on several nodes' QPs concurrently
    touched = [n for n in pool.nodes if n.stats()["bytes_read"] > 0]
    assert len(touched) >= 2
    # a 4-node batch completes faster than the same bytes on one node
    single = MemoryPool(1, clock=SimClock(), fabric=INFINIBAND_100G,
                        stripe_bytes=1 << 16)
    single.alloc("a", data)
    single.alloc("b", data)
    done1 = single.stream_read_batch([("a", data.nbytes), ("b", data.nbytes)],
                                     chunk_bytes=1 << 16, issue_at=0.0)
    assert max(done.values()) < max(done1.values())


# -- satellite fixes --------------------------------------------------------
def test_cache_occupancy_sums_resident_objects():
    """`peak_local_bytes` must reflect *both* remote objects cached in the
    same step, not just the last-touched one."""
    rt = _pipe_rt(0.8, dual_buffer=False)
    rt.alloc("o0", np.zeros(1 << 16))
    rt.alloc("o1", np.zeros(1 << 16))
    rt.finalize()
    with rt.step():
        rt.fetch("o0")
        rt.fetch("o1")
    one = rt.metadata.get("o0").size_bytes
    # the old accounting overwrote occupancy with the last-touched object,
    # capping the peak at a single object's size
    assert rt._peak_cached > one
    assert rt._peak_cached <= rt.cache_region_bytes


def test_peak_local_still_within_capacity():
    rt = _pipe_rt(0.3, pipeline=True)
    rt.alloc("a", np.zeros(1 << 18))
    rt.alloc("b", np.zeros(1 << 16))
    rt.finalize()
    for _ in range(2):
        with rt.step():
            rt.fetch("a")
            rt.fetch("b")
    assert rt.peak_local_bytes() <= rt.local_capacity_bytes()


def test_local_commit_reuses_buffer():
    """LOCAL-tier commit must not allocate a fresh array every iteration."""
    rt = DolmaRuntime(local_fraction=1.0)
    rt.alloc("x", np.arange(8.0))
    rt.finalize()
    buf = rt._live["x"].data
    with rt.step():
        x = rt.fetch("x")
        rt.commit("x", x + 1.0)          # fresh array: copied into place
    assert rt._live["x"].data is buf     # same buffer, no realloc
    assert np.all(rt.fetch("x") == np.arange(8.0) + 1.0)
    with rt.step():
        rt.commit("x", rt.fetch("x"))    # committing the buffer itself: no-op
    assert rt._live["x"].data is buf
    with rt.step():
        view = rt.fetch("x")[::-1]       # aliasing view: must full-copy
        rt.commit("x", view)
    assert np.all(rt._live["x"].data == (np.arange(8.0) + 1.0)[::-1])


def test_run_workload_delegates_to_run_iterative():
    """One driver: run_workload and run_iterative agree exactly."""
    from repro_torch.core import run_iterative

    w1 = WORKLOADS["MG"](scale=SCALE, seed=2)
    r1 = run_workload(w1, _pipe_rt(0.2, pipeline=True), 3)
    rt2 = _pipe_rt(0.2, pipeline=True)
    w2 = WORKLOADS["MG"](scale=SCALE, seed=2)
    w2.register(rt2)
    rt2.finalize()
    elapsed = run_iterative(rt2, 3, w2.iterate)
    assert elapsed == r1.elapsed_us
    assert w2.checksum(rt2) == r1.checksum


# -- the sizing advisor (ported from tests/test_sizing.py) ------------------------------------

N_ITERS = 5
TARGET = 0.16


def _sizing_rt(frac, **kw):
    return DolmaRuntime(local_fraction=frac, sim_scale=SIM, **kw)


@pytest.fixture(scope="module")
def profiles():
    """One instrumented oracle recording per workload (shared, read-only)."""
    return {
        name: profile_workload(cls(scale=SCALE, seed=3), _sizing_rt(1.0))
        for name, cls in WORKLOADS.items()
    }


# -- cost-model-vs-simulator agreement -------------------------------------
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_model_matches_simulator(name, profiles):
    """Predicted elapsed_us within the stated tolerance on all 8 workloads."""
    model = CostModel(profiles[name])
    for frac in (0.05, 0.5):
        pred = model.predict(
            local_fraction=frac,
            config=ModelConfig(mode="pipeline", n_iters=N_ITERS),
        ).elapsed_us
        sim = run_workload(WORKLOADS[name](scale=SCALE, seed=3),
                           _sizing_rt(frac, pipeline=True), N_ITERS).elapsed_us
        assert abs(pred - sim) / sim <= MODEL_TOLERANCE, (name, frac)


def test_model_matches_simulator_legacy_and_serial(profiles):
    model = CostModel(profiles["CG"])
    for mode, rt_kw in (("legacy", {"dual_buffer": True}),
                        ("serial", {"dual_buffer": False})):
        pred = model.predict(
            local_fraction=0.1, config=ModelConfig(mode=mode, n_iters=N_ITERS)
        ).elapsed_us
        sim = run_workload(WORKLOADS["CG"](scale=SCALE, seed=3),
                           _sizing_rt(0.1, **rt_kw), N_ITERS).elapsed_us
        assert abs(pred - sim) / sim <= MODEL_TOLERANCE, mode


def test_model_matches_simulator_on_pool(profiles):
    """The pool replay (striping + per-node QPs) tracks the simulator too."""
    model = CostModel(profiles["FT"], policy=PlacementPolicy(all_large_remote=True))
    for nodes in (2, 4):
        pred = model.predict(
            local_fraction=0.05,
            config=ModelConfig(mode="pipeline", n_iters=N_ITERS,
                               fabric=ETHERNET_25G, n_nodes=nodes),
        ).elapsed_us
        rt = pooled_runtime(nodes, local_fraction=0.05, sim_scale=SIM,
                            fabric=ETHERNET_25G, pipeline=True,
                            policy=PlacementPolicy(all_large_remote=True))
        sim = run_workload(WORKLOADS["FT"](scale=SCALE, seed=3),
                           rt, N_ITERS).elapsed_us
        assert abs(pred - sim) / sim <= MODEL_TOLERANCE, nodes


def test_model_oracle_prediction_is_pure_compute(profiles):
    """At fraction 1.0 with the default policy nothing is remote: prediction
    must equal the recorded per-step compute total."""
    prof = profiles["CG"]
    model = CostModel(prof)
    pred = model.predict(local_fraction=1.0,
                         config=ModelConfig(n_iters=3)).elapsed_us
    assert pred == pytest.approx(model.predict_untiered(n_iters=3))
    assert pred == pytest.approx(3 * prof.compute_us_per_step())


# -- the solver -------------------------------------------------------------
def test_advised_budget_meets_target_when_resimulated(profiles):
    """Acceptance: every workload's advised budget re-simulates within the
    16% degradation target, and mean memory saving is >= 40%."""
    savings = []
    for name, cls in WORKLOADS.items():
        advice = advise_local_size(profiles[name], TARGET,
                                   mode="pipeline", n_iters=N_ITERS)
        assert advice.feasible, name
        oracle = run_workload(cls(scale=SCALE, seed=3), _sizing_rt(1.0), N_ITERS)
        advised = run_workload(cls(scale=SCALE, seed=3),
                               _sizing_rt(advice.advised_fraction, pipeline=True),
                               N_ITERS)
        assert advised.checksum == oracle.checksum, name
        deg = advised.elapsed_us / oracle.elapsed_us - 1.0
        assert deg <= TARGET + 1e-9, (name, deg)
        savings.append(advice.memory_saving)
    assert sum(savings) / len(savings) >= 0.40


@settings(max_examples=12)
@given(t_lo=st.floats(min_value=0.005, max_value=0.25),
       t_gap=st.floats(min_value=0.0, max_value=0.25))
def test_solver_monotonicity(profiles, t_lo, t_gap):
    """Tighter degradation target => advised local budget can only grow."""
    profile = profiles["CG"]
    a_tight = advise_local_size(profile, t_lo, n_iters=N_ITERS)
    a_loose = advise_local_size(profile, t_lo + t_gap, n_iters=N_ITERS)
    assert a_tight.advised_budget_bytes >= a_loose.advised_budget_bytes


def test_degradation_curve_and_marginal_attribution(profiles):
    prof = profiles["CG"]
    advice = advise_local_size(prof, TARGET, n_iters=N_ITERS)
    # the curve covers the whole budget axis and prices every point
    budgets = [p.budget_bytes for p in advice.curve]
    assert budgets == sorted(budgets, reverse=True)
    assert all(p.predicted_us > 0 for p in advice.curve)
    assert any(p.degradation > TARGET for p in advice.curve)  # sweep bites
    # marginal attribution follows the policy's demotion order
    order = [o.name for o in demotion_order(CostModel(prof).catalog)]
    assert [m.name for m in advice.marginal] == order
    assert advice.marginal[0].size_bytes >= advice.marginal[-1].size_bytes


def test_profile_json_roundtrip(profiles):
    prof = profiles["MG"]
    clone = WorkloadProfile.from_json(prof.to_json())
    cfg = ModelConfig(n_iters=3)
    assert CostModel(clone).predict(local_fraction=0.1, config=cfg).elapsed_us \
        == CostModel(prof).predict(local_fraction=0.1, config=cfg).elapsed_us


# -- "auto" plumbing --------------------------------------------------------
def test_placement_policy_auto_budget(profiles):
    prof = profiles["CG"]
    policy = PlacementPolicy()
    catalog = CostModel(prof).catalog
    plan = policy.plan(catalog, local_fraction="auto", profile=prof)
    advice = advise_local_size(prof, policy=policy)
    assert plan.budget_bytes == advice.advised_budget_bytes
    with pytest.raises(ValueError, match="WorkloadProfile"):
        policy.plan(catalog, local_fraction="auto")


def test_runtime_auto_sizing_via_run_workload():
    """local_fraction='auto' profiles, advises, and still bit-matches."""
    cls = WORKLOADS["CG"]
    oracle = run_workload(cls(scale=SCALE, seed=3), _sizing_rt(1.0), N_ITERS)
    rt = _sizing_rt("auto", pipeline=True)
    res = run_workload(cls(scale=SCALE, seed=3), rt, N_ITERS)
    assert rt.sizing_advice is not None
    assert isinstance(rt.local_fraction, float)
    assert rt.local_fraction < 1.0
    assert res.checksum == oracle.checksum
    deg = res.elapsed_us / oracle.elapsed_us - 1.0
    assert deg <= rt.degradation_target + 1e-9
    assert rt.stats()["plan"]["memory_saving"] >= 0.40


def test_runtime_auto_requires_profile():
    rt = _sizing_rt("auto")
    rt.alloc("x", np.zeros(64 * 1024, dtype=np.uint8))
    with pytest.raises(RuntimeError, match="WorkloadProfile"):
        rt.finalize()


def test_runtime_rejects_unknown_fraction_string():
    with pytest.raises(ValueError, match="auto"):
        _sizing_rt("autosize")


def test_synthetic_profile_prices_a_catalog():
    catalog = ObjectCatalog([
        DataObject(name=f"w{i}", shape=(1 << 20,), dtype=np.float32,
                   kind=ObjectKind.PARAM, n_reads=2, n_writes=1)
        for i in range(6)
    ])
    prof = synthetic_profile(catalog, compute_us_per_step=5000.0)
    advice = advise_local_size(prof, TARGET, n_iters=4)
    assert 0 < advice.advised_budget_bytes <= catalog.total_bytes
    assert advice.oracle_us == pytest.approx(4 * 5000.0)


def test_tiering_config_auto_plan():
    params = {f"layer{i}": torch.zeros((256, 256), dtype=torch.float32)
              for i in range(4)}
    config = TieringConfig(local_fraction="auto", degradation_target=0.5)
    plan = plan_for_params(params, config=config)
    assert plan.budget_bytes <= plan.peak_bytes
    assert plan.peak_bytes == 4 * 256 * 256 * 4


# -- telemetry (ported from tests/test_telemetry.py) ------------------------------------------

class TestSpans:
    def test_span_nesting_on_sim_clock(self):
        clock = SimClock()
        tel = Telemetry(clock=clock)
        with tel.span("step", timeline="main", cat="step"):
            clock.advance("main", 5.0)
            with tel.span("fetch", timeline="main", obj="x"):
                clock.advance("main", 7.0)
            clock.advance("main", 3.0)
        # inner span closes first; both are clocked on the simulated timeline
        inner, outer = tel.spans
        assert inner.name == "fetch" and outer.name == "step"
        assert outer.begin_us == 0.0 and outer.end_us == 15.0
        assert inner.begin_us == 5.0 and inner.end_us == 12.0
        assert outer.begin_us <= inner.begin_us <= inner.end_us <= outer.end_us
        assert inner.args == {"obj": "x"}

    def test_record_span_explicit_times(self):
        tel = Telemetry()
        tel.record_span("read", track="node0/qp0", begin_us=10.0,
                        end_us=30.0, cat="io", nbytes=4096)
        (s,) = tel.spans
        assert s.dur_us == 20.0 and s.cat == "io"
        assert tel.track_total_us("node0/qp0", cats=("io",)) == 20.0

    def test_disabled_records_nothing(self):
        clock = SimClock()
        tel = Telemetry(clock=clock, enabled=False)
        with tel.span("step"):
            clock.advance("main", 5.0)
        tel.record_span("x", track="t", begin_us=0.0, end_us=1.0)
        tel.instant("i", track="t")
        tel.count("c")
        tel.gauge("g", 1.0)
        assert not tel.spans and not tel.instants
        assert not tel.counters and not tel.gauges
        assert NULL_TELEMETRY.enabled is False

    def test_max_events_drops_and_reports(self):
        tel = Telemetry(max_events=2)
        for i in range(4):
            tel.record_span(f"s{i}", track="t", begin_us=0.0, end_us=1.0)
        assert len(tel.spans) == 2
        assert tel.dropped_events == 2
        assert tel.snapshot().meta["dropped_events"] == 2


class TestCountersAcrossResize:
    def _pool(self, tel, n=2):
        pool = MemoryPool(n, stripe_bytes=16 * KB, telemetry=tel)
        rng = np.random.default_rng(0)
        for i in range(4):
            pool.alloc(f"obj{i}", rng.random(64 * KB // 8))  # 4 stripes each
        return pool

    def test_resize_counters_aggregate(self):
        tel = Telemetry()
        pool = self._pool(tel)
        grow = pool.add_nodes(2)
        alive = sorted(n.node_id for n in pool.alive_nodes())
        shrink = pool.drain_nodes(alive[-1:])
        assert tel.counter("pool.resizes", op="add") == 1
        assert tel.counter("pool.resizes", op="drain") == 1
        # counter totals reconcile with the per-pass migration stats
        moved = grow["moved_bytes"] + shrink["moved_bytes"]
        assert tel.counter("pool.moved_bytes") == moved
        assert moved > 0

    def test_migration_spans_recorded(self):
        tel = Telemetry()
        pool = self._pool(tel)
        pool.add_nodes(1)
        spans = tel.spans_on("migration", cats=("migration",))
        assert spans and all(s.name == "rebalance" for s in spans)
        assert all(s.dur_us >= 0 for s in spans)
        names = {i.name for i in tel.instants}
        assert "resize:add" in names

    def test_fabric_io_counters_per_node(self):
        tel = Telemetry()
        pool = self._pool(tel)
        pool.read("obj0")
        read = sum(v for k, v in tel.counters.items()
                   if k.startswith("fabric.bytes_read"))
        assert read >= 64 * KB


class _WindowWorkload:
    """Per-iteration access schedule over remote objects of given sizes
    (the last schedule entry repeats for any remaining iterations)."""

    def __init__(self, rt, sizes, schedule):
        self.schedule = schedule
        rng = np.random.default_rng(1)
        for n, s in sizes.items():
            rt.alloc(n, rng.random(s // 8))

    def body(self, rt, it):
        for n in self.schedule[min(it, len(self.schedule) - 1)]:
            rt.fetch(n)
            rt.charge_compute(us=50.0)


def _window_runtime(frac=0.6, **kw):
    return DolmaRuntime(
        local_fraction=frac, pipeline=True, prefetch_window=2,
        policy=PlacementPolicy(all_large_remote=True), **kw,
    )


class TestPrefetchAccuracy:
    def test_stable_trace_is_fully_accurate(self):
        tel = Telemetry()
        rt = _window_runtime(telemetry=tel)
        names = [f"o{i}" for i in range(4)]
        wl = _WindowWorkload(rt, {n: 16 * KB for n in names}, [names])
        rt.finalize()
        run_iterative(rt, 4, wl.body)
        s = rt.summary()
        assert s["prefetch"]["window_used"] > 0
        assert s["prefetch"]["dropped_mispredicts"] == 0
        assert s["prefetch_accuracy"] == 1.0
        assert tel.counter("prefetch.window_used") == s["prefetch"]["window_used"]

    def test_shrinking_trace_drops_mispredicts(self):
        # the read set shrinks each iteration: window entries posted from
        # the old prediction get disowned at the step boundary (drops)
        rt = _window_runtime(frac=0.5)
        sizes = {"o0": 16 * KB, "o1": 16 * KB, "o2": 16 * KB, "o3": 64 * KB}
        wl = _WindowWorkload(rt, sizes, [
            ["o0", "o1", "o2", "o3"],
            ["o0", "o1", "o2"],
            ["o0", "o1"],
        ])
        rt.finalize()
        run_iterative(rt, 4, wl.body)
        s = rt.summary()
        assert s["prefetch"]["dropped_mispredicts"] > 0
        assert s["prefetch"]["window_used"] > 0
        assert s["prefetch_accuracy"] is not None
        assert s["prefetch_accuracy"] < 1.0

    def test_accuracy_none_before_any_window_activity(self):
        rt = _window_runtime()
        _WindowWorkload(rt, {"o0": 16 * KB}, [["o0"]])
        rt.finalize()
        assert rt.summary()["prefetch_accuracy"] is None


class TestReconciliation:
    """The acceptance contract: per-timeline span totals == elapsed_us."""

    @pytest.mark.parametrize("wl", ["CG", "MG"])
    def test_pipeline_spans_tile_timeline(self, wl):
        tel = Telemetry()
        rt = pooled_runtime(2, local_fraction=0.25, pipeline=True,
                            telemetry=tel)
        res = run_workload(WORKLOADS[wl](), rt, n_iters=4)
        # rt.elapsed_us() is the current clock (the checksum read after the
        # run advances it past the WorkloadResult snapshot for some loads)
        total = tel.track_total_us(rt.timeline)  # compute + stall spans
        assert total == pytest.approx(rt.elapsed_us(), rel=1e-9)
        assert res.elapsed_us <= rt.elapsed_us()
        acct = rt.summary()["time_accounting"]
        assert acct["compute_us"] + acct["stall_us"] == pytest.approx(
            rt.elapsed_us(), rel=1e-9)

    def test_legacy_spans_tile_timeline(self):
        tel = Telemetry()
        rt = DolmaRuntime(local_fraction=0.25, dual_buffer=True,
                          policy=PlacementPolicy(all_large_remote=True),
                          telemetry=tel)
        run_workload(WORKLOADS["CG"](), rt, n_iters=4)
        assert tel.track_total_us(rt.timeline) == pytest.approx(
            rt.elapsed_us(), rel=1e-9)

    def test_telemetry_changes_no_numbers(self):
        """Enabled vs. disabled (default) must be simulation-identical."""
        on = run_workload(
            WORKLOADS["CG"](),
            pooled_runtime(2, local_fraction=0.25, pipeline=True,
                           telemetry=Telemetry()),
            n_iters=4,
        )
        off = run_workload(
            WORKLOADS["CG"](),
            pooled_runtime(2, local_fraction=0.25, pipeline=True),
            n_iters=4,
        )
        assert on.elapsed_us == off.elapsed_us
        assert on.checksum == off.checksum


class TestSummary:
    def test_summary_exposes_reuse_and_access_counts(self):
        rt = _window_runtime()
        wl = _WindowWorkload(rt, {"a": 16 * KB, "b": 16 * KB},
                             [["a", "b"]])
        rt.finalize()
        run_iterative(rt, 3, wl.body)
        s = rt.summary()
        assert s["epochs"] == 3
        assert s["access_counts"]["a"] == (3, 0)  # 3 fetches, 0 commits
        assert "a" in s["reuse_stats"] or "b" in s["reuse_stats"]
        assert s["plan"] is not None
        assert s["elapsed_us"] == rt.elapsed_us()
        assert set(s["time_accounting"]) == {"compute_us", "stall_us",
                                             "overlap_us"}


class TestChromeTrace:
    def _recorded(self):
        tel = Telemetry()
        tel.record_span("read", track="node0/qp0", begin_us=0.0,
                        end_us=12.5, cat="io", nbytes=4096)
        tel.record_span("compute", track="main", begin_us=0.0, end_us=40.0,
                        cat="compute")
        tel.instant("evict", track="main", t_us=20.0, victim="x")
        tel.count("prefetch.trace_hits", 3)
        return tel

    def test_schema_round_trip(self, tmp_path):
        tel = self._recorded()
        path = tmp_path / "trace.json"
        tel.write_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        validate_chrome_trace(trace)  # no raise
        # one named track per tid used, spans carry ts/dur, instants scope
        xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        assert {e["name"] for e in xs} == {"read", "compute"}
        names = {e["args"]["name"] for e in trace["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        assert names == {"node0/qp0", "main"}
        assert trace["otherData"]["counters"]["prefetch.trace_hits"] == 3

    def test_validator_rejects_missing_thread_name(self):
        trace = self._recorded().to_chrome_trace()
        trace["traceEvents"] = [e for e in trace["traceEvents"]
                                if e["name"] != "thread_name"]
        with pytest.raises(ValueError, match="thread_name"):
            validate_chrome_trace(trace)

    def test_validator_rejects_negative_dur(self):
        trace = self._recorded().to_chrome_trace()
        for e in trace["traceEvents"]:
            if e["ph"] == "X":
                e["dur"] = -1.0
        with pytest.raises(ValueError, match="dur"):
            validate_chrome_trace(trace)

    def test_validator_rejects_unknown_phase(self):
        trace = self._recorded().to_chrome_trace()
        trace["traceEvents"][-1]["ph"] = "Z"
        with pytest.raises(ValueError, match="phase"):
            validate_chrome_trace(trace)

    def test_validator_rejects_non_list_events(self):
        with pytest.raises(ValueError, match="list"):
            validate_chrome_trace({"traceEvents": {}})


class TestMetricsSnapshot:
    def test_json_round_trip(self):
        snap = MetricsSnapshot(counters={"a": 1.0}, gauges={"g": 2.0},
                               meta={"run": "x"})
        again = MetricsSnapshot.from_json(
            json.loads(json.dumps(snap.to_json())))
        assert again == snap

    def test_diff(self):
        a = MetricsSnapshot(counters={"hits": 2.0, "same": 1.0},
                            gauges={"nodes": 2.0, "keep": 7.0})
        b = MetricsSnapshot(counters={"hits": 5.0, "same": 1.0,
                                      "new": 4.0},
                            gauges={"nodes": 3.0, "keep": 7.0})
        d = a.diff(b)
        assert d["counters"] == {"hits": 3.0, "new": 4.0}
        assert d["gauges"] == {"nodes": (2.0, 3.0)}

    def test_snapshot_diff_across_pool_resize(self):
        tel = Telemetry()
        pool = MemoryPool(2, stripe_bytes=16 * KB, telemetry=tel)
        pool.alloc("x", np.random.default_rng(0).random(8 * KB // 8))
        before = tel.snapshot()
        pool.add_nodes(1)
        delta = before.diff(tel.snapshot())
        assert delta["counters"].get("pool.resizes{op=add}") == 1.0


# -- the two-level scheduler (ported from tests/test_fabric.py) -------------------------------

class TestTwoLevelScheduler:
    def _mk(self, n, tpc, clock=None):
        return TwoLevelScheduler(
            n_threads=n, threads_per_cluster=tpc,
            buffer_bytes=256 * MIB, clock=clock or SimClock(),
        )

    def test_cluster_assignment(self):
        s = self._mk(24, 4)
        assert s.n_clusters == 6
        assert s.cluster_of(0) == 0 and s.cluster_of(23) == 5

    def test_buffers_partitioned_evenly(self):
        s = self._mk(8, 4)
        assert all(b.buffer_bytes == 256 * MIB // 8 for b in s.buffers)

    def test_two_level_beats_single_cluster(self):
        """The §4.3 claim: clustering QPs reduces contention at high n."""
        kw = dict(n_iters=4, compute_us_total=50_000.0,
                  fetch_bytes_total=512 * MIB, parallel_efficiency=0.95)
        multi = self._mk(24, 4).simulate(**kw)
        single = self._mk(24, 24).simulate(**kw)
        assert multi < single

    def test_more_threads_not_slower(self):
        kw = dict(n_iters=4, compute_us_total=100_000.0,
                  fetch_bytes_total=64 * MIB, parallel_efficiency=0.95)
        t1 = self._mk(1, 4).simulate(**kw)
        t8 = self._mk(8, 4).simulate(**kw)
        assert t8 < t1


# -- the placement paths this slice closes, against the reference ------------

def _catalog(mod, seed: int, n: int = 40):
    """A seeded census: mixed sizes, access counts, lifetimes and pins."""
    rng = np.random.default_rng(seed)
    return mod.ObjectCatalog([
        mod.DataObject(
            name=f"obj{i:03d}",
            shape=(int(rng.integers(1, 1 << 12)), int(rng.integers(1, 64))),
            dtype=np.float32 if i % 3 else np.float16,
            kind=mod.ObjectKind.PARAM,
            n_reads=int(rng.integers(0, 8)),
            n_writes=int(rng.integers(0, 4)),
            lifetime_iters=math.inf if i % 7 else 0,
            pinned_local=(i % 11 == 0),
        ) for i in range(n)])


def _plan_fields(plan):
    return ({k: t.value for k, t in plan.tiers.items()}, plan.local_bytes,
            plan.remote_bytes, plan.peak_bytes, plan.budget_bytes,
            dict(plan.node_of), dict(plan.node_load), plan.n_nodes)


@pytest.mark.parametrize("n_nodes", [1, 3])
@pytest.mark.parametrize("target", [0.05, 0.16, 0.5])
def test_auto_budget_plans_match_reference(n_nodes, target):
    """``plan(local_fraction="auto")`` over a synthetic profile: the same
    advice and the same plan as the reference's."""
    plans, advice = [], []
    for objs, pl, sz in ((ref_objects, ref_placement, ref_sizing),
                         (pt_objects, pt_placement, pt_sizing)):
        catalog = _catalog(objs, seed=1, n=16)
        prof = sz.synthetic_profile(catalog, compute_us_per_step=2000.0)
        plans.append(pl.PlacementPolicy().plan(
            catalog, local_fraction="auto", profile=prof,
            degradation_target=target, n_nodes=n_nodes))
        advice.append(sz.advise_local_size(prof, target, n_nodes=n_nodes))
    assert _plan_fields(plans[1]) == _plan_fields(plans[0])
    assert dataclasses.asdict(advice[1]) == dataclasses.asdict(advice[0])
    assert plans[1].budget_bytes == advice[1].advised_budget_bytes


@pytest.mark.parametrize("name", ["CG", "FT", "XSBench"])
def test_auto_budget_from_a_recorded_profile_matches_reference(name):
    """A profile recorded by an instrumented warmup of a workload, then
    ``plan(local_budget_bytes="auto")`` on a pool of 4 nodes."""
    got = []
    for pkg in (H.package("repro"), H.package("repro_torch")):
        core, hpc = pkg.core, pkg.hpc
        rt = core.DolmaRuntime(local_fraction=1.0, sim_scale=SIM)
        prof = hpc.profile_workload(hpc.WORKLOADS[name](scale=0.1, seed=2),
                                    rt)
        catalog = core.ObjectCatalog([
            core.DataObject(name=o.name, shape=(o.size_bytes,),
                            dtype=np.uint8, n_reads=o.n_reads,
                            n_writes=o.n_writes)
            for o in prof.objects.values()])
        got.append(_plan_fields(core.PlacementPolicy().plan(
            catalog, local_budget_bytes="auto", profile=prof, n_nodes=4)))
    assert got[1] == got[0]


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("stripe", [4 * KB, 32 * KB, 48 * KB])
@pytest.mark.parametrize("capacity", [None, 1 << 20])
def test_stripe_bytes_plans_match_reference(seed, stripe, capacity):
    """Slab-aware planning: node loads priced at slab footprints, node
    capacity shrunk by measured fragmentation."""
    kw = dict(local_fraction=0.1, n_nodes=3, node_capacity_bytes=capacity,
              stripe_bytes=stripe, node_frag_bytes={0: 3 * KB, 2: 70 * KB})
    ref = ref_placement.PlacementPolicy().plan(_catalog(ref_objects, seed),
                                               **kw)
    got = pt_placement.PlacementPolicy().plan(_catalog(pt_objects, seed),
                                              **kw)
    assert _plan_fields(got) == _plan_fields(ref)
    if capacity is None:  # the same demotions, each priced at its footprint
        flat = pt_placement.PlacementPolicy().plan(
            _catalog(pt_objects, seed), **{**kw, "stripe_bytes": None})
        assert flat.tiers == got.tiers
        assert sum(got.node_load.values()) > sum(flat.node_load.values())


@pytest.mark.parametrize("target", [0.05, 0.16, 0.5])
def test_tiering_auto_plans_match_reference(target):
    """``TieringConfig(local_fraction="auto")`` over the same parameter
    tree (torch tensors here, jax arrays there): the same plan. Both price
    a step's compute at the reference's TPU HBM rate."""
    rng = np.random.default_rng(4)
    shapes = {"embed": (512, 128), "head": (128, 512),
              "layers": {f"w{i}": (int(rng.integers(16, 256)), 256)
                         for i in range(6)},
              "norm": (128,)}

    def tree(shape_tree, make):
        if isinstance(shape_tree, dict):
            return {k: tree(v, make) for k, v in shape_tree.items()}
        return make(shape_tree)

    ref = ref_tiering.plan_for_params(
        tree(shapes, lambda s: jnp.zeros(s, jnp.float32)),
        config=ref_tiering.TieringConfig(mode="host_offload",
                                         local_fraction="auto",
                                         degradation_target=target))
    got = pt_tiering.plan_for_params(
        tree(shapes, lambda s: torch.zeros(s, dtype=torch.float32)),
        config=pt_tiering.TieringConfig(mode="host_offload",
                                        local_fraction="auto",
                                        degradation_target=target))
    assert _plan_fields(got) == _plan_fields(ref)
