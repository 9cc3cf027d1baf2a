"""The port's online autoscaler against the JAX reference, on the CPU.

* The reference's cases (``tests/test_autoscale.py``: the rolling profile,
  plan diffing and the engine loop) pointed at the port, the engine on the
  reference's reduced granite-8b parameters carried over by
  ``convert.params_from_reference``.
* ``autoscale_log`` ``==`` the reference engine's, field by field, on the
  same waves (every field is numpy: the advisor, the simulator, the pool).
* ``benchmarks/fig_autoscale.py``'s loop through the port
  (``_torch_serving_parity.fig_autoscale``) gives ``BENCH_pr5.json``
  exactly.
"""
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
from repro_torch.core.objects import DataObject, ObjectCatalog, ObjectKind
from repro_torch.core.placement import PlacementPolicy, diff_plans
from repro_torch.core.sizing import ObjectProfile, RollingProfile
from repro_torch.serving import AutoscaleConfig, EngineConfig, ServingEngine

import _torch_serving_parity as P

KIB = 1 << 10
MIB = 1 << 20


# -- RollingProfile ---------------------------------------------------------
def _wave(name_sizes, compute_us=100.0):
    rows = {
        name: ObjectProfile(
            name=name, size_bytes=size, real_nbytes=size,
            kind=ObjectKind.KV_CACHE.value, n_reads=1, n_writes=1,
            n_fetch_events=1, n_commit_events=1,
        )
        for name, size in name_sizes.items()
    }
    events = []
    for name in name_sizes:
        events.append(("fetch", name))
        events.append(("compute", compute_us))
    for name in name_sizes:
        events.append(("commit", name))
    return events, rows


class TestRollingProfile:
    def test_window_trims_old_waves(self):
        rp = RollingProfile(window=3, decay=1.0)
        for i in range(5):
            rp.append_wave(*_wave({"kv": 10 * KIB}))
        assert len(rp) == 3
        assert rp.n_waves_seen == 5
        assert len(rp.profile().steps) == 3

    def test_decayed_max_tracks_burst_then_ages_out(self):
        rp = RollingProfile(window=8, decay=0.5)
        rp.append_wave(*_wave({"kv": 100 * KIB}))  # burst
        assert rp.profile().objects["kv"].size_bytes == 100 * KIB
        rp.append_wave(*_wave({"kv": 10 * KIB}))
        # one wave later the burst still dominates (hysteresis) ...
        assert rp.profile().objects["kv"].size_bytes == 50 * KIB
        rp.append_wave(*_wave({"kv": 10 * KIB}))
        rp.append_wave(*_wave({"kv": 10 * KIB}))
        rp.append_wave(*_wave({"kv": 10 * KIB}))
        # ... then ages below the live working set
        assert rp.profile().objects["kv"].size_bytes == 10 * KIB

    def test_newest_wave_dominates_growth(self):
        rp = RollingProfile(window=4, decay=0.5)
        rp.append_wave(*_wave({"kv": 10 * KIB}))
        rp.append_wave(*_wave({"kv": 80 * KIB}))
        assert rp.profile().objects["kv"].size_bytes == 80 * KIB

    def test_event_counters_accumulate_and_union_census(self):
        rp = RollingProfile(window=4, decay=1.0)
        rp.append_wave(*_wave({"a": 8 * KIB}))
        rp.append_wave(*_wave({"a": 8 * KIB, "b": 16 * KIB}))
        prof = rp.profile()
        assert set(prof.objects) == {"a", "b"}
        assert prof.objects["a"].n_fetch_events == 2
        assert prof.objects["b"].n_fetch_events == 1

    def test_profile_feeds_cost_model(self):
        from repro_torch.core.sizing import CostModel

        rp = RollingProfile(window=4, decay=0.5)
        for _ in range(3):
            rp.append_wave(*_wave({"kv0": 200 * KIB, "kv1": 150 * KIB},
                                  compute_us=5000.0))
        model = CostModel(rp.profile())
        oracle = model.predict_untiered(n_iters=4)
        tight = model.predict(local_fraction=0.05, n_iters=4).elapsed_us
        assert oracle > 0
        assert tight >= oracle  # demotion can only add fetch time

    def test_simulate_profile_agrees_with_cost_model(self):
        """The true-simulator replay (`simulate_profile`) and the analytic
        cost model must agree within §7's MODEL_TOLERANCE on rolling
        profiles too — the re-advise gate leans on the simulated number."""
        from repro_torch.core.sizing import (
            MODEL_TOLERANCE, CostModel, ModelConfig, simulate_profile,
        )

        rp = RollingProfile(window=4, decay=0.5)
        for _ in range(3):
            rp.append_wave(*_wave({"kv0": 300 * KIB, "kv1": 200 * KIB,
                                   "kv2": 120 * KIB}, compute_us=4000.0))
        profile = rp.profile()
        for n_nodes in (1, 2):
            cfg = ModelConfig(n_nodes=n_nodes, n_iters=4,
                              stripe_bytes=64 * KIB)
            for frac in (0.05, 0.25, 1.0):
                sim = simulate_profile(profile, local_fraction=frac,
                                       config=cfg)
                pred = CostModel(profile).predict(
                    local_fraction=frac, config=cfg).elapsed_us
                assert sim > 0
                err = abs(pred - sim) / sim
                assert err <= MODEL_TOLERANCE, (
                    f"n_nodes={n_nodes} f={frac}: model error {err:.3f}"
                )

    def test_validation(self):
        with pytest.raises(ValueError):
            RollingProfile(window=0)
        with pytest.raises(ValueError):
            RollingProfile(decay=0.0)
        rp = RollingProfile()
        with pytest.raises(ValueError):
            rp.append_wave([("warp", "x")], {})


# -- diff_plans -------------------------------------------------------------
def _catalog(sizes):
    return ObjectCatalog(
        DataObject(name=n, shape=(s,), dtype=np.uint8,
                   kind=ObjectKind.KV_CACHE, n_reads=1, n_writes=1)
        for n, s in sizes.items()
    )


class TestDiffPlans:
    def test_identical_plans_are_noop(self):
        cat = _catalog({"a": 1 * MIB, "b": 2 * MIB})
        p = PlacementPolicy().plan(cat, local_fraction=0.5)
        d = diff_plans(p, p)
        assert d.is_noop
        assert d.unchanged_remote == tuple(sorted(p.remote_names()))

    def test_tighter_budget_demotes_looser_promotes(self):
        cat = _catalog({"a": 1 * MIB, "b": 2 * MIB, "c": 4 * MIB})
        loose = PlacementPolicy().plan(cat, local_fraction=0.5)
        tight = PlacementPolicy().plan(cat, local_fraction=0.1)
        d = diff_plans(loose, tight)
        assert set(d.demote) == set(tight.remote_names()) - set(loose.remote_names())
        assert not d.promote
        back = diff_plans(tight, loose)
        assert set(back.promote) == set(d.demote)
        assert not back.demote

    def test_rehome_detected_without_data_move_semantics(self):
        cat = _catalog({"a": 2 * MIB, "b": 2 * MIB})
        one = PlacementPolicy().plan(cat, local_fraction=0.0, n_nodes=1)
        two = PlacementPolicy().plan(cat, local_fraction=0.0, n_nodes=2)
        d = diff_plans(one, two)
        assert not d.promote and not d.demote
        assert set(d.rehome) | set(d.unchanged_remote) == set(one.remote_names())

    def test_summary_counts(self):
        cat = _catalog({"a": 1 * MIB, "b": 2 * MIB, "c": 4 * MIB})
        loose = PlacementPolicy().plan(cat, local_fraction=0.9)
        tight = PlacementPolicy().plan(cat, local_fraction=0.05)
        s = diff_plans(loose, tight).summary()
        assert s["n_demote"] == len(diff_plans(loose, tight).demote)
        assert set(s) == {"n_promote", "n_demote", "n_rehome",
                          "n_unchanged_remote"}


# -- the engine loop --------------------------------------------------------
@pytest.fixture(scope="module")
def reference_setup():
    cfg = ref_reduced_config(ref_get_config("granite-8b"), dtype=jnp.float32)
    params = ref_get_model(cfg).init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params


@pytest.fixture(scope="module")
def autoscale_setup(reference_setup):
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    return cfg, params_from_reference(reference_setup[1], device="cpu")


def _autoscaled_engine(cfg, params, **over):
    total = P.param_bytes(params)
    kw = dict(readvise_every=2, window=6, decay=0.5,
              node_capacity_bytes=12 * KIB, min_nodes=1, max_nodes=4,
              compute_us_per_token=200.0)
    kw.update(over)
    return ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=64,
        hbm_budget_bytes=int(total * 0.2),
        pool_nodes=1, pool_stripe_bytes=64 * KIB,
        autoscale=AutoscaleConfig(**kw),
    ))


class TestEngineAutoscale:
    def test_outputs_stay_bit_identical_under_autoscaling(self, autoscale_setup):
        """The whole control loop — profiling, re-advice, pool resize with
        migration, plan diffing — must never change served tokens."""
        cfg, params = autoscale_setup
        eng = _autoscaled_engine(cfg, params)
        ref = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=64))
        for P in [3, 3, 40, 40, 40, 3, 3, 3]:
            prompts = (np.arange(2 * P, dtype=np.int32).reshape(2, P)
                       % cfg.vocab_size)
            out = eng.generate(prompts, max_new=4)
            expect = ref.generate(prompts, max_new=4)
            np.testing.assert_array_equal(out, expect)
            eng.reset()
            ref.reset()
        assert len(eng.autoscale_log) == 4  # every readvise_every=2 waves

    def test_pool_capacity_tracks_working_set(self, autoscale_setup):
        """Long-context waves grow the pool; after the mix drifts back the
        decayed working set lets the advisor shrink it again."""
        cfg, params = autoscale_setup
        eng = _autoscaled_engine(cfg, params)
        nodes = []
        for P in [3, 3, 44, 44, 44, 44, 3, 3, 3, 3, 3, 3]:
            prompts = np.array([np.arange(P) % cfg.vocab_size,
                                np.arange(P) % cfg.vocab_size], np.int32)
            eng.generate(prompts, max_new=4)
            eng.reset()
            if eng.autoscale_log and eng.autoscale_log[-1]["wave"] == eng._wave:
                nodes.append(eng.autoscale_log[-1]["n_alive"])
        peak = max(nodes)
        assert peak > nodes[0], f"pool never grew: {nodes}"
        assert nodes[-1] < peak, f"pool never shrank back: {nodes}"
        # drained nodes really retired, data still served
        assert eng.pool.stats()["n_retired"] > 0

    def test_degradation_stays_at_knee_when_feasible(self, autoscale_setup):
        cfg, params = autoscale_setup
        eng = _autoscaled_engine(cfg, params)
        for P in [3, 3, 40, 40, 3, 3]:
            prompts = np.array([np.arange(P) % cfg.vocab_size], np.int32)
            eng.generate(prompts, max_new=4)
            eng.reset()
        assert eng.autoscale_log
        for entry in eng.autoscale_log:
            if entry["feasible"]:
                assert (entry["resimulated_degradation"]
                        <= eng.ecfg.autoscale.degradation_target + 1e-9)

    def test_plan_diff_not_full_reoffload(self, autoscale_setup):
        """Steady-state waves must produce (near-)noop diffs — the engine
        moves only drifted objects, it does not re-offload the catalog."""
        cfg, params = autoscale_setup
        eng = _autoscaled_engine(cfg, params)
        for _ in range(6):
            prompts = np.array([[5, 9, 2]], np.int32)
            eng.generate(prompts, max_new=4)
            eng.reset()
        steady = eng.autoscale_log[-1]["diff"]
        assert steady["n_promote"] == 0 and steady["n_demote"] == 0
        assert steady["n_unchanged_remote"] > 0

    def test_resize_migrates_live_pool_entries(self, autoscale_setup):
        """Waves that accumulate context (no reset) keep demoted KV tiers in
        the pool across re-advise points, so a grow re-stripes *live* data —
        and generation output must remain correct throughout."""
        cfg, params = autoscale_setup
        total = P.param_bytes(params)
        eng = ServingEngine(cfg, params, EngineConfig(
            max_batch=2, max_len=64, hbm_budget_bytes=int(total * 0.2),
            pool_nodes=1, pool_stripe_bytes=8 * KIB,  # multi-extent tiers
            autoscale=AutoscaleConfig(readvise_every=2, window=6, decay=0.5,
                                      node_capacity_bytes=12 * KIB,
                                      max_nodes=8, compute_us_per_token=200.0),
        ))
        ref = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=64))
        prompts = np.array([[5, 9, 2, 7]], np.int32)
        for _ in range(6):
            out = eng.generate(prompts, max_new=4)
            expect = ref.generate(prompts, max_new=4)
            np.testing.assert_array_equal(out, expect)
        migrations = [e["migration"] for e in eng.autoscale_log
                      if e["migration"]]
        assert migrations, "growing working set never resized the pool"
        assert any(m.get("moved_extents", 0) > 0 for m in migrations)
        # the pool held live entries while those resizes migrated them
        assert any(e["pool_logical_bytes"] > 0 for e in eng.autoscale_log)

    def test_stats_exposes_autoscale_state(self, autoscale_setup):
        cfg, params = autoscale_setup
        eng = _autoscaled_engine(cfg, params)
        prompts = np.array([[5, 9, 2]], np.int32)
        eng.generate(prompts, max_new=3)
        eng.generate(prompts, max_new=3)
        s = eng.stats()["autoscale"]
        assert s["n_waves"] == 2 and s["n_readvise"] >= 1
        assert s["log"][-1]["advised_budget_bytes"] > 0


# -- parity with the reference's engine --------------------------------------
PKGS = (P.package("repro"), P.package("repro_torch"))
SCENARIOS = {
    # test_pool_capacity_tracks_working_set's mix, a reset after each wave:
    # the pool grows on the long waves and shrinks back
    "drift": dict(stripe=64 * KIB, acfg={}, reset=True,
                  lens=[3, 3, 44, 44, 44, 44, 3, 3, 3, 3, 3, 3]),
    # test_resize_migrates_live_pool_entries: context accumulates, so a
    # resize migrates live extents
    "accumulate": dict(stripe=8 * KIB, acfg={"max_nodes": 8}, reset=False,
                       lens=[4] * 6),
}


def _engine(S, cfg, params, scenario: dict):
    kw = dict(readvise_every=2, window=6, decay=0.5,
              node_capacity_bytes=12 * KIB, min_nodes=1, max_nodes=4,
              compute_us_per_token=200.0)
    kw.update(scenario["acfg"])
    return S.ServingEngine(cfg, params, S.EngineConfig(
        max_batch=2, max_len=64,
        hbm_budget_bytes=int(P.param_bytes(params) * 0.2),
        pool_nodes=1, pool_stripe_bytes=scenario["stripe"],
        autoscale=S.AutoscaleConfig(**kw),
    ))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscale_log_matches_reference(name, reference_setup,
                                         autoscale_setup):
    """The same waves through both engines: tokens equal every wave, and
    every re-advise entry (advice, re-simulated degradation, target nodes,
    plan diff, migration) ``==`` field by field, as is ``stats()``."""
    sc = SCENARIOS[name]
    P.restart_resource_names(*PKGS)  # one count per package
    ref = _engine(ref_serving, *reference_setup, sc)
    eng = _engine(P.package("repro_torch").serving, *autoscale_setup, sc)
    for k, plen in enumerate(sc["lens"]):
        prompts = ((np.arange(2 * plen, dtype=np.int32) + k).reshape(2, plen)
                   % eng.cfg.vocab_size)
        np.testing.assert_array_equal(eng.generate(prompts, max_new=4),
                                      ref.generate(prompts, max_new=4))
        if sc["reset"]:
            eng.reset()
            ref.reset()
    assert len(eng.autoscale_log) == len(ref.autoscale_log) > 0
    for got, want in zip(eng.autoscale_log, ref.autoscale_log):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == want[key], (want["wave"], key)
    if name == "accumulate":
        assert any((e["migration"] or {}).get("moved_extents", 0)
                   for e in ref.autoscale_log)
    got, want = eng.stats(), ref.stats()
    for key in ("cache_bytes", "pool", "experts", "autoscale"):
        assert got[key] == want[key], key


def test_bench_pr5_reproduced(autoscale_setup):
    """``benchmarks/fig_autoscale.py``'s loop through the port gives the
    committed ``BENCH_pr5.json``: nodes [1, 1, 6, 6, 6, 2, 1, 1, 1],
    max_degradation 0.11358461042131696, mean_saving 0.9939781242359848,
    9 re-advises, 0 migrated extents; every wave's tokens equal an
    untiered engine's (the loop asserts it)."""
    got = P.fig_autoscale(P.package("repro_torch"), *autoscale_setup)
    assert P.bench_mismatches(got["autoscale"], "BENCH_pr5") == []
    assert got["autoscale"] == P.committed("BENCH_pr5")
