"""Serving loops shared by the port's serving tests and by ``chip_smoke.py``'s
``[serving-bench]`` phase. Not a test module.

Each is a copy of one of the reference's benchmark loops
(``benchmarks/fig_autoscale.py``, ``benchmarks/fig_serving_mt.py``) with the
package it drives and the model it serves as arguments, so that one loop
runs through the JAX reference (``package("repro")``) and through the port
(``package("repro_torch")``). Output files, trace export and prints are
left out; the loops' own asserts are kept. The numbers they return are
numpy (the pool, the sizing advisor, the admission controller) and depend
only on the model's shapes and the decode positions, so the committed
``BENCH_pr5.json`` and ``BENCH_pr9.json`` hold for any weights; the served
tokens are held against an untiered engine and a sequential oracle on the
same weights. This module imports neither package itself, so that
``chip_smoke.py`` runs the port through it on a machine without JAX.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import pathlib
import types
from typing import Any

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
KIB = 1 << 10
DEGRADATION_TARGET = 0.16
# BENCH_pr9.json's wall-clock entry, not compared
WALL_CLOCK_KEYS = ("latency_us",)


def package(name: str) -> types.SimpleNamespace:
    """``core`` and ``serving`` of ``name`` ("repro" or "repro_torch")."""
    return types.SimpleNamespace(
        name=name, core=importlib.import_module(f"{name}.core"),
        serving=importlib.import_module(f"{name}.serving"))


def restart_resource_names(*pkgs) -> None:
    """Restart the count that names fabric resources (``qp0``, ``qp1``,
    ...; one count for the whole process) in each package: the pool's
    ``stats()`` reports the names, so two engines compared field by field
    must be made after the same restart."""
    for pkg in pkgs:
        pkg.core.FabricResource._ids = itertools.count()


def committed(bench: str) -> dict:
    """A committed ``BENCH_*.json`` of the reference."""
    return json.loads((ROOT / f"{bench}.json").read_text())


def param_bytes(tree: Any) -> int:
    """Bytes of a nested dict of arrays or tensors (``.nbytes`` of each)."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return int(tree.nbytes)


# -- benchmarks/fig_autoscale.py (BENCH_pr5.json) -----------------------------

AUTOSCALE_SHORT_P, AUTOSCALE_LONG_P = 3, 44
AUTOSCALE_MAX_NEW = 4


def _autoscale_phases(smoke: bool) -> list[tuple[str, int, int]]:
    """(phase, prompt_len, n_waves) — the drifting request mix."""
    if smoke:
        return [("short", AUTOSCALE_SHORT_P, 2), ("long", AUTOSCALE_LONG_P, 2),
                ("short", AUTOSCALE_SHORT_P, 4)]
    return [("short", AUTOSCALE_SHORT_P, 4), ("long", AUTOSCALE_LONG_P, 6),
            ("short", AUTOSCALE_SHORT_P, 8)]


def fig_autoscale(pkg, cfg, params, *, smoke: bool = False) -> dict:
    """The autoscaler under a short → long-context → short request mix:
    the reference's payload (``"autoscale"`` is ``BENCH_pr5.json``'s
    contract, ``"points"`` the re-advise entries). Every wave's tokens must
    equal an untiered engine's."""
    S = pkg.serving
    total = param_bytes(params)
    acfg = S.AutoscaleConfig(
        readvise_every=2,
        degradation_target=DEGRADATION_TARGET,
        window=6,
        decay=0.5,
        # sized so the max_nodes clamp never binds for this mix: the long
        # phase peaks at ~6 nodes of advised remote KV working set
        node_capacity_bytes=16 * KIB,
        min_nodes=1,
        max_nodes=8,
        compute_us_per_token=200.0,
    )
    eng = S.ServingEngine(cfg, params, S.EngineConfig(
        max_batch=2, max_len=64,
        hbm_budget_bytes=int(total * 0.2),
        pool_nodes=1, pool_stripe_bytes=64 * KIB,
        autoscale=acfg,
    ))
    ref = S.ServingEngine(cfg, params, S.EngineConfig(max_batch=2, max_len=64))

    points: list[dict] = []
    wave = 0
    for phase, plen, n_waves in _autoscale_phases(smoke):
        for _ in range(n_waves):
            wave += 1
            prompts = (np.arange(2 * plen, dtype=np.int32).reshape(2, plen)
                       % cfg.vocab_size)
            out = eng.generate(prompts, max_new=AUTOSCALE_MAX_NEW)
            expect = ref.generate(prompts, max_new=AUTOSCALE_MAX_NEW)
            assert np.array_equal(out, expect), (
                f"wave {wave}: autoscaled tokens diverged from untiered"
            )
            eng.reset()
            ref.reset()
            if eng.autoscale_log and eng.autoscale_log[-1]["wave"] == wave:
                entry = dict(eng.autoscale_log[-1])
                entry["phase"] = phase
                points.append(entry)

    assert points, "autoscaler never re-advised"
    for p in points:
        deg = p["resimulated_degradation"]
        assert p["feasible"], (
            f"wave {p['wave']}: advisor found no feasible budget"
        )
        assert deg <= DEGRADATION_TARGET + 1e-9, (
            f"wave {p['wave']}: re-simulated degradation {deg:.3f} "
            f"> {DEGRADATION_TARGET}"
        )
        # installed capacity covers the advised remote working set
        capacity = p["n_alive"] * acfg.node_capacity_bytes
        assert capacity >= p["remote_kv_bytes"], (
            f"wave {p['wave']}: capacity {capacity} < advised working set "
            f"{p['remote_kv_bytes']}"
        )

    nodes = [p["n_alive"] for p in points]
    long_peak = max(p["n_alive"] for p in points if p["phase"] == "long")
    first_short = points[0]["n_alive"]
    assert long_peak > first_short, (
        f"pool never grew on long-context waves: {nodes}"
    )
    assert nodes[-1] < long_peak, (
        f"pool never shrank after the burst aged out: {nodes}"
    )
    migrated = sum((p["migration"] or {}).get("moved_extents", 0)
                   for p in points)
    max_deg = max(p["resimulated_degradation"] for p in points)
    mean_saving = sum(p["memory_saving"] for p in points) / len(points)
    return {
        "autoscale": {
            "degradation_target": DEGRADATION_TARGET,
            "max_degradation": max_deg,
            "mean_saving": mean_saving,
            "nodes_trajectory": nodes,
            "peak_nodes": long_peak,
            "final_nodes": nodes[-1],
            "migrated_extents": migrated,
            "n_readvise": len(points),
            "smoke": smoke,
        },
        "points": points,
    }


# -- benchmarks/fig_serving_mt.py (BENCH_pr9.json) ----------------------------

MT_SHORT_P, MT_LONG_P = 3, 40
MT_SHORT_NEW, MT_LONG_NEW = 4, 8


def _mt_phases(smoke: bool) -> list[tuple[str, dict[str, tuple[int, int, int]], int]]:
    """(phase, {tenant: (prompt_len, max_new, n_requests)}, n_rounds)."""
    warm = {"acme": (MT_SHORT_P, MT_SHORT_NEW, 2),
            "blue": (MT_SHORT_P, MT_SHORT_NEW, 2)}
    burst = {
        "acme": (MT_SHORT_P, MT_SHORT_NEW, 2),
        "blue": (MT_SHORT_P, MT_SHORT_NEW, 2),
        "crest": (MT_LONG_P, MT_LONG_NEW, 2),
    }
    cool = {"acme": (MT_SHORT_P, MT_SHORT_NEW, 1),
            "blue": (MT_SHORT_P, MT_SHORT_NEW, 1)}
    if smoke:
        return [("warm", warm, 1), ("burst", burst, 2), ("cool", cool, 3)]
    return [("warm", warm, 2), ("burst", burst, 3), ("cool", cool, 6)]


def make_prompt(tenant: str, k: int, plen: int, vocab: int) -> np.ndarray:
    """Deterministic per-request prompt (tenant- and index-salted)."""
    salt = sum(ord(c) for c in tenant) * 31 + k * 7
    return ((np.arange(plen, dtype=np.int32) * 13 + salt) % (vocab - 1)) + 1


def _mt_drive(S, sched, smoke: bool, vocab: int) -> list[tuple[str, Any]]:
    """Run the drifting mix through ``sched``; returns submissions in order."""
    submitted = []
    k = 0
    for phase, mix, n_rounds in _mt_phases(smoke):
        for _ in range(n_rounds):
            for tenant in sorted(mix):
                plen, max_new, n_req = mix[tenant]
                for _i in range(n_req):
                    k += 1
                    req = S.Request(
                        tenant=tenant,
                        prompt=make_prompt(tenant, k, plen, vocab),
                        max_new=max_new,
                    )
                    submitted.append((phase, req))
                    sched.submit(dataclasses.replace(req))
            for _s in range(sched.scfg.readvise_every):
                sched.step()
    sched.drain(max_steps=5000)
    # idle re-advises: the drained working set decays out of the rolling
    # profiles and the pool scales back down (the scale-in half of the loop)
    for _ in range(4):
        sched.readvise()
    return submitted


def _mt_build(S, cfg, params, telemetry=None):
    total = param_bytes(params)
    eng = S.ServingEngine(
        cfg, params,
        S.EngineConfig(
            max_batch=4, max_len=64,
            hbm_budget_bytes=int(total * 0.2),
            pool_nodes=1, pool_stripe_bytes=4 * KIB,
        ),
        telemetry=telemetry,
    )
    scfg = S.SchedulerConfig(
        readvise_every=6,
        degradation_target=DEGRADATION_TARGET,
        window=4, decay=0.5,
        # sized so the burst's three-tenant working set cannot fit the
        # max_nodes clamp (forcing a shed) while any two tenants can
        node_capacity_bytes=16 * KIB,
        min_nodes=1, max_nodes=6,
        compute_us_per_token=200.0,
    )
    return eng, scfg


def fig_serving_mt(pkg, cfg, params, *, smoke: bool = False) -> dict:
    """Three tenants at one lane-mode engine under cost-model admission:
    the reference's payload (``"serving_mt"`` is ``BENCH_pr9.json``'s
    contract, ``"admission_log"`` every admission pass). Every request's
    tokens must equal the same request run alone through a fresh engine at
    the same batch shape."""
    S = pkg.serving
    eng, scfg = _mt_build(S, cfg, params)
    sched = S.ContinuousScheduler(eng, scfg)
    # compile outside the measured mix: free lanes only, reset on grant
    eng.decode_lanes(np.zeros(eng.ecfg.max_batch, np.int32))

    submitted = _mt_drive(S, sched, smoke, cfg.vocab_size)
    results = sched.results()
    lat = sched.latency_stats()
    log = sched.admission_log

    n_done = sum(len(rs) for rs in results.values())
    assert n_done == len(submitted), (
        f"{len(submitted) - n_done} requests never completed "
        f"(shed work not re-admitted?)"
    )
    assert log, "admission controller never ran"

    # per-tenant SLO, audited at every admission point
    max_admitted_deg = 0.0
    for entry in log:
        for tenant, row in entry["tenants"].items():
            if not row["admitted"] or row["advised_budget_bytes"] is None:
                continue
            deg = row["resim_degradation"]
            max_admitted_deg = max(max_admitted_deg, deg)
            assert deg <= DEGRADATION_TARGET + 1e-9, (
                f"step {entry['step']}: admitted tenant {tenant} "
                f"re-simulated degradation {deg:.3f} > {DEGRADATION_TARGET}"
            )
        capacity = entry["n_alive"] * scfg.node_capacity_bytes
        admitted_bytes = sum(
            row["remote_kv_bytes"] for row in entry["tenants"].values()
            if row["admitted"]
        )
        assert capacity >= admitted_bytes, (
            f"step {entry['step']}: capacity {capacity} < admitted working "
            f"set {admitted_bytes}"
        )

    shed_events = [t for entry in log for t in entry["shed"]]
    assert shed_events, "burst never forced a shed — admission is inert"
    shed_tenant = shed_events[0]
    assert results.get(shed_tenant), (
        f"shed tenant {shed_tenant} never completed any request"
    )

    nodes = [entry["n_alive"] for entry in log]
    assert max(nodes) > nodes[0], f"pool never grew on the burst: {nodes}"
    assert nodes[-1] < max(nodes), (
        f"pool never shrank after the burst decayed: {nodes}"
    )

    # bit-identity: every request run alone through a fresh engine
    oracle_eng, _ = _mt_build(S, cfg, params)
    oracle = S.ContinuousScheduler(oracle_eng, scfg)
    oracle_eng.decode_lanes(np.zeros(oracle_eng.ecfg.max_batch, np.int32))
    expect: dict[str, np.ndarray] = {}
    for _phase, req in submitted:
        rid = oracle.submit(dataclasses.replace(req))
        oracle.drain(max_steps=5000)
        done = oracle.tenants[req.tenant].completed[-1]
        assert done["request_id"] == rid
        expect[rid] = done["tokens"]
    mismatched = [
        r["request_id"]
        for rs in results.values() for r in rs
        if not np.array_equal(expect[r["request_id"]], r["tokens"])
    ]
    assert not mismatched, (
        f"tokens diverged from the sequential oracle: {mismatched}"
    )

    contract = {
        "degradation_target": DEGRADATION_TARGET,
        "max_admitted_degradation": max_admitted_deg,
        "nodes_trajectory": nodes,
        "shed_events": shed_events,
        "n_readvise": len(log),
        "n_requests": n_done,
        "completed": {t: len(rs) for t, rs in results.items()},
        "bit_identical": not mismatched,
        "latency_us": {
            t: {"p50_step_us": lat[t]["p50_step_us"],
                "p99_step_us": lat[t]["p99_step_us"]}
            for t in sorted(lat)
        },
        "smoke": smoke,
    }
    return {"serving_mt": contract, "admission_log": log}


def bench_mismatches(got: dict, bench: str) -> list[str]:
    """Keys of the committed ``bench`` whose value ``got`` does not equal
    (the wall-clock ``latency_us`` aside)."""
    want = committed(bench)
    return [k for k in sorted(set(want) | set(got))
            if k not in WALL_CLOCK_KEYS and got.get(k) != want.get(k)]
