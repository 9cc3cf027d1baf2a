"""Drivers shared by the port's runtime, pool and HPC tests and by
``chip_smoke.py``'s ``[hpc]`` phase. Not a test module.

Each is a copy of one of the reference's benchmark loops
(``benchmarks/run.py::bench_json``, ``benchmarks/fig_alloc_churn.py``,
``benchmarks/fig7_workloads.py``, ``benchmarks/fig_pool_scaling.py``) with
the package it drives as an argument, so that one loop runs through the JAX
reference (``package("repro")``) and through the port
(``package("repro_torch")``) on the same seeds. Output files and wall-clock
prints are left out. This module imports neither package itself, so that
``chip_smoke.py`` runs the port through it on a machine without JAX.
"""
from __future__ import annotations

import hashlib
import importlib
import itertools
import json
import pathlib
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_KEYS = ("oracle_elapsed_us", "legacy_elapsed_us",
              "pipeline_elapsed_us", "pipeline_speedup")
CHURN_KEYS = ("max_frag_ratio", "final_frag_ratio", "n_compactions",
              "n_resizes", "verified_reads")


def package(name: str) -> types.SimpleNamespace:
    """``core`` and ``hpc`` of ``name`` ("repro" or "repro_torch")."""
    return types.SimpleNamespace(
        name=name, core=importlib.import_module(f"{name}.core"),
        hpc=importlib.import_module(f"{name}.hpc"))


def committed(bench: str) -> dict:
    """A committed ``BENCH_*.json`` of the reference."""
    return json.loads((ROOT / f"{bench}.json").read_text())


# -- benchmarks/run.py::bench_json (BENCH_pr3.json) --------------------------

def bench_pr3(pkg) -> dict[str, dict[str, float]]:
    """Per workload: the oracle's, the legacy dual buffer's and the
    trace-driven pipeline's simulated elapsed µs and the pipeline's
    speedup, at 5 % local memory; the oracle's checksum beside them. Both
    tiered legs must give the oracle's checksum."""
    core, hpc = pkg.core, pkg.hpc
    scale = 0.2
    sim_scale = 1000.0 / scale
    fraction = 0.05
    n_iters = 10

    def tiered(**kw):
        return core.DolmaRuntime(
            local_fraction=fraction, sim_scale=sim_scale,
            policy=core.PlacementPolicy(all_large_remote=True), **kw)

    rows = {}
    for name, cls in hpc.WORKLOADS.items():
        oracle = hpc.run_workload(
            cls(scale=scale, seed=3),
            core.DolmaRuntime(local_fraction=1.0, sim_scale=sim_scale),
            n_iters)
        legacy = hpc.run_workload(cls(scale=scale, seed=3),
                                  tiered(dual_buffer=True), n_iters)
        # the pipeline leg runs with telemetry on, as the reference's does
        pipe = hpc.run_workload(
            cls(scale=scale, seed=3),
            tiered(pipeline=True, telemetry=core.Telemetry()), n_iters)
        assert legacy.checksum == oracle.checksum, name
        assert pipe.checksum == oracle.checksum, name
        rows[name] = {
            "oracle_elapsed_us": oracle.elapsed_us,
            "legacy_elapsed_us": legacy.elapsed_us,
            "pipeline_elapsed_us": pipe.elapsed_us,
            "pipeline_speedup": legacy.elapsed_us / max(pipe.elapsed_us,
                                                        1e-9),
            "checksum": oracle.checksum,
        }
    return rows


# -- every runtime mode of one workload ---------------------------------------

MODES = ("oracle", "legacy", "pipeline", "auto", "pooled")


def run_mode(pkg, name: str, mode: str, *, scale: float = 0.1,
             n_iters: int = 3, seed: int = 5):
    """One workload under one runtime mode, at a small scale: the oracle
    (all local), the legacy dual buffer and the pipeline at 5 % local
    memory, the sizing solver's ``"auto"`` budget, and a pipelined run on a
    4-node pool with 2 replicas. Returns the ``WorkloadResult``.

    A fabric resource is named after a count kept for the whole process
    (``qp0``, ``qp1``, ...), and ``stats()`` reports the names; the count
    starts again here, so that the names do not depend on what ran before
    in the process."""
    core, hpc = pkg.core, pkg.hpc
    core.FabricResource._ids = itertools.count()
    sim = 1000.0 / scale
    remote = core.PlacementPolicy(all_large_remote=True)
    rt = {
        "oracle": lambda: core.DolmaRuntime(local_fraction=1.0,
                                            sim_scale=sim),
        "legacy": lambda: core.DolmaRuntime(local_fraction=0.05,
                                            sim_scale=sim, policy=remote),
        "pipeline": lambda: core.DolmaRuntime(
            local_fraction=0.05, sim_scale=sim, policy=remote,
            pipeline=True),
        "auto": lambda: core.DolmaRuntime(local_fraction="auto",
                                          sim_scale=sim),
        "pooled": lambda: hpc.pooled_runtime(
            4, replication=2, local_fraction=0.2, sim_scale=sim,
            pipeline=True),
    }[mode]()
    return hpc.run_workload(hpc.WORKLOADS[name](scale=scale, seed=seed), rt,
                            n_iters)


# -- benchmarks/fig_alloc_churn.py (BENCH_pr7.json) --------------------------

KIB = 1 << 10
STRIPE = 32 * KIB
FRAG_BOUND = 0.10
ARENAS = ("hpc", "serving")
MIN_LIVE, MAX_LIVE = 240, 420
MIN_OBJ, MAX_OBJ = 2 * KIB, 64 * KIB


def _steady_state_plan(pkg, pool, oracle: dict):
    """Slab-aware plan over the live set with measured fragmentation."""
    core = pkg.core
    alive = [n.node_id for n in pool.alive_nodes()]
    frag = {nid: float(pool._allocator.node_stats(nid)["frag_bytes"])
            for nid in alive}
    catalog = core.ObjectCatalog([
        core.DataObject(name=n, shape=a.shape, dtype=a.dtype, n_reads=1)
        for n, a in sorted(oracle.items())])
    return core.PlacementPolicy().plan(
        catalog, local_budget_bytes=0, n_nodes=len(alive),
        stripe_bytes=pool.stripe_bytes, node_frag_bytes=frag)


def alloc_churn(pkg, rounds: int = 10_000) -> dict:
    """Random alloc / free / resize / write / read rounds from two tenant
    arenas on a 3-node pool, with pool resizes and compaction every tenth
    of the run; every read is held to a flat numpy oracle. Returns the
    churn record (``BENCH_pr7.json``'s keys but ``ops_per_s``) and the
    fragmentation ratio at each compaction."""
    core = pkg.core
    compact_every = max(rounds // 10, 1)
    resize_every = max(rounds // 8, 1)
    rng = np.random.default_rng(7)
    pool = core.MemoryPool(3, stripe_bytes=STRIPE, replication=1,
                           telemetry=core.Telemetry())
    oracle: dict[str, np.ndarray] = {}
    arena_of: dict[str, str] = {}
    next_id = 0
    frag_ratios: list[float] = []
    n_resizes = n_compactions = verified_reads = 0
    grow_next = True

    def new_object() -> None:
        nonlocal next_id
        arena = ARENAS[int(rng.integers(len(ARENAS)))]
        name = f"{arena}_{next_id}"
        next_id += 1
        nbytes = int(rng.integers(MIN_OBJ, MAX_OBJ + 1))
        data = rng.integers(0, 256, size=nbytes, dtype=np.uint8)
        pool.alloc(name, data, client=arena)
        oracle[name] = data.copy()
        arena_of[name] = arena

    def verify(name: str) -> None:
        nonlocal verified_reads
        got, _end = pool.read_object(name)
        assert np.array_equal(got, oracle[name]), name
        verified_reads += 1

    for r in range(1, rounds + 1):
        live = list(oracle)
        op = rng.random()
        if len(live) < MIN_LIVE or (op < 0.35 and len(live) < MAX_LIVE):
            new_object()
        elif op < 0.55:
            name = str(rng.choice(live))
            pool.free(name)
            del oracle[name]
            del arena_of[name]
        elif op < 0.70:
            name = str(rng.choice(live))
            arena = arena_of[name]
            pool.free(name)
            nbytes = int(rng.integers(MIN_OBJ, MAX_OBJ + 1))
            data = rng.integers(0, 256, size=nbytes, dtype=np.uint8)
            pool.alloc(name, data, client=arena)
            oracle[name] = data.copy()
        elif op < 0.85:
            name = str(rng.choice(live))
            data = rng.integers(0, 256, size=oracle[name].nbytes,
                                dtype=np.uint8)
            pool.write(name, data, sync=True)
            oracle[name] = data.copy()
        else:
            verify(str(rng.choice(live)))

        if r % resize_every == 0:
            alive = [n.node_id for n in pool.alive_nodes()]
            if grow_next or len(alive) <= 2:
                pool.add_nodes(1)
            else:
                pool.drain_nodes([max(alive)])
            grow_next = not grow_next
            n_resizes += 1
            pool.check_no_orphans()

        if r % compact_every == 0:
            plan_before = _steady_state_plan(pkg, pool, oracle)
            stats = pool.compact()
            n_compactions += 1
            assert (stats["external_frag_after"]
                    <= stats["external_frag_before"] + 1e-9), r
            fs = pool.fragmentation_stats()
            ratio = (fs["external_frag_bytes"] / fs["live_bytes"]
                     if fs["live_bytes"] else 0.0)
            frag_ratios.append(ratio)
            assert ratio <= FRAG_BOUND, (r, ratio)
            plan_after = _steady_state_plan(pkg, pool, oracle)
            assert core.diff_plans(plan_before, plan_after).is_noop, r
            pool.check_no_orphans()
            for name in rng.choice(list(oracle), size=min(32, len(oracle)),
                                   replace=False):
                verify(str(name))

    pool.compact()
    final = pool.compact()
    assert final["compacted_extents"] == 0 and final["moved_extents"] == 0
    for name in list(oracle):
        verify(name)
    pool.check_no_orphans()
    fs = pool.fragmentation_stats()
    return {
        "rounds": rounds,
        "frag_bound": FRAG_BOUND,
        "max_frag_ratio": max(frag_ratios),
        "final_frag_ratio": (fs["external_frag_bytes"] / fs["live_bytes"]
                             if fs["live_bytes"] else 0.0),
        "n_resizes": n_resizes,
        "n_compactions": n_compactions,
        "verified_reads": verified_reads,
        "live_objects": len(oracle),
        "live_bytes": fs["live_bytes"],
        "internal_frag_bytes": fs["internal_frag_bytes"],
        "external_frag_bytes": fs["external_frag_bytes"],
        "frag_ratios": frag_ratios,
    }


# -- benchmarks/fig7_workloads.py: the paper's headline ----------------------

FIG7_FRACTIONS = [0.01, 0.05, 0.2, 0.5, 0.7, 1.0]
FIG7_AVG_SAVING = 0.5712500000205911  # the reference's, on this sweep
FIG7_SCALE = 0.3
FIG7_ITERS = 5


def fig7(pkg) -> dict:
    """Each workload at {1, 5, 20, 50, 70, 100} % local memory on the
    InfiniBand model against its all-local oracle; per workload the largest
    memory saving at no more than 16 % slowdown, and their average."""
    core, hpc = pkg.core, pkg.hpc
    sim_scale = 1000.0 / FIG7_SCALE
    table, summary = {}, []
    for name, cls in hpc.WORKLOADS.items():
        oracle = hpc.run_workload(
            cls(scale=FIG7_SCALE, seed=1),
            core.DolmaRuntime(local_fraction=1.0, sim_scale=sim_scale),
            FIG7_ITERS)
        rows = []
        for frac in FIG7_FRACTIONS:
            rt = core.DolmaRuntime(
                local_fraction=frac, fabric=core.INFINIBAND_100G,
                dual_buffer=True, sim_scale=sim_scale,
                policy=core.PlacementPolicy(all_large_remote=(frac < 1.0)))
            res = hpc.run_workload(cls(scale=FIG7_SCALE, seed=1), rt,
                                   FIG7_ITERS)
            assert abs(res.checksum - oracle.checksum) <= 1e-6 * max(
                abs(oracle.checksum), 1e-9), (name, frac)
            rows.append({
                "fraction": frac,
                "elapsed_us": res.elapsed_us,
                "slowdown": res.elapsed_us / max(oracle.elapsed_us, 1e-9),
                "local_capacity_bytes": res.stats["local_capacity_bytes"],
                "peak_local_bytes": res.stats["peak_local_bytes"],
                "memory_saving": 1.0 - min(
                    res.stats["local_capacity_bytes"]
                    / res.stats["plan"]["peak_bytes"], 1.0),
            })
        table[name] = {"oracle_us": oracle.elapsed_us, "rows": rows}
        ok = [r for r in rows if r["slowdown"] <= 1.16]
        best = max(ok, key=lambda r: r["memory_saving"]) if ok else None
        summary.append({
            "workload": name,
            "best_saving_at_16pct": best["memory_saving"] if best else 0.0,
            "at_fraction": best["fraction"] if best else None,
        })
    return {"table": table, "summary": summary,
            "avg_saving_at_16pct_slowdown": float(np.mean(
                [s["best_saving_at_16pct"] for s in summary]))}


# -- benchmarks/fig_pool_scaling.py -------------------------------------------

MIB = 1 << 20
POOL_NODE_COUNTS = (1, 2, 4, 8)
POOL_STRIPES = (256 * KIB, 1 * MIB, 4 * MIB)


def _blob(nbytes: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, size=nbytes,
                                                dtype=np.uint8)


def _pool_workload(pool, *, kill_node: int | None, recover: bool) -> dict:
    """Read/modify/write over four striped objects for four iterations; a
    node is killed halfway (and, optionally, the pool recovers)."""
    objs = {f"obj{i}": _blob(4 * MIB, seed=10 + i) for i in range(4)}
    for name, data in objs.items():
        pool.alloc(name, data)
    state = {name: data.copy() for name, data in objs.items()}
    recovery_us = 0.0
    for it in range(4):
        if kill_node is not None and it == 2:
            pool.fail_node(kill_node, timeline="main")
            if recover:
                recovery_us = pool.recover()["recovery_us"]
        for name in objs:
            data, _t = pool.read_object(name, timeline="main")
            data = (data.astype(np.uint16) + 1).astype(np.uint8)
            state[name] = data
            pool.write(name, data, timeline="main")
    pool.fence(timeline="main")
    digest = hashlib.sha1(np.concatenate(
        [state[n] for n in sorted(state)]).tobytes()).hexdigest()
    return {"elapsed_us": pool.clock.now("main"), "checksum": digest,
            "recovery_us": recovery_us}


def pool_scaling(pkg) -> dict:
    """Striped reads of a 32 MiB object over 1-8 nodes at three stripe
    widths (4 nodes must read more than twice as fast as one), and a
    4-node pool with 2 replicas losing a node: its checksums must equal
    the clean run's."""
    core = pkg.core
    raw = _blob(32 * MIB)
    bandwidth = {}
    for stripe in POOL_STRIPES:
        per_nodes = {}
        for n in POOL_NODE_COUNTS:
            pool = core.MemoryPool(n, fabric=core.INFINIBAND_100G,
                                   stripe_bytes=stripe)
            pool.alloc("blob", raw)
            _data, end = pool.read("blob", issue_at_us=0.0, sync=False)
            per_nodes[n] = {"read_us": end,
                            "eff_gbps": round(32 * MIB / (end * 1e3), 3)}
        for n in POOL_NODE_COUNTS:
            per_nodes[n]["scaling_x"] = round(
                per_nodes[n]["eff_gbps"] / per_nodes[1]["eff_gbps"], 2)
        assert per_nodes[4]["scaling_x"] > 2.0, (stripe, per_nodes[4])
        bandwidth[f"stripe_{stripe // KIB}k"] = per_nodes

    def mk():
        return core.MemoryPool(4, fabric=core.INFINIBAND_100G,
                               stripe_bytes=1 * MIB, replication=2)

    clean = _pool_workload(mk(), kill_node=None, recover=False)
    degraded = _pool_workload(mk(), kill_node=1, recover=False)
    recovered = _pool_workload(mk(), kill_node=1, recover=True)
    assert degraded["checksum"] == clean["checksum"]
    assert recovered["checksum"] == clean["checksum"]
    return {"bandwidth": bandwidth, "clean": clean, "degraded": degraded,
            "recovered": recovered}
