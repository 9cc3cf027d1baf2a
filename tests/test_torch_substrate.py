"""The port's numpy/stdlib substrate against the reference: exact equality.

Placement, the fabric model and its calibration, the simulated clock and
telemetry are copies in ``repro_torch``; the same inputs must give the same
plans, times and traces, number for number.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import fabric as ref_fabric
from repro.core import objects as ref_objects
from repro.core import placement as ref_placement
from repro.core import telemetry as ref_telemetry
from repro_torch.core import fabric as pt_fabric
from repro_torch.core import objects as pt_objects
from repro_torch.core import placement as pt_placement
from repro_torch.core import telemetry as pt_telemetry


def _catalog(mod, seed: int, n: int = 40):
    """A seeded census: mixed sizes, access counts, lifetimes and pins."""
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n):
        objs.append(mod.DataObject(
            name=f"obj{i:03d}",
            shape=(int(rng.integers(1, 1 << 12)), int(rng.integers(1, 64))),
            dtype=np.float32 if i % 3 else np.float16,
            kind=mod.ObjectKind.PARAM,
            n_reads=int(rng.integers(0, 8)),
            n_writes=int(rng.integers(0, 4)),
            lifetime_iters=math.inf if i % 7 else 0,
            pinned_local=(i % 11 == 0),
            pinned_remote=(i % 13 == 5),
        ))
    return mod.ObjectCatalog(objs)


def _plan_fields(plan):
    return (
        {k: t.value for k, t in plan.tiers.items()},
        plan.local_bytes, plan.remote_bytes, plan.peak_bytes,
        plan.budget_bytes, dict(plan.node_of), dict(plan.node_load),
        plan.n_nodes, plan.summary(),
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("local_fraction", [0.0, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("n_nodes,capacity", [(1, None), (3, None),
                                              (4, 1 << 20)])
def test_placement_plans_identical(seed, local_fraction, n_nodes, capacity):
    kw = dict(local_fraction=local_fraction, n_nodes=n_nodes,
              node_capacity_bytes=capacity)
    ref = ref_placement.PlacementPolicy().plan(_catalog(ref_objects, seed), **kw)
    got = pt_placement.PlacementPolicy().plan(_catalog(pt_objects, seed), **kw)
    assert _plan_fields(got) == _plan_fields(ref)


def test_fig7_mode_and_frag_identical():
    kw = dict(local_budget_bytes=1 << 18, n_nodes=2,
              node_capacity_bytes=3 << 20, node_frag_bytes={0: 1 << 19})
    ref = ref_placement.PlacementPolicy(all_large_remote=True).plan(
        _catalog(ref_objects, 3), **kw)
    got = pt_placement.PlacementPolicy(all_large_remote=True).plan(
        _catalog(pt_objects, 3), **kw)
    assert _plan_fields(got) == _plan_fields(ref)
    diff_ref = ref_placement.diff_plans(
        ref, ref_placement.PlacementPolicy().plan(_catalog(ref_objects, 3),
                                                  local_fraction=0.3))
    diff_got = pt_placement.diff_plans(
        got, pt_placement.PlacementPolicy().plan(_catalog(pt_objects, 3),
                                                 local_fraction=0.3))
    assert diff_got == pt_placement.PlanDiff(*diff_ref.__dict__.values())


def test_torch_dtype_sizes_and_census():
    for tdt, ndt in ((torch.bfloat16, np.float16), (torch.float32, np.float32),
                     (torch.uint8, np.uint8), (torch.int64, np.int64)):
        a = pt_objects.DataObject("a", (7, 5), tdt)
        b = ref_objects.DataObject("a", (7, 5), ndt)
        assert a.size_bytes == b.size_bytes
    assert _catalog(pt_objects, 4).census() == _catalog(ref_objects, 4).census()


def test_from_pytree_names_match_reference():
    tree = {"layers": {"b": np.zeros((3, 4), np.float32),
                       "a": [np.zeros(8, np.float16), np.zeros((2, 2))]},
            "embed": np.zeros((16, 4), np.float32)}
    ref = ref_objects.ObjectCatalog.from_pytree(tree, prefix="p")
    got = pt_objects.ObjectCatalog.from_pytree(tree, prefix="p")
    assert got.names() == ref.names()
    assert [o.size_bytes for o in got] == [o.size_bytes for o in ref]
    as_torch = {"layers": {"b": torch.zeros((3, 4)),
                           "a": [torch.zeros(8, dtype=torch.float16),
                                 torch.zeros((2, 2), dtype=torch.float64)]},
                "embed": torch.zeros((16, 4))}
    got_t = pt_objects.ObjectCatalog.from_pytree(as_torch, prefix="p")
    assert got_t.names() == ref.names()
    assert [o.size_bytes for o in got_t] == [o.size_bytes for o in ref]


@pytest.mark.parametrize("kind", ["read", "write"])
@pytest.mark.parametrize("mode", ["pipelined", "windowed", "serial"])
def test_stream_us_identical(kind, mode):
    for model_name in ("INFINIBAND_100G",):
        ref_m = getattr(ref_fabric, model_name)
        got_m = getattr(pt_fabric, model_name)
        for size in (0, 1, 4096, 1 << 20, 3 << 22, 1 << 30):
            for chunk in (4096, 1 << 20, 4 << 20):
                assert got_m.stream_us(kind, size, chunk, mode=mode) == \
                    ref_m.stream_us(kind, size, chunk, mode=mode)
        assert got_m.scaled(3.5).stream_us(kind, 1 << 24, 1 << 22,
                                           mode=mode) == \
            ref_m.scaled(3.5).stream_us(kind, 1 << 24, 1 << 22, mode=mode)


def _sweep(seed):
    rng = np.random.default_rng(seed)
    out = []
    for kind in ("read", "write"):
        for size in (1 << 18, 1 << 20, 4 << 20, 16 << 20):
            for _ in range(2):
                out.append((kind, size, float(10 + size / 2e3
                                              + rng.uniform(0, 50))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_fabric_model_identical(seed):
    ms = _sweep(seed)
    ref = ref_fabric.fit_fabric_model(ms, base=ref_fabric.INFINIBAND_100G)
    got = pt_fabric.fit_fabric_model(ms, base=pt_fabric.INFINIBAND_100G)
    assert got.__dict__ == ref.__dict__
    qp_ref = ref_fabric.FabricResource(ref_fabric.SimClock(),
                                       ref_fabric.INFINIBAND_100G)
    qp_got = pt_fabric.FabricResource(pt_fabric.SimClock(),
                                      pt_fabric.INFINIBAND_100G)
    assert qp_got.calibrate(ms).__dict__ == qp_ref.calibrate(ms).__dict__


def test_simclock_and_issue_stream_identical():
    results = []
    for mod, tel_mod in ((ref_fabric, ref_telemetry),
                         (pt_fabric, pt_telemetry)):
        tel = tel_mod.Telemetry()
        clock = mod.SimClock()
        qp = mod.FabricResource(clock, mod.INFINIBAND_100G, name="qp",
                                telemetry=tel, track="sim/fabric")
        seq = []
        for i, size in enumerate((1 << 20, 5 << 20, 123457, 32 << 20)):
            kind = "read" if i % 2 == 0 else "write"
            seq.append(qp.issue_stream(kind, size, 4 << 20, clock.now("t"),
                                       pipelined=bool(i % 3)))
            clock.advance("t", 250.0 * (i + 1))
            seq.append(clock.wait_until("t", seq[-1][1]))
        seq.append(qp.issue_batch("read", [1 << 20, 2 << 20, 4096], 1 << 20,
                                  clock.now("t")))
        seq.append((clock.makespan(), qp.free_at))
        results.append((seq, tel.to_chrome_trace()))
    assert results[1] == results[0]


def test_telemetry_trace_and_snapshot_identical():
    outs = []
    for mod in (ref_telemetry, pt_telemetry):
        tel = mod.Telemetry()
        tel.record_span("read", track="wall/fabric", begin_us=1.0, end_us=5.5,
                        cat="io", obj="w0", nbytes=4096)
        tel.record_span("compute:w0", track="wall/exec", begin_us=5.5,
                        end_us=9.0, cat="compute")
        tel.count("exec.bytes_read", 4096, track="wall/fabric")
        tel.count("exec.runs")
        mod.validate_chrome_trace(tel.to_chrome_trace())
        outs.append((tel.to_chrome_trace(), tel.tracks(),
                     tel.snapshot().to_json()))
    assert outs[1] == outs[0]
