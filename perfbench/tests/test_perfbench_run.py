"""A whole run on the CPU at a test's size (the look for a card skipped):
the result line's keys, a sound run correct, and a run with the timed path
broken underneath not correct, for each fault a train cell can have."""
import json
import math
import os
import subprocess
import sys

import pytest

from conftest import ROOT, tiny
from perfbench import faults, run

SEED = 2 ** 31 + 77  # past 32 signed bits


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    res = run.run_cell(tiny("granite-8b-12l.train-offload20"), SEED, 0.3,
                       traced, "cpu")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "train_tokens_per_s.offload" not in res["metrics"]
        assert "idle_share.offload" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"train_tokens_per_s.offload",
                                       "peak_hbm_gib", "setup_s"}
        assert res["metrics"]["setup_s"]["unit"] == "s"
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"].values():
        assert math.isfinite(c["value"]) and "limit" in c
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("name", ["granite-8b-12l.train-local",
                                  "granite-8b-12l.train-offload20"])
def test_sound_run_is_correct(name):
    res = run.run_cell(tiny(name), SEED, 0.1, False, "cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["granite-8b-12l.train-offload20",
                                  "granite-8b-12l.train-local"])
def test_fault_is_not_correct(name, fault):
    res = run.run_cell(tiny(name), SEED, 0.1, False, "cpu",
                       fault=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "granite-8b-12l.train-local", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_checkout_without_the_program_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "granite-8b-12l.train-local", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def _timeline(ops):
    from perfbench import trace
    return trace.Timeline(0, 10_000, [trace.DeviceOp(n, s, e, c)
                                      for n, s, e, c in ops], [], 1)


def test_traced_window_without_device_work_gives_no_result():
    cell = tiny("granite-8b-12l.train-offload20")
    with pytest.raises(run.NoResult, match="no device operation"):
        run.per_layer(_timeline([]), cell, need=True)
    got = run.per_layer(_timeline([]), cell, need=False)
    assert got["idle_share.offload"]["value"] == 100.0
    assert "elementwise_share.offload" not in got


def test_listed_metric_that_reads_nothing_gives_no_result():
    """A window with a GEMM and a copy but no B2 kernel: the B2 rooflines,
    listed for the cell, read nothing."""
    cell = tiny("granite-8b-12l.train-offload20")
    tl = _timeline([("nvjet_gemm", 0, 4_000, "gemm"),
                    ("Memcpy HtoD (Pinned -> Device)", 2_000, 8_000,
                     "copy_h2d")])
    with pytest.raises(run.NoResult, match="b2_fwd_roofline"):
        run.per_layer(tl, cell, need=True)
    got = run.per_layer(tl, cell, need=False)
    assert "b2_fwd_roofline.offload" not in got
    assert got["idle_share.offload"]["value"] == pytest.approx(20.0)
    assert got["copy_exposed_share"]["value"] == pytest.approx(40.0)
