"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's.

* ``decide_tiering``: the whole decision dict ``==`` the reference's for
  every arch of ``ARCH_IDS``, each of its runnable cells, both production
  meshes ((16, 16) and (2, 16, 16), abstract) and both values of the
  host-offload probe, at the reference's ``HBM_BYTES``. The reference runs
  in one subprocess (``tests/_torch_dryrun_parity.py``): importing its
  dry-run sets ``XLA_FLAGS``.
* ``run_cell`` end to end over a 256-rank fake process group on the CPU:
  mamba2-130m's four cells, and its ``train_4k`` at a budget where the
  decision is int8 moments after FSDP, deepseek-v3-671b's ``train_4k``
  decision (the only int8 cell of the parity table, whose trace takes
  minutes here). The records carry the reference's keys; the collectives
  run in groups of 16, the mesh's axes; no default process group is left
  behind.
* The CLI writes one record per cell into the directory it is given.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPE_CELLS, runnable_cells
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import Tracer
from repro_torch.models.sharding import abstract_mesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_parity.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decide_tiering_matches_the_reference(reference, monkeypatch, arch):
    cfg = get_config(arch)
    params_abs = dryrun.abstract_params(cfg, Tracer(), "cpu")
    n = 0
    for cell in runnable_cells(cfg):
        for mesh_name, (sizes, names) in MESHES.items():
            for probe in (False, True):
                monkeypatch.setattr(dryrun, "supports_host_offload_spmd",
                                    lambda _m, _p=probe: _p)
                got = dryrun.decide_tiering(
                    cfg, SHAPE_CELLS[cell], abstract_mesh(sizes, names),
                    params_abs, hbm_bytes=reference["HBM_BYTES"])
                want = reference["decisions"][
                    f"{arch}|{cell}|{mesh_name}|{probe}"]
                assert got == want, (cell, mesh_name, probe)
                n += 1
    assert n == len(runnable_cells(cfg)) * 4


def test_the_probe_is_false_off_a_card():
    """On an abstract mesh (and a CPU one) the port's probe answers False,
    as the reference's does on XLA-CPU."""
    assert dryrun.supports_host_offload_spmd(
        abstract_mesh((16, 16), ("data", "model"))) is False


RECORD_KEYS = {"arch", "cell", "mesh", "kind", "remat", "prefetch",
               "microbatches", "param_count", "active_param_count",
               "tiering", "memory", "analysis", "collectives_by_group",
               "lower_s", "analyze_s"}


def _check_record(rec: dict) -> None:
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert set(rec["analysis"]) == {"flops", "bytes", "bytes_min",
                                    "collective_bytes",
                                    "collective_wire_bytes", "by_collective"}
    assert set(rec["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "host_argument_bytes", "host_temp_bytes", "peak_bytes_est"}
    assert rec["analysis"]["flops"] > 0
    assert rec["memory"]["peak_bytes_est"] >= rec["memory"]["argument_bytes"]
    # the spec trees split over data (16) and model (16) only
    assert {k.split("@g")[1] for k in rec["collectives_by_group"]} <= {"16"}
    assert not dist.is_initialized()


@pytest.mark.parametrize("cell", runnable_cells(get_config("mamba2-130m")))
def test_run_cell_mamba2(cell):
    rec = dryrun.run_cell("mamba2-130m", cell, multi_pod=False,
                          hbm_bytes=16e9)
    _check_record(rec)
    assert rec["tiering"]["fsdp"] is False
    cfg = get_config("mamba2-130m")
    if SHAPE_CELLS[cell].kind == "decode":  # one token: no chunk scan
        assert rec["launches"]["b3_scan"] == 0
    else:  # every layer at least once (train: forward and recomputes)
        assert rec["launches"]["b3_scan"] >= cfg.n_layers
    if cell == "train_4k":
        assert rec["tiering"]["moment_style"] == "f32"
        assert rec["collectives_by_group"]


def test_run_cell_int8_moments(reference):
    """A train cell whose decision is int8 moments, traced with them.

    The parity table's only int8 cell is deepseek-v3-671b's train_4k (at
    the reference's HBM_BYTES, the probe False), whose trace takes minutes
    on the CPU. So the trace here is mamba2-130m's train_4k at a device
    budget between its bf16 and its int8 projection with FSDP-sharded
    parameters (the decision's own arithmetic): deepseek-v3's decision
    (FSDP, then int8 moments) and the same int8 step under the mesh,
    without remat (the moments do not depend on it; the trace is shorter).
    """
    want = reference["decisions"]["deepseek-v3-671b|train_4k|16x16|False"]
    assert (want["moment_style"], want["fsdp"]) == ("int8", True)
    cfg = get_config("mamba2-130m")
    probe = dryrun.decide_tiering(  # a budget nothing fits: FSDP's bytes
        cfg, SHAPE_CELLS["train_4k"], abstract_mesh(*MESHES["16x16"]),
        dryrun.abstract_params(cfg, Tracer(), "cpu"), hbm_bytes=1.0)
    p, act = probe["params_bytes_per_dev"], probe["act_bytes_per_dev_est"]
    hbm = (p + 1.5 * p + act) / dryrun.HBM_BUDGET_FRACTION
    rec = dryrun.run_cell("mamba2-130m", "train_4k", multi_pod=False,
                          hbm_bytes=hbm, remat="none")
    _check_record(rec)
    assert (rec["tiering"]["moment_style"], rec["tiering"]["fsdp"]) == (
        "int8", True)
    assert rec["tiering"]["notes"] == want["notes"]
    assert rec["launches"]["b3_scan"] >= cfg.n_layers


def test_skipped_cell_is_the_reference_s():
    rec = dryrun.run_cell("granite-8b", "long_500k", multi_pod=True,
                          hbm_bytes=16e9)
    assert rec["skipped"] == (
        "long_500k requires sub-quadratic attention; granite-8b is "
        "full-attention (DESIGN.md §Arch-applicability)")
    assert rec["mesh"] == "2x16x16"


def test_cli_writes_a_record_per_cell(tmp_path):
    dryrun.main(["--arch", "mamba2-130m", "--cell", "decode_32k",
                 "--hbm-bytes", "16e9", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k__16x16.json")
                     .read_text())
    assert "error" not in rec and rec["kind"] == "decode"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "mamba2-130m", "--out", str(tmp_path)])
