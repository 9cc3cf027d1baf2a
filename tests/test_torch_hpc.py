"""The port's eight HPC workloads against the JAX reference, and the
paper's figures that they drive.

* Every workload of ``WORKLOADS``, at a small scale and on the same seed,
  through both packages under the oracle, the legacy dual buffer, the
  trace-driven pipeline, the sizing solver's ``"auto"`` budget and a
  4-node pool with 2 replicas: ``elapsed_us``, ``checksum`` and
  ``stats()`` are equal (``==``).
* ``benchmarks/run.py --bench-json``'s loop through the port reproduces
  ``BENCH_pr3.json``'s four simulated values for all eight workloads.
* The Fig 7 sweep through the port gives the reference's rows and its
  average memory saving at no more than 16 % slowdown.

The workloads and the runtime are numpy in both packages; the drivers are
in ``_torch_hpc_parity.py``.
"""
import pytest

import _torch_hpc_parity as H

WORKLOAD_NAMES = ["CG", "MG", "FT", "BT", "LU", "IS", "XSBench", "miniAMR"]


@pytest.fixture(scope="module")
def pkgs():
    return H.package("repro"), H.package("repro_torch")


def test_workload_registry_matches_reference(pkgs):
    ref, pt = pkgs
    assert list(pt.hpc.WORKLOADS) == list(ref.hpc.WORKLOADS) == WORKLOAD_NAMES
    for name, cls in pt.hpc.WORKLOADS.items():
        want = ref.hpc.WORKLOADS[name]
        for attr in ("name", "characteristics", "paper_total_gb",
                     "paper_remote_gb", "read_write_ratio",
                     "parallel_efficiency"):
            assert getattr(cls, attr) == getattr(want, attr), (name, attr)


@pytest.mark.parametrize("mode", H.MODES)
@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_workload_matches_reference(pkgs, name, mode):
    ref, pt = (H.run_mode(p, name, mode) for p in pkgs)
    assert pt.name == ref.name == name
    assert pt.elapsed_us == ref.elapsed_us
    assert pt.checksum == ref.checksum
    assert pt.stats == ref.stats


@pytest.fixture(scope="module")
def bench_pr3(pkgs):
    return H.bench_pr3(pkgs[1])


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_bench_pr3_reproduced(bench_pr3, name):
    """Simulated µs of the oracle, the legacy dual buffer and the pipeline,
    and the pipeline's speedup, equal to the committed values (``wall_s``
    is wall clock and excluded)."""
    want = H.committed("BENCH_pr3")
    assert want["config"] == {"scale": 0.2, "local_fraction": 0.05,
                              "n_iters": 10}
    for key in H.BENCH_KEYS:
        assert bench_pr3[name][key] == want["workloads"][name][key], key


@pytest.fixture(scope="module")
def fig7(pkgs):
    return tuple(H.fig7(p) for p in pkgs)


@pytest.mark.parametrize("name", WORKLOAD_NAMES)
def test_fig7_rows_match_reference(fig7, name):
    ref, pt = fig7
    assert pt["table"][name] == ref["table"][name]
    assert len(pt["table"][name]["rows"]) == len(H.FIG7_FRACTIONS)


def test_fig7_headline_matches_reference(fig7):
    """The average of each workload's largest saving at no more than 16 %
    slowdown: the reference's value, and the paper's "up to 63 %" band."""
    ref, pt = fig7
    assert pt["summary"] == ref["summary"]
    assert pt["avg_saving_at_16pct_slowdown"] == H.FIG7_AVG_SAVING
    assert ref["avg_saving_at_16pct_slowdown"] == H.FIG7_AVG_SAVING
