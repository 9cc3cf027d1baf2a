"""Common scaffolding for the paper's eight HPC workloads.

Each workload allocates its dominant data objects (named exactly as the
paper's Table 1), performs *real* numerical iterations (numpy, deterministic)
through a :class:`DolmaRuntime` — so results are bit-comparable against an
untiered oracle run — and charges an analytic compute cost (roofline max of
FLOP and local-memory time) to the simulated clock.

Sizes default to 1/1000 of the paper's Table 1 footprints; the relative
object/budget/fabric ratios (which drive Fig 7/9/10) are scale-invariant.

A copy of ``repro.hpc.base`` for this package, numpy as there.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.alloc import DEFAULT_STRIPE_BYTES
from repro_torch.core.dual_buffer import DolmaRuntime, run_iterative
from repro_torch.core.fabric import FabricModel, INFINIBAND_100G
from repro_torch.core.pool import MemoryPool

MB = 1 << 20


@dataclasses.dataclass
class WorkloadResult:
    name: str
    elapsed_us: float
    checksum: float
    stats: dict[str, Any]


class HPCWorkload:
    """Subclasses set ``name``, table-1 metadata, and implement the body."""

    name: str = "base"
    characteristics: str = ""
    # Table 1 metadata (for reporting; actual ratios emerge from the run)
    paper_total_gb: float = 0.0
    paper_remote_gb: float = 0.0
    read_write_ratio: str = "1:1"
    parallel_efficiency: float = 0.95  # fig-8 intrinsic scaling (Amdahl)

    def __init__(self, scale: float = 1.0, seed: int = 0):
        self.scale = scale
        self.rng = np.random.default_rng(seed)

    # -- interface ---------------------------------------------------------
    def register(self, rt: DolmaRuntime) -> None:
        raise NotImplementedError

    def iterate(self, rt: DolmaRuntime, it: int) -> None:
        raise NotImplementedError

    def checksum(self, rt: DolmaRuntime) -> float:
        raise NotImplementedError

    # per-iteration analytic cost (filled by register())
    flops_per_iter: float = 0.0
    bytes_per_iter: float = 0.0

    # fig-8 model inputs (filled by register())
    fetch_bytes_per_iter: int = 0
    write_bytes_per_iter: int = 0

    # -- helpers ------------------------------------------------------------
    def _target_bytes(self, paper_gb: float) -> int:
        return max(int(paper_gb * 1e9 / 1000 * self.scale), 1 * MB)

    def charge(self, rt: DolmaRuntime, frac: float = 1.0) -> None:
        """Charge ``frac`` of the per-iteration analytic compute cost.

        Workload bodies charge in fractions *between* fetches (summing to
        1.0 per iteration, so totals are unchanged): that is the compute the
        pipeline's sliding prefetch window overlaps with — fetch(k+1..k+w)
        runs on the fabric while the charge for object k advances the
        compute timeline.
        """
        rt.charge_compute(flops=self.flops_per_iter * frac,
                          bytes_touched=self.bytes_per_iter * frac)


def pooled_runtime(
    n_nodes: int,
    *,
    local_fraction: float | str,
    replication: int = 1,
    stripe_bytes: int = DEFAULT_STRIPE_BYTES,
    qps_per_node: int = 1,
    fabric: FabricModel = INFINIBAND_100G,
    telemetry: "Any | None" = None,
    client: str | None = None,
    **runtime_kwargs: Any,
) -> DolmaRuntime:
    """A DolmaRuntime whose remote tier is an ``n_nodes`` memory pool.

    Drop-in for ``DolmaRuntime(local_fraction=...)`` in any workload/benchmark:
    the pool shares the runtime's clock, so elapsed times compose, and the
    placement plan homes remote objects across nodes. A ``telemetry`` object
    is shared by the pool (per-node/QP fabric tracks) and the runtime
    (compute/stall spans on its timeline).
    """
    pool = MemoryPool(
        n_nodes,
        fabric=fabric,
        stripe_bytes=stripe_bytes,
        replication=replication,
        qps_per_node=qps_per_node,
        telemetry=telemetry,
    )
    return DolmaRuntime(local_fraction=local_fraction, fabric=fabric,
                        store=pool, telemetry=telemetry, client=client,
                        **runtime_kwargs)


def profile_workload(
    workload: HPCWorkload,
    rt: DolmaRuntime,
    *,
    profile_iters: int = 2,
):
    """One instrumented oracle warmup: record and return a WorkloadProfile.

    The recording runtime clones ``rt``'s cost-model knobs (fabric,
    sim_scale, compute model) but keeps everything local, so the exported
    event stream carries pure compute charges — exactly what the sizing
    cost model replays against candidate budgets. Registering the same
    workload instance twice is safe: all mutable state lives in the runtime
    (checksums stay bit-identical), and the RNG is consumed in __init__.
    """
    prof_rt = DolmaRuntime(
        local_fraction=1.0,
        fabric=rt.fabric,
        sim_scale=rt.sim_scale,
        compute_gflops=rt.compute_gflops,
        local_mem=rt.local_mem,
        record_profile=True,
    )
    workload.register(prof_rt)
    prof_rt.finalize()
    run_iterative(prof_rt, max(profile_iters, 1), workload.iterate)
    profile = prof_rt.profile()
    profile.source = workload.name
    return profile


def run_workload(
    workload: HPCWorkload,
    rt: DolmaRuntime,
    n_iters: int = 5,
    *,
    profile_iters: int = 2,
) -> WorkloadResult:
    """Register, finalize, and drive the workload through ``run_iterative``.

    There is exactly one iteration driver (``repro_torch.core.run_iterative``);
    this wrapper only adds registration/placement and result packaging. In
    pipeline mode the first iteration doubles as the warmup-trace pass: the
    runtime records the fetch/commit order the workload emits, and the
    recorded trace drives the sliding prefetch window from iteration 1 on.

    Auto-sizing (``rt.local_fraction == "auto"``): an instrumented oracle
    warmup of ``profile_iters`` steps records the workload's access profile
    first, and ``rt.finalize()`` hands it to the cost-model solver, which
    picks the smallest local budget meeting ``rt.degradation_target``.
    """
    if rt.local_fraction == "auto":
        rt.sizing_iters = n_iters  # price the horizon actually driven
        if rt._sizing_profile is None:
            rt.attach_profile(profile_workload(workload, rt,
                                               profile_iters=profile_iters))
    workload.register(rt)
    rt.finalize()
    elapsed = run_iterative(rt, n_iters, workload.iterate)
    return WorkloadResult(
        name=workload.name,
        elapsed_us=elapsed,
        checksum=workload.checksum(rt),
        stats=rt.stats(),
    )
