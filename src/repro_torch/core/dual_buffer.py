"""DOLMA host runtime: tiered allocation + prefetch (§4.2, §5).

:class:`DolmaRuntime` is what the HPC workloads (``repro_torch.hpc``) run on. It
implements, functionally and on the simulated clock:

  * allocation interception (``alloc``) and the three-region local layout
    (local data-object region / remote data-object cache region / metadata);
  * placement via :class:`~repro_torch.core.placement.PlacementPolicy`;
  * on-demand chunked fetch bounded by the cache region size — small local
    budgets force many small RDMA ops, reproducing the paper's observation
    that 1–5 % budgets stay slow (§6.1.1);
  * cross-iteration dual-buffer prefetch: at the end of step *i* the read set
    is prefetched for step *i+1*, overlapping the fabric time with compute;
    the access barrier is deferred to first use (§5);
  * the trace-driven prefetch **pipeline** (``pipeline=True``): the runtime
    records each step's fetch/commit order, predicts the next step's access
    order from it, and keeps a sliding window of ``prefetch_window`` objects
    posted ahead of compute — ``fetch(k+1..k+w)`` overlaps the compute on
    object *k* inside the iteration (and wraps across the iteration
    boundary), the cache region is evicted by reuse distance computed from
    the trace (Belady-from-trace), and each window is coalesced into one
    batched scatter-gather read on the store/pool;
  * asynchronous write-back on demotion, synchronous reads (§4.2);
  * a compute cost model (max of FLOP time and local-memory time) so
    benchmark timings are deterministic on any host.

Every fetch/commit also really moves the bytes (numpy), so workload results
stay bit-correct and testable against untiered oracles.

A copy of ``repro.core.dual_buffer`` for this package, numpy as there.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.core.fabric import (
    FabricModel,
    INFINIBAND_100G,
    LOCAL_DDR,
    SimClock,
)
from repro_torch.core.metadata import MetadataTable, ObjectMeta, Status, Tier
from repro_torch.core.objects import DataObject, ObjectCatalog, ObjectKind
from repro_torch.core.placement import PlacementPlan, PlacementPolicy
from repro_torch.core.pool import MemoryPool
from repro_torch.core.remote_store import RemoteStore
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry

# A 2-socket Xeon class node (the paper's testbed) for the compute model.
DEFAULT_COMPUTE_GFLOPS = 60.0



@dataclasses.dataclass
class _LiveObject:
    obj: DataObject
    data: np.ndarray | None  # present iff LOCAL tier (remote data lives in store)


class DolmaRuntime:
    """Single-node DOLMA runtime (one compute timeline)."""

    def __init__(
        self,
        *,
        local_fraction: float | str = 1.0,
        fabric: FabricModel = INFINIBAND_100G,
        dual_buffer: bool = True,
        sync_writes: bool = False,
        clock: SimClock | None = None,
        compute_gflops: float = DEFAULT_COMPUTE_GFLOPS,
        local_mem: FabricModel = LOCAL_DDR,
        policy: PlacementPolicy | None = None,
        timeline: str = "main",
        sim_scale: float = 1.0,
        store: RemoteStore | MemoryPool | None = None,
        pipeline: bool = False,
        prefetch_window: int = 4,
        record_profile: bool = False,
        degradation_target: float = 0.16,
        sizing_profile: "Any | None" = None,
        sizing_iters: int = 10,
        telemetry: Telemetry | None = None,
        client: str | None = None,
    ) -> None:
        # sim_scale: fabric/compute costs are charged at sim_scale x the real
        # array bytes, so small (fast, testable) arrays model paper-scale
        # objects with no distortion of base-latency/window ratios.
        if local_fraction == "auto":
            pass  # sized at finalize() by the cost-model solver (core.sizing)
        elif isinstance(local_fraction, str):
            raise ValueError(
                f"local_fraction must be a float or 'auto', got {local_fraction!r}"
            )
        self.local_fraction = local_fraction
        self.fabric = fabric
        self.dual_buffer = dual_buffer
        self.sync_writes = sync_writes
        if store is not None and clock is not None and store.clock is not clock:
            raise ValueError("store and runtime must share one SimClock")
        self.clock = store.clock if store is not None else (clock or SimClock())
        self.compute_gflops = compute_gflops
        self.local_mem = local_mem
        self.policy = policy or PlacementPolicy()
        self.timeline = timeline
        self.sim_scale = sim_scale
        # trace-driven pipeline: predicted-order sliding-window prefetch with
        # Belady-from-trace eviction and batched pool I/O
        self.pipeline = pipeline
        self.prefetch_window = max(int(prefetch_window), 1)
        # pool tenancy: when the remote tier is a shared MemoryPool, this
        # runtime's allocations land in its own per-client slab arena
        self.client = client

        # observability: spans/counters recorded against the simulated clock
        # (reads only — enabling telemetry never changes a benchmark number)
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        if self.telemetry.enabled:
            self.telemetry.bind_clock(self.clock)
        # stall/overlap/compute accounting on this runtime's timeline —
        # always maintained (plain float adds), surfaced by summary()
        self._time_acct = {"compute_us": 0.0, "stall_us": 0.0,
                           "overlap_us": 0.0}
        # the remote tier: a single memory node by default, or any object
        # with the store API — notably a multi-node MemoryPool
        self.store = store or RemoteStore(clock=self.clock, fabric=fabric,
                                          telemetry=telemetry)
        self.metadata = MetadataTable()
        self._live: dict[str, _LiveObject] = {}
        self._finalized = False
        self._epoch = 0
        self._read_set: set[str] = set()
        self._prefetched: dict[str, tuple[float, int]] = {}  # legacy dual buffer
        self.cache_region_bytes = 0
        self.local_region_bytes = 0
        self.metadata_region_bytes = 4096
        self._fetches_done_at = 0.0
        self._fetch_done: dict[str, float] = {}  # per-object slot-freed time
        self._peak_cached = 0
        self._cached_now = 0
        self._resident: dict[str, int] = {}   # bytes of each remote object
        self._cache_share: dict[str, int] = {}  # resident in the cache region
        self._cache_occupancy: dict[str, int] = {}  # bytes in cache per object
        self.plan: PlacementPlan | None = None
        # --- access-trace recorder + pipeline state ---
        self._trace: list[tuple[str, str]] = []   # this step's (op, name) events
        self._prediction: list[str] = []          # predicted remote fetch order
        self._pred_index: dict[str, int] = {}
        self._trace_pos = 0
        self._inflight: dict[str, tuple[float, int]] = {}  # name -> (done, covered)
        self._event_idx = 0
        self._last_use: dict[str, int] = {}
        # completion time of posted tail-streams whose consumption overlaps
        # compute; absorbed by the next charge_compute (or the step barrier)
        self._stream_debt = 0.0
        self._pf = {
            "trace_hits": 0, "trace_misses": 0, "prefetched_bytes": 0,
            "demand_bytes": 0, "batched_reads": 0, "evictions": 0,
            "dropped_mispredicts": 0, "window_used": 0,
        }
        # --- quantitative sizing (core.sizing) ---
        # record_profile: keep the full per-step (fetch/commit/compute) event
        # stream so profile() can export a WorkloadProfile for the cost model
        self.record_profile = record_profile
        self.degradation_target = degradation_target
        # horizon the "auto" solver prices over; the warmup (trace-miss)
        # iteration amortizes across it, so it should match the planned run
        # length — repro_torch.hpc.run_workload sets it to the driven n_iters
        self.sizing_iters = max(int(sizing_iters), 1)
        self._sizing_profile = sizing_profile
        self.sizing_advice = None  # populated by the "auto" finalize path
        self._step_events: list[tuple[str, Any]] = []
        self._profile_steps: list[list[tuple[str, Any]]] = []

    # -- allocation interception ------------------------------------------
    def alloc(
        self,
        name: str,
        array: np.ndarray,
        *,
        reads_per_iter: int = 1,
        writes_per_iter: int = 0,
        kind: ObjectKind = ObjectKind.INPUT,
        lifetime_iters: float = float("inf"),
        pinned_local: bool = False,
    ) -> str:
        """Register ``array`` as a data object before :meth:`finalize`.

        ``reads_per_iter``/``writes_per_iter`` feed the placement policy's
        hotness score; ``sim_bytes`` are scaled real bytes charged to the
        fabric model. Returns the object name.
        """
        if self._finalized:
            raise RuntimeError("alloc() after finalize(); DOLMA plans at startup")
        array = np.asarray(array)
        obj = DataObject(
            name=name,
            shape=tuple(array.shape),
            dtype=array.dtype,
            sim_bytes=int(array.nbytes * self.sim_scale),
            kind=kind,
            n_reads=reads_per_iter,
            n_writes=writes_per_iter,
            lifetime_iters=lifetime_iters,
            pinned_local=pinned_local,
        )
        self._live[name] = _LiveObject(obj, np.array(array, copy=True))
        return name

    def attach_profile(self, profile: Any) -> None:
        """Attach a :class:`~repro_torch.core.sizing.WorkloadProfile` for the
        ``local_fraction="auto"`` finalize path (recorded by a warmup run on
        an instrumented oracle runtime, or built synthetically)."""
        self._sizing_profile = profile

    def _auto_size(self) -> int:
        """Run the sizing solver; returns the advised local budget (bytes)."""
        from repro_torch.core.sizing import ModelConfig, advise_local_size

        if self._sizing_profile is None:
            raise RuntimeError(
                "local_fraction='auto' needs a WorkloadProfile: run a "
                "DolmaRuntime(record_profile=True) warmup and attach_profile()"
                " its .profile() — repro_torch.hpc.run_workload does this for you"
            )
        pooled = isinstance(self.store, MemoryPool)
        # same plan-level capacity conversion finalize() applies, so the
        # priced plan matches the installed one on capacity-bounded pools
        plan_capacity = None
        if pooled and self.store.nodes[0].capacity_bytes is not None:
            plan_capacity = int(
                self.store.nodes[0].capacity_bytes * self.sim_scale
                / self.store.replication
            )
        cfg = ModelConfig(
            fabric=self.fabric,
            n_nodes=self.store.n_nodes if pooled else 1,
            window=self.prefetch_window,
            n_iters=self.sizing_iters,
            node_capacity_bytes=plan_capacity,
            mode=("pipeline" if self.pipeline
                  else "legacy" if self.dual_buffer else "serial"),
            stripe_bytes=(self.store.stripe_bytes if pooled
                          else ModelConfig.stripe_bytes),
            replication=self.store.replication if pooled else 1,
            qps_per_node=len(self.store.nodes[0].resources) if pooled
            else len(self.store.resources),
        )
        advice = advise_local_size(
            self._sizing_profile, self.degradation_target,
            policy=self.policy, config=cfg,
        )
        self.sizing_advice = advice
        self.local_fraction = advice.advised_fraction
        return advice.advised_budget_bytes

    def finalize(self) -> PlacementPlan:
        """Run placement, demote REMOTE objects, size the cache region.

        With ``local_fraction="auto"``, the cost-model solver
        (:func:`repro_torch.core.sizing.advise_local_size`) picks the budget first
        from the attached workload profile and the degradation target.
        """
        auto_budget = self._auto_size() if self.local_fraction == "auto" else None
        catalog = ObjectCatalog(lo.obj for lo in self._live.values())
        pooled = isinstance(self.store, MemoryPool)
        # Plan-level node capacity works in the plan's (sim-scaled) units and
        # must cover every replica; convert the pool's physical per-node
        # limit accordingly. Striping makes per-home accounting approximate,
        # so a physical MemoryError at alloc time still falls back to LOCAL.
        plan_capacity = None
        if pooled and self.store.nodes[0].capacity_bytes is not None:
            plan_capacity = int(
                self.store.nodes[0].capacity_bytes * self.sim_scale
                / self.store.replication
            )
        plan = self.policy.plan(
            catalog,
            local_fraction=None if auto_budget is not None else self.local_fraction,
            local_budget_bytes=auto_budget,
            n_nodes=self.store.n_nodes if pooled else 1,
            node_capacity_bytes=plan_capacity,
        )
        budget = plan.budget_bytes

        kept_local: list[str] = []
        local_bytes = 0
        for name, lo in self._live.items():
            tier = plan.tier_of(name)
            if tier is Tier.REMOTE:
                try:
                    if pooled:
                        # the plan's home node anchors the stripe walk
                        self.store.alloc(name, lo.data,
                                         home=plan.node_of.get(name),
                                         client=self.client)
                    else:
                        self.store.alloc(name, lo.data)
                except MemoryError:
                    # remote tier physically full: the object stays local
                    # (pool.alloc rolled its extents back)
                    tier = Tier.LOCAL
                    kept_local.append(name)
            if tier is Tier.REMOTE:
                lo.data = None  # freed from local memory
                self.metadata.register(
                    ObjectMeta(
                        name=name,
                        tier=Tier.REMOTE,
                        status=Status.FLUSHED,
                        size_bytes=lo.obj.size_bytes,
                    )
                )
            else:
                local_bytes += lo.obj.size_bytes
                self.metadata.register(
                    ObjectMeta(
                        name=name,
                        tier=Tier.LOCAL,
                        status=Status.PRESENT,
                        size_bytes=lo.obj.size_bytes,
                    )
                )
        if kept_local:
            # reflect the physical fallback in the plan consumers see
            tiers = dict(plan.tiers)
            node_of = dict(plan.node_of)
            fallback_bytes = 0
            for name in kept_local:
                tiers[name] = Tier.LOCAL
                node_of.pop(name, None)
                fallback_bytes += self._live[name].obj.size_bytes
            plan = dataclasses.replace(
                plan,
                tiers=tiers,
                node_of=node_of,
                local_bytes=plan.local_bytes + fallback_bytes,
                remote_bytes=plan.remote_bytes - fallback_bytes,
            )
        self.local_region_bytes = local_bytes
        # Remaining budget is the RDMA-registered cache region (§4.2); always
        # keep at least one page so chunked transfer can make progress. The
        # metadata region holds QPs/CQs + one entry per object (tiny, §3.2).
        self.metadata_region_bytes = max(4096, 64 * len(catalog))
        self.cache_region_bytes = max(
            budget - local_bytes - self.metadata_region_bytes, 4096
        )
        remote = [(n, self.metadata.get(n).size_bytes) for n in plan.remote_names()]
        for n, _s in remote:
            self._resident[n] = 0
        if not self.pipeline:
            # Statically partition the cache region among remote objects
            # (proportional to size): the resident portion persists across
            # iterations and only the remainder is refetched (§4.2 "prefetches
            # the largest possible portion of the data object that fits").
            total_remote = sum(s for _n, s in remote) or 1
            usable = self.cache_region_bytes
            if self.dual_buffer:
                usable //= 2  # one half streams, one half is resident
            for n, s in remote:
                self._cache_share[n] = min(usable * s // total_remote, s)
        # In pipeline mode the whole region is managed dynamically: residency
        # is decided by Belady-from-trace eviction, not static shares.
        self.plan = plan
        self._finalized = True
        return plan

    # -- iteration structure -------------------------------------------------
    @contextlib.contextmanager
    def step(self):
        """One outer iteration.

        Dual buffer: at step exit, this step's read set is prefetched for the
        next iteration into the idle buffer half. Each object's read is
        *posted* at the moment its own demand fetch completed (when its slot
        in the idle half was freed), so it overlaps this step's compute on
        the fabric — the §4.2 overlap. The access barrier stays at first use
        (next step's fetch).

        Pipeline: the recorded trace becomes the prediction for the next
        step, and the window head for the next iteration is posted while this
        step's trailing compute still runs.
        """
        self._check_final()
        self._read_set.clear()
        self._trace = []
        self._step_events = []
        self._fetch_done.clear()
        self._settle_cache_occupancy()
        self._fetches_done_at = self.clock.now(self.timeline)
        t_enter = self._fetches_done_at
        epoch = self._epoch
        yield self
        self._epoch += 1
        if self.record_profile:
            self._profile_steps.append(self._step_events)
            self._step_events = []
        if self.pipeline:
            if self._stream_debt > 0.0:  # step barrier: all reads landed
                self._wait(self._stream_debt, "stream")
                self._stream_debt = 0.0
            self._end_step_pipeline()
        elif self.dual_buffer:
            for name in sorted(self._read_set):
                meta = self.metadata.get(name)
                if meta.tier is Tier.REMOTE:
                    self._prefetched[name] = self._issue_chunked_read(
                        name,
                        issue_at=self._fetch_done.get(name, self._fetches_done_at),
                    )
        self.telemetry.record_span(
            f"step:{epoch}", track=self.timeline, begin_us=t_enter,
            end_us=self.clock.now(self.timeline), cat="step", epoch=epoch,
        )

    # -- data path ----------------------------------------------------------
    def fetch(self, name: str) -> np.ndarray:
        """Synchronous read; barrier deferred to this call site (§5).

        Legacy path: the prefetched portion (bounded by the idle buffer
        half, §4.2 "the largest possible portion that fits") is waited on;
        any remainder is fetched on demand, window-synchronously — only one
        buffer-half's worth of reads can be outstanding, which is what keeps
        tiny local budgets slow (§6.1.1).

        Pipeline path: waits on the window entry posted in predicted access
        order, then immediately re-pumps the window so ``fetch(k+1..k+w)``
        overlaps the compute charged after this call returns.

        LOCAL-tier objects return the live buffer itself (zero-copy), and
        ``commit`` updates that buffer in place: a reference held across a
        later ``commit`` of the same object observes the new values.
        """
        self._check_final()
        self._read_set.add(name)
        self._trace.append(("fetch", name))
        if self.record_profile:
            self._step_events.append(("fetch", name))
        lo = self._live[name]
        meta = self.metadata.get(name)
        meta.n_fetches += 1
        # reuse-distance trace stat: fetch events since this object's last use
        idx = self._event_idx
        self._event_idx += 1
        prev = self._last_use.get(name)
        if prev is not None:
            meta.reuse_distance = idx - prev
        self._last_use[name] = idx
        if meta.tier is not Tier.REMOTE:
            return lo.data
        if self.pipeline:
            return self._fetch_pipelined(name, meta)
        size = meta.size_bytes - self._resident.get(name, 0)
        covered = 0
        if name in self._prefetched:
            done, covered = self._prefetched.pop(name)
            self._wait(done, "barrier", obj=name)  # access barrier
        remainder = max(size - covered, 0)
        if remainder > 0:
            mode = "windowed" if self.dual_buffer else "serial"
            done = self.store.stream_read(
                name, nbytes=remainder, chunk_bytes=self._chunk_bytes(),
                issue_at=self.clock.now(self.timeline), mode=mode,
            )
            self._wait(done, "fetch", obj=name, nbytes=remainder)
            self._bump("demand_bytes", remainder)
        self._resident[name] = self._cache_share.get(name, 0)
        self._track_cache(name, lo.obj.size_bytes)
        data = self.store.payload(name)
        self._fetches_done_at = self.clock.now(self.timeline)
        self._fetch_done[name] = self._fetches_done_at
        return data

    def commit(self, name: str, array: np.ndarray) -> None:
        """Write back an updated object (async demotion if REMOTE).

        LOCAL-tier commits copy into the object's existing buffer (the one
        ``fetch`` hands out) instead of allocating a fresh array each
        iteration; references obtained from earlier ``fetch`` calls therefore
        see the committed values. A committed view aliasing the buffer
        itself is the one case that still takes a full copy.
        """
        self._check_final()
        self._trace.append(("commit", name))
        if self.record_profile:
            self._step_events.append(("commit", name))
        lo = self._live[name]
        meta = self.metadata.get(name)
        meta.n_commits += 1
        array = np.asarray(array)
        if meta.tier is not Tier.REMOTE:
            cur = lo.data
            if (
                cur is not None
                and cur.shape == array.shape
                and cur.dtype == array.dtype
            ):
                # reuse the existing buffer instead of allocating a fresh
                # copy every iteration; a full copy is only needed when the
                # caller hands back a view aliasing the buffer itself
                if array is not cur:
                    if np.shares_memory(array, cur):
                        lo.data = np.array(array, copy=True)
                    else:
                        np.copyto(cur, array)
            else:
                lo.data = np.array(array, copy=True)
            self.metadata.update(name, epoch=self._epoch, status=Status.PRESENT)
            return
        # async posted writes stream at line rate; the timeline doesn't wait
        end = self.store.stream_write(
            name, array, chunk_bytes=self._chunk_bytes(),
            issue_at=self.clock.now(self.timeline), mode="pipelined",
            epoch=self._epoch, charge_bytes=meta.size_bytes,
        )
        self.metadata.update(name, epoch=self._epoch, status=Status.DIRTY)
        self.telemetry.instant("commit", track=self.timeline, obj=name,
                               nbytes=meta.size_bytes)
        self.telemetry.count("runtime.commit_bytes", meta.size_bytes)
        # the local copy in the cache region is the freshest: stays resident
        if not self.pipeline:
            self._resident[name] = self._cache_share.get(name, 0)
        self._track_cache(name, max(self._resident.get(name, 0),
                                    self._cache_occupancy.get(name, 0)))
        if self.sync_writes:
            self._wait(end, "commit", obj=name)

    def charge_compute(self, *, flops: float = 0.0, bytes_touched: float = 0.0,
                       us: float | None = None) -> float:
        """Advance the compute timeline (roofline-style max of terms).

        In pipeline mode this is also the synchronization point for
        tail-streams posted by predicted fetches: the compute consuming an
        object runs concurrently with the rest of it arriving, so the pair
        costs max(compute, stream) instead of their sum.
        """
        if us is None:
            flop_us = flops * self.sim_scale / (self.compute_gflops * 1e3)
            mem_us = bytes_touched * self.sim_scale / (self.local_mem.read_gbps * 1e3)
            us = max(flop_us, mem_us)
        if self.record_profile:
            self._step_events.append(("compute", us))
        t0 = self.clock.now(self.timeline)
        t = self.clock.advance(self.timeline, us)
        self._time_acct["compute_us"] += us
        if us > 0.0:
            self.telemetry.record_span("compute", track=self.timeline,
                                       begin_us=t0, end_us=t, cat="compute")
            self.telemetry.count("runtime.compute_us", us)
        if self._stream_debt > 0.0:
            # the portion of the posted stream hidden under this compute
            overlap = max(min(self._stream_debt, t) - t0, 0.0)
            if overlap > 0.0:
                self._time_acct["overlap_us"] += overlap
                self.telemetry.count("runtime.overlap_us", overlap)
            t = self._wait(self._stream_debt, "stream")
            self._stream_debt = 0.0
        return t

    # -- metrics ---------------------------------------------------------
    def elapsed_us(self) -> float:
        """Simulated time (us) elapsed on this runtime's timeline."""
        return self.clock.now(self.timeline)

    def local_capacity_bytes(self) -> int:
        """Configured local + cache + metadata region capacity in bytes."""
        return (
            self.local_region_bytes + self.cache_region_bytes
            + self.metadata_region_bytes
        )

    def peak_local_bytes(self) -> int:
        """High-water local footprint in bytes (cache clipped to its region)."""
        return (
            self.local_region_bytes
            + min(self._peak_cached, self.cache_region_bytes)
            + self.metadata_region_bytes
        )

    def last_trace(self) -> list[tuple[str, str]]:
        """The most recent step's (op, name) access trace."""
        return list(self._trace)

    def profile(self) -> "Any":
        """Export the recorded run as a WorkloadProfile for the cost model.

        Requires ``record_profile=True`` and at least one completed step;
        usually recorded on an untiered oracle runtime (local_fraction=1.0)
        so the event stream carries pure compute charges. The stream itself
        is placement-independent (bodies fetch/commit/charge identically at
        every fraction), so one recording prices every candidate budget.
        """
        from repro_torch.core.sizing import ObjectProfile, WorkloadProfile

        if not self.record_profile:
            raise RuntimeError("profile() needs DolmaRuntime(record_profile=True)")
        if not self._profile_steps:
            raise RuntimeError("profile() needs at least one completed step()")
        objects = {}
        for name, lo in self._live.items():
            meta = self.metadata.get(name)
            objects[name] = ObjectProfile(
                name=name,
                size_bytes=lo.obj.size_bytes,
                real_nbytes=max(
                    int(np.prod(lo.obj.shape, dtype=np.int64))
                    * np.dtype(lo.obj.dtype).itemsize,
                    1,
                ),
                kind=lo.obj.kind.value,
                n_reads=lo.obj.n_reads,
                n_writes=lo.obj.n_writes,
                lifetime_iters=lo.obj.lifetime_iters,
                pinned_local=lo.obj.pinned_local,
                n_fetch_events=meta.n_fetches,
                n_commit_events=meta.n_commits,
                reuse_distance=meta.reuse_distance,
            )
        frac = self.local_fraction if isinstance(self.local_fraction, float) else 1.0
        return WorkloadProfile(
            objects=objects,
            steps=[list(step) for step in self._profile_steps],
            sim_scale=self.sim_scale,
            compute_gflops=self.compute_gflops,
            fabric_name=self.fabric.name,
            recorded_fraction=frac,
        )

    def predicted_order(self) -> list[str]:
        """Remote-object fetch order predicted from the recorded trace."""
        return list(self._prediction)

    def stats(self) -> dict[str, Any]:
        """Store traffic + runtime occupancy/prefetch/overlap counters."""
        s = self.store.stats()
        s.update(
            elapsed_us=self.elapsed_us(),
            local_capacity_bytes=self.local_capacity_bytes(),
            peak_local_bytes=self.peak_local_bytes(),
            epoch=self._epoch,
            plan=self.plan.summary() if self.plan else None,
            prefetch=dict(
                self._pf,
                pipeline=self.pipeline,
                window=self.prefetch_window,
                prediction_len=len(self._prediction),
            ),
            reuse_distances=self.metadata.reuse_stats(),
            time_accounting=dict(self._time_acct),
        )
        return s

    def summary(self) -> dict[str, Any]:
        """Run-level observability digest: reuse stats, per-object
        fetch/commit counters, prefetch accuracy, and time accounting.

        Unlike :meth:`stats` (which folds in the store's transfer stats),
        this is the flat per-object view the telemetry exporters and the
        examples print.
        """
        used = self._pf.get("window_used", 0)
        dropped = self._pf.get("dropped_mispredicts", 0)
        denom = used + dropped
        return {
            "elapsed_us": self.elapsed_us(),
            "epochs": self._epoch,
            "plan": self.plan.summary() if self.plan else None,
            "reuse_stats": self.metadata.reuse_stats(),
            "access_counts": self.metadata.access_counts(),
            "prefetch": dict(self._pf),
            "prefetch_accuracy": (used / denom) if denom else None,
            "time_accounting": dict(self._time_acct),
        }

    def drain(self) -> float:
        """Fence async writes on this runtime's timeline (recorded as a
        stall span so drained tail demotions show up in the trace)."""
        t0 = self.clock.now(self.timeline)
        end = self.store.fence(timeline=self.timeline)
        t = self.clock.now(self.timeline)
        if t > t0:
            self._time_acct["stall_us"] += t - t0
            self.telemetry.record_span("stall:drain", track=self.timeline,
                                       begin_us=t0, end_us=t, cat="stall")
            self.telemetry.count("runtime.stall_us", t - t0, reason="drain")
        return end

    # -- trace-driven pipeline internals ----------------------------------
    def _fetch_pipelined(self, name: str, meta: ObjectMeta) -> np.ndarray:
        size = meta.size_bytes
        predicted = name in self._pred_index
        if name in self._inflight:
            done, covered = self._inflight.pop(name)
            self._wait(done, "barrier", obj=name)  # barrier at first use
            self._bump("window_used")
            self._resident[name] = min(
                self._resident.get(name, 0) + covered, size
            )
        if predicted:
            self._bump("trace_hits")
            # advance along the prediction and re-pump *before* posting this
            # object's tail: the next window entries are nearer in predicted
            # order, so their (small) heads must not queue behind a large
            # tail that is consumed gradually anyway
            self._trace_pos = max(self._trace_pos, self._pred_index[name] + 1)
            self._pump(self.clock.now(self.timeline))
        else:
            self._bump("trace_misses")
        remainder = size - self._resident.get(name, 0)
        if remainder > 0:
            # Retention grant for the streamed tail is judged by this
            # object's *post-read* reuse distance (its next use is a full
            # cycle away), so it can only displace residents the trace says
            # are reused even later — never the stable working set.
            grant = self._evict_for(
                remainder, next_use=self._next_use(name) if predicted else 0,
                protect={name} | set(self._inflight),
            )
            now = self.clock.now(self.timeline)
            if predicted:
                # Predicted object: the trace pins its consumption order, so
                # the tail beyond the resident/prefetched head streams
                # through the region *while this object's compute consumes
                # it* — the access barrier covers only the head, and the
                # stream's completion is absorbed by the next compute charge
                # (max(compute, fetch) instead of compute + fetch).
                end = self.store.stream_read(
                    name, nbytes=remainder,
                    chunk_bytes=self._pipeline_chunk_bytes(),
                    issue_at=now, mode="pipelined",
                )
                self._wait(now + self.fabric.read_base_us, "post", obj=name)
                self._stream_debt = max(self._stream_debt, end)
            else:
                # trace miss: consumption order unknown — full synchronous
                # barrier through the (full) cache region, window-style
                end = self.store.stream_read(
                    name, nbytes=remainder, chunk_bytes=self._chunk_bytes(),
                    issue_at=now, mode="windowed",
                )
                self._wait(end, "fetch", obj=name, nbytes=remainder)
            self._bump("demand_bytes", remainder)
            self._resident[name] = min(self._resident.get(name, 0) + grant, size)
        self._track_cache(name, size)
        data = self.store.payload(name)
        self._fetches_done_at = self.clock.now(self.timeline)
        self._fetch_done[name] = self._fetches_done_at
        return data

    def _end_step_pipeline(self) -> None:
        """Adopt this step's trace as the next step's prediction and post the
        window head while the trailing compute still runs."""
        fetched = [
            n for op, n in self._trace
            if op == "fetch" and self.metadata.get(n).tier is Tier.REMOTE
        ]
        prediction = list(dict.fromkeys(fetched))
        if prediction:
            self._prediction = prediction
            self._pred_index = {n: i for i, n in enumerate(prediction)}
            # drop window entries the new trace disowns (mispredicts); their
            # buffer space is reclaimable immediately
            for stale in [n for n in self._inflight if n not in self._pred_index]:
                del self._inflight[stale]
                self._bump("dropped_mispredicts")
        self._trace_pos = 0
        self._pump(self._fetches_done_at)

    def _pump(self, at: float) -> None:
        """Keep ``prefetch_window`` predicted objects posted ahead of the
        current trace position (wrapping across the iteration boundary), as
        one batched scatter-gather read. Space is made by Belady-from-trace
        eviction; nearer window entries win ties for the remaining room."""
        n_pred = len(self._prediction)
        if n_pred == 0:
            return
        window: list[tuple[str, int]] = []
        for off in range(min(self.prefetch_window, n_pred)):
            cand = self._prediction[(self._trace_pos + off) % n_pred]
            if cand not in self._inflight:  # offsets index distinct entries
                window.append((cand, off))
        # Head staging is transient (predicted objects stream-overlap with or
        # without a head), so it must not displace the retained working set:
        # only residents the trace never predicts again are evictable here.
        protect = set(self._inflight) | set(self._pred_index)
        requests: list[tuple[str, int]] = []
        for cand, off in window:
            need = self.metadata.get(cand).size_bytes - self._resident.get(cand, 0)
            if need <= 0:
                continue
            grant = self._evict_for(need, next_use=off, protect=protect)
            if grant <= 0:
                break  # region full: farther window entries wait their turn
            requests.append((cand, grant))
            # reserve the space so later grants in this pump see it taken
            self._inflight[cand] = (at, grant)
        if not requests:
            return
        done = self.store.stream_read_batch(
            requests, chunk_bytes=self._pipeline_chunk_bytes(),
            issue_at=at, mode="pipelined",
        )
        for cand, covered in requests:
            self._inflight[cand] = (done[cand], covered)
            self._bump("prefetched_bytes", covered)
        self._bump("batched_reads")
        self.telemetry.instant("pump", track=self.timeline, t_us=at,
                               window=[n for n, _g in requests])

    def _cache_used(self) -> int:
        return (
            sum(self._resident.values())
            + sum(covered for _done, covered in self._inflight.values())
        )

    def _next_use(self, name: str) -> int:
        """Distance (in predicted fetches) to this object's next use, with
        the trace assumed to repeat cyclically across iterations."""
        n_pred = len(self._prediction)
        i = self._pred_index.get(name)
        if i is None or n_pred == 0:
            return n_pred + 1  # never predicted to be read again: farthest
        return (i - self._trace_pos) % n_pred

    def _evict_for(self, need: int, *, next_use: int, protect: set[str]) -> int:
        """Free cache space via Belady-from-trace: drop residency of objects
        whose next predicted use is *strictly farther* than the requester's
        (``next_use``, in predicted fetches). Returns the bytes actually
        available for the caller (<= need)."""
        free = self.cache_region_bytes - self._cache_used()
        if free >= need:
            return need
        victims = sorted(
            (
                n for n, b in self._resident.items()
                if b > 0 and n not in protect and self._next_use(n) > next_use
            ),
            key=lambda n: (-self._next_use(n), n),
        )
        for victim in victims:
            if free >= need:
                break
            freed = self._resident[victim]
            free += freed
            self._resident[victim] = 0
            self._cache_occupancy.pop(victim, None)
            self._bump("evictions")
            self.telemetry.instant("evict", track=self.timeline,
                                   victim=victim, nbytes=freed)
        return max(min(free, need), 0)

    # -- internals --------------------------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        """Increment a prefetch counter (dict + telemetry registry)."""
        self._pf[key] = self._pf.get(key, 0) + n
        self.telemetry.count("prefetch." + key, n)

    def _wait(self, t_us: float, reason: str, **args: Any) -> float:
        """wait_until on this runtime's timeline, recording any stall as a
        span so per-timeline span totals tile elapsed time exactly."""
        now = self.clock.now(self.timeline)
        t = self.clock.wait_until(self.timeline, t_us)
        if t > now:
            self._time_acct["stall_us"] += t - now
            self.telemetry.record_span(
                f"stall:{reason}", track=self.timeline,
                begin_us=now, end_us=t, cat="stall", **args,
            )
            self.telemetry.count("runtime.stall_us", t - now, reason=reason)
        return t

    def _chunk_bytes(self) -> int:
        if self.pipeline:
            region = self.cache_region_bytes  # window replaces the two halves
        elif self.dual_buffer:
            region = self.cache_region_bytes // 2
        else:
            region = self.cache_region_bytes
        return max(min(region, self.fabric.max_op_bytes), 4096)

    def _pipeline_chunk_bytes(self) -> int:
        # posted async reads are chunked like the legacy prefetch path: a
        # handful of RDMA ops per window entry, never below one page
        return max(self._chunk_bytes() // 8, 4096)

    def _issue_chunked_read(self, name: str, issue_at: float | None = None
                            ) -> tuple[float, int]:
        """Post an async prefetch of the non-resident part, bounded by the

        idle buffer half. Returns (completion_time, covered_bytes).
        """
        size = self.metadata.get(name).size_bytes
        size -= self._resident.get(name, 0)
        half = self._chunk_bytes()
        covered = min(size, half)
        if covered <= 0:
            t = self.clock.now(self.timeline) if issue_at is None else issue_at
            return t, 0
        t = self.clock.now(self.timeline) if issue_at is None else issue_at
        # posted async reads pipeline the RTT (Fig 9/10 mechanism); the store
        # orders the stream after any pending write to the object (RAW)
        end = self.store.stream_read(
            name, nbytes=covered, chunk_bytes=max(covered // 8, 4096),
            issue_at=t, mode="pipelined",
        )
        return end, covered

    def _track_cache(self, name: str, nbytes: int) -> None:
        """Record that ``nbytes`` of ``name`` occupy the cache region now.

        Occupancy is summed over every object resident or streaming in the
        same step (then clipped to the region size), so ``peak_local_bytes``
        reflects several co-cached remote objects instead of only the
        last-touched one.
        """
        self._cache_occupancy[name] = min(nbytes, self.cache_region_bytes)
        self._cached_now = min(
            sum(self._cache_occupancy.values()), self.cache_region_bytes
        )
        self._peak_cached = max(self._peak_cached, self._cached_now)

    def _settle_cache_occupancy(self) -> None:
        """At a step boundary the streamed (non-resident) portions have been
        recycled; only the resident shares persist in the region."""
        for n in list(self._cache_occupancy):
            kept = self._resident.get(n, 0)
            if kept > 0:
                self._cache_occupancy[n] = min(kept, self.cache_region_bytes)
            else:
                del self._cache_occupancy[n]
        self._cached_now = min(
            sum(self._cache_occupancy.values()), self.cache_region_bytes
        )

    def _check_final(self) -> None:
        if not self._finalized:
            raise RuntimeError("call finalize() before stepping the runtime")


def run_iterative(
    runtime: DolmaRuntime,
    n_iters: int,
    body: Callable[[DolmaRuntime, int], None],
) -> float:
    """Drive ``body`` for ``n_iters`` steps; return total simulated us.

    This is the single iteration driver (``repro_torch.hpc.base.run_workload``
    wraps it): in pipeline mode the first iteration doubles as the
    warmup-trace pass — the runtime records the access order the body emits
    through fetch/commit, and from the second iteration on that trace drives
    the sliding prefetch window.

    Auto-sizing mode: a runtime still carrying ``local_fraction="auto"`` is
    finalized here (the attached profile feeds the sizing solver) so callers
    driving the loop directly get the advised budget without extra plumbing.
    """
    if runtime.local_fraction == "auto" and not runtime._finalized:
        runtime.finalize()
    for it in range(n_iters):
        with runtime.step():
            body(runtime, it)
    # drain async writes so the reported time includes any tail demotion
    runtime.drain()
    return runtime.elapsed_us()
