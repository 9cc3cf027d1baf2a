"""Two-level RDMA scheduling (§4.3).

Lower level: threads are organized into *clusters*; each cluster owns a
dedicated fabric resource (QP), preventing system-wide contention. Upper
level: threads within a cluster coordinate through the cluster's shared
queue (modeled by the resource's serialization) while keeping private local
buffers.

With a multi-node :class:`~repro_torch.core.pool.MemoryPool` attached, a cluster
maps to a *node preference* rather than a single QP: the cluster's ops land
on its preferred node's least-loaded QP, failing over to the next alive node
— congestion-aware routing at the cluster level (DESIGN.md §2–§3).

The TPU-scale analogue (documented in DESIGN.md §2) is the mesh hierarchy:
`pod` = cluster boundary over DCN, `data`/`model` = intra-cluster ICI.

A copy of ``repro.core.scheduler`` for this package.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

from repro_torch.core.fabric import FabricModel, FabricResource, INFINIBAND_100G, SimClock

if TYPE_CHECKING:  # import cycle guard: pool only needed for typing
    from repro_torch.core.pool import MemoryPool


@dataclasses.dataclass
class ThreadBuffers:
    """Per-thread partition of the local buffer region (§4.3).

    Each OpenMP thread gets an exclusive ``total_bytes // n_threads`` slice,
    further split into two halves when dual buffering is on.
    """

    thread_id: int
    buffer_bytes: int
    dual: bool = True

    @property
    def half_bytes(self) -> int:
        return self.buffer_bytes // 2 if self.dual else self.buffer_bytes


class TwoLevelScheduler:
    """Assign threads to QP clusters; route ops to the right resource."""

    def __init__(
        self,
        *,
        n_threads: int,
        threads_per_cluster: int = 4,
        buffer_bytes: int,
        dual_buffer: bool = True,
        clock: SimClock | None = None,
        fabric: FabricModel = INFINIBAND_100G,
        pool: "MemoryPool | None" = None,
    ) -> None:
        if n_threads < 1:
            raise ValueError("n_threads must be >= 1")
        if threads_per_cluster < 1:
            raise ValueError("threads_per_cluster must be >= 1")
        if pool is not None and clock is not None and pool.clock is not clock:
            raise ValueError("pool and scheduler must share one SimClock")
        self.pool = pool
        self.clock = (
            pool.clock if pool is not None else (clock or SimClock())
        )
        self.n_threads = n_threads
        self.threads_per_cluster = threads_per_cluster
        self.n_clusters = -(-n_threads // threads_per_cluster)
        if pool is None:
            self.resources = [
                FabricResource(self.clock, fabric, name=f"cluster{i}")
                for i in range(self.n_clusters)
            ]
        else:
            # clusters ride the pool's per-node QPs instead of private ones
            self.resources = pool.resources
        per_thread = buffer_bytes // n_threads
        self.buffers = [
            ThreadBuffers(t, per_thread, dual=dual_buffer) for t in range(n_threads)
        ]

    def cluster_of(self, thread_id: int) -> int:
        return thread_id // self.threads_per_cluster

    def node_of_cluster(self, cluster: int) -> int:
        """Preferred memory node of a cluster (pool mode only)."""
        if self.pool is None:
            raise ValueError("no MemoryPool attached")
        alive = self.pool.alive_nodes()
        if not alive:
            raise ValueError("no alive memory nodes")
        return alive[cluster % len(alive)].node_id

    def resource_of(self, thread_id: int) -> FabricResource:
        """The QP a thread's ops land on.

        Single-node mode: the cluster's dedicated QP (the paper's §4.3
        design). Pool mode: the *least-loaded QP of the cluster's preferred
        node* — node preference spreads clusters over the pool, while the
        earliest-``free_at`` pick absorbs transient congestion.
        """
        if self.pool is None:
            return self.resources[self.cluster_of(thread_id)]
        node_id = self.node_of_cluster(self.cluster_of(thread_id))
        return self.pool.nodes[node_id].least_loaded_resource()

    def timeline(self, thread_id: int) -> str:
        return f"thread{thread_id}"

    # -- simulation of a parallel iterative workload -------------------------
    def simulate(
        self,
        *,
        n_iters: int,
        compute_us_total: float,
        fetch_bytes_total: int,
        write_bytes_total: int = 0,
        parallel_efficiency: float = 1.0,
        dual_buffer: bool | None = None,
    ) -> float:
        """Makespan (us) of an OpenMP-style iterative loop under this scheduler.

        Work is split evenly across threads (private objects, §4.3). Each
        iteration, a thread computes then fetches its next-iteration slice
        (overlapped when dual buffering). ``parallel_efficiency`` models the
        workload's intrinsic scaling (Amdahl residue), applied identically to
        oracle and DOLMA runs so comparisons isolate the fabric effects.
        """
        dual = self.buffers[0].dual if dual_buffer is None else dual_buffer
        n = self.n_threads
        # Amdahl: parallel fraction = parallel_efficiency
        p = parallel_efficiency
        compute_us = compute_us_total * ((1 - p) + p / n)  # per-iter, per-thread
        fetch_per_thread = fetch_bytes_total // n
        write_per_thread = write_bytes_total // n

        for t in range(n):
            tl = self.timeline(t)
            half = max(self.buffers[t].half_bytes, 1)
            covered = min(fetch_per_thread, half) if dual else 0
            pending_fetch_done = 0.0
            # iteration 0 fetch is never hidden
            for it in range(n_iters):
                # re-routed every iteration: in pool mode this lands on the
                # preferred node's least-loaded QP as congestion evolves
                res = self.resource_of(t)
                now = self.clock.now(tl)
                if dual and it > 0:
                    # barrier on the prefetched (buffer-half-bounded) portion
                    now = self.clock.wait_until(tl, pending_fetch_done)
                    demand = fetch_per_thread - covered
                else:
                    demand = fetch_per_thread
                if demand > 0:
                    done = self._chunked(res, "read", demand, half, now,
                                         pipelined="windowed")
                    now = self.clock.wait_until(tl, done)
                if dual and it + 1 < n_iters:
                    # prefetch next iteration into the idle half, overlapping
                    # with this iteration's compute (issued now)
                    pending_fetch_done = self._chunked(
                        res, "read", covered, max(covered // 8, 4096), now
                    )
                now = self.clock.advance(tl, compute_us)
                if write_per_thread:
                    # async write-back: issue, don't wait (§4.2)
                    self._chunked(res, "write", write_per_thread, half, now)
        return self.clock.makespan()

    def _chunked(
        self, res: FabricResource, kind: str, total: int, chunk: int,
        t_issue: float, *, pipelined: bool = True,
    ) -> float:
        """Issue ``total`` bytes as buffer-sized chunks; return completion."""
        if total <= 0:
            return t_issue
        _s, end = res.issue_stream(kind, total, chunk, t_issue,
                                   pipelined=pipelined)
        return end
