"""Multi-node remote memory pool: striping, replication, routing, recovery.

The seed modeled DOLMA's remote tier as a single memory node. This module
generalizes it to the rack-scale pool the disaggregation literature assumes
(Maruf & Chowdhury's survey; Wahlgren et al.'s HPC adoption study): N memory
nodes share one :class:`~repro_torch.core.fabric.SimClock`, and a
:class:`MemoryPool` fronts them behind the same read/write/fence/atomic API
as a single :class:`~repro_torch.core.remote_store.RemoteStore`, so every existing
consumer (``DolmaRuntime``, the HPC workloads, the serving engine) can be
pointed at a pool unchanged.

Mechanisms:

  * **striping** — each object is split into fixed-size *extents* laid out
    round-robin from a deterministic home node; a large-object fetch issues
    one read per extent on different nodes' QPs concurrently, so effective
    bandwidth scales with node count (completion = max over nodes instead of
    sum on one QP);
  * **replication** — each extent is written to ``replication`` distinct
    nodes; reads are served from the replica whose least-loaded QP frees up
    earliest (read-from-least-loaded-replica);
  * **congestion-aware routing** — every placement decision (replica choice,
    QP choice within a node) keys on ``FabricResource.free_at``, the
    discrete-event analogue of queue depth on a NIC;
  * **failure injection + recovery** — :meth:`fail_node` kills a node at a
    sim-time and drops its data; reads transparently fail over to surviving
    replicas; :meth:`recover` re-replicates degraded extents from survivors
    (charging read+write fabric time) or restores singly-homed extents from
    a checkpoint blob set (the ``checkpoint.manager`` metadata path);
  * **elastic capacity** — :meth:`add_nodes` grows the pool and
    :meth:`drain_node` shrinks it; both drive :meth:`rebalance`, a
    make-before-break extent migration onto the canonical striped layout
    over the new membership (new replicas are allocated and committed
    before old ones are freed, so every object stays bit-identically
    readable throughout, and migration runs on its own timeline so
    in-flight reads on the main timeline never block on it);
  * **slab allocation** — *where on a node* each extent replica lives is
    decided by a :class:`~repro_torch.core.alloc.SlabAllocator`: power-of-two
    size classes over the stripe, one arena per client (``alloc(...,
    client=...)``), explicit internal/external fragmentation accounting,
    and :meth:`compact` — background folding of sparse slabs on its own
    timeline, reusing the make-before-break discipline (copy charged
    before the old slot is released) so reads stay bit-identical.

Every transfer both moves real bytes (numpy) and charges the fabric model,
so pool-backed workloads stay bit-exact against untiered oracles while the
clock reflects rack-scale contention.

A copy of ``repro.core.pool`` for this package, numpy as there. Recovery
from checkpoint blobs (``from_blobs``) is here; the ``CheckpointManager``
that writes them waits for the training slice.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Mapping

import numpy as np

from repro_torch.core.alloc import (
    DEFAULT_ARENA,
    DEFAULT_STRIPE_BYTES,
    SlabAllocator,
)
from repro_torch.core.fabric import (
    FabricModel,
    FabricResource,
    INFINIBAND_100G,
    SimClock,
)
from repro_torch.core.remote_store import NodeFailure, RemoteStore
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry


class OrphanExtentError(RuntimeError):
    """A node holds extent keys the directory/allocator don't account for."""


class ExtentLostError(RuntimeError):
    """All replicas of an extent are gone and no recovery source was given."""


def _home_of(name: str, n_nodes: int) -> int:
    """Deterministic home node for an object (stable across runs/processes)."""
    return zlib.crc32(name.encode()) % n_nodes


def _striped_replicas(home: int, index: int, alive_ids: list[int],
                      k: int) -> list[int]:
    """The canonical replica walk: extent ``index`` of an object homed at
    ``home`` starts at ``(home + index) % N`` over the alive membership and
    takes the next ``k`` nodes. Shared by :meth:`MemoryPool.alloc` and
    :meth:`MemoryPool.rebalance` so a rebalanced object is laid out exactly
    as if freshly allocated."""
    start = (home + index) % len(alive_ids)
    return [alive_ids[(start + r) % len(alive_ids)] for r in range(k)]


@dataclasses.dataclass
class Extent:
    """One stripe of an object: ``nbytes`` starting at ``offset``."""

    index: int
    offset: int
    nbytes: int
    replicas: list[int]  # node ids holding a copy; order = placement order

    def key(self, name: str) -> str:
        """Per-extent store key: ``<object-name>#e<extent-index>``."""
        return f"{name}#e{self.index}"


@dataclasses.dataclass
class PoolObject:
    """Directory entry: where every extent of a logical object lives."""

    name: str
    shape: tuple[int, ...]
    dtype: np.dtype
    nbytes: int
    home: int
    extents: list[Extent]
    arena: str = DEFAULT_ARENA  # owning client's allocator arena


class MemoryPool:
    """N remote memory nodes behind a single-store API (drop-in for
    :class:`RemoteStore` everywhere the runtime stack takes one)."""

    def __init__(
        self,
        n_nodes: int = 2,
        *,
        clock: SimClock | None = None,
        fabric: FabricModel = INFINIBAND_100G,
        stripe_bytes: int = DEFAULT_STRIPE_BYTES,
        replication: int = 1,
        qps_per_node: int = 1,
        node_capacity_bytes: int | None = None,
        telemetry: Telemetry | None = None,
    ) -> None:
        if n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        if replication < 1:
            raise ValueError("replication must be >= 1")
        if stripe_bytes < 4096:
            raise ValueError("stripe_bytes must be >= 4096 (one page)")
        self.clock = clock or SimClock()
        self.fabric = fabric
        self.stripe_bytes = stripe_bytes
        self.replication = min(replication, n_nodes)
        self.qps_per_node = qps_per_node
        self.node_capacity_bytes = node_capacity_bytes
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        if self.telemetry.enabled:
            self.telemetry.bind_clock(self.clock)
        self.nodes = [self._new_node(i) for i in range(n_nodes)]
        self._directory: dict[str, PoolObject] = {}
        # intra-node slab/slot bookkeeping for every extent replica; all
        # node-level placement goes through _place_replica/_release_replica
        # so the allocator's view never drifts from the nodes' contents
        self._allocator = SlabAllocator(stripe_bytes=stripe_bytes)
        self._failures: list[dict] = []
        self._resizes: list[dict] = []
        self._compactions: list[dict] = []

    def _new_node(self, node_id: int) -> RemoteStore:
        return RemoteStore(
            clock=self.clock,
            fabric=self.fabric,
            n_resources=self.qps_per_node,
            node_id=node_id,
            capacity_bytes=self.node_capacity_bytes,
            telemetry=self.telemetry,
        )

    # -- topology ----------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        """Total node count, alive or failed (ids are never reused)."""
        return len(self.nodes)

    def alive_nodes(self) -> list[RemoteStore]:
        """Nodes currently serving traffic (failed ones filtered out)."""
        return [n for n in self.nodes if n.alive]

    @property
    def resources(self) -> list[FabricResource]:
        """All QPs of all alive nodes (scheduler/runtime compatibility)."""
        return [r for n in self.nodes if n.alive for r in n.resources]

    def node_of_extent(self, name: str, index: int) -> list[int]:
        """Node ids holding replicas of extent ``index`` (placement order)."""
        return list(self._directory[name].extents[index].replicas)

    # -- allocation ---------------------------------------------------------
    def _place_replica(self, node_id: int, key: str, data: np.ndarray,
                       arena: str) -> None:
        """Land one extent replica on a node *and* seat it in the slab
        allocator — the single choke point keeping both views consistent.
        Raises like ``RemoteStore.alloc`` (capacity stays byte-enforced
        there); on success the allocator holds exactly one slot for it."""
        self.nodes[node_id].alloc(key, data)
        self._allocator.place(node_id, key, data.nbytes, arena=arena)

    def _release_replica(self, node_id: int, key: str) -> None:
        self.nodes[node_id].free(key)
        self._allocator.release(node_id, key)

    def alloc(
        self,
        name: str,
        array: np.ndarray,
        *,
        home: int | None = None,
        client: str | None = None,
    ) -> None:
        """Stripe ``array`` across the pool from its home node.

        Extent *e* of an object homed at *h* has its primary on node
        ``(h + e) % N`` and replicas on the following alive nodes — so a
        full-object read touches every node once per stripe-period.
        ``client`` names the allocator arena the extents are seated in
        (one per tenant); unattributed allocations share a default arena.
        """
        if name in self._directory:
            raise ValueError(f"pool object {name!r} exists")
        arena = client if client is not None else DEFAULT_ARENA
        array = np.asarray(array)
        flat = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
        alive = [n.node_id for n in self.alive_nodes()]
        if not alive:
            raise NodeFailure("no alive memory nodes in the pool")
        h = home if home is not None else _home_of(name, self.n_nodes)
        k = min(self.replication, len(alive))
        extents: list[Extent] = []
        placed: list[tuple[int, str]] = []  # (node_id, key) for rollback
        try:
            for idx, off in enumerate(
                range(0, max(flat.nbytes, 1), self.stripe_bytes)
            ):
                chunk = flat[off : off + self.stripe_bytes]
                ext = Extent(index=idx, offset=off, nbytes=chunk.nbytes,
                             replicas=_striped_replicas(h, idx, alive, k))
                for node_id in ext.replicas:
                    self._place_replica(node_id, ext.key(name), chunk, arena)
                    placed.append((node_id, ext.key(name)))
                extents.append(ext)
                if flat.nbytes == 0:
                    break
        except MemoryError:
            # atomic alloc: a node running out of capacity mid-stripe must
            # not leak orphan extents the directory doesn't know about —
            # node objects and allocator slots roll back together
            for node_id, key in placed:
                self._release_replica(node_id, key)
            raise
        self._directory[name] = PoolObject(
            name=name,
            shape=tuple(array.shape),
            dtype=array.dtype,
            nbytes=flat.nbytes,
            home=h,
            extents=extents,
            arena=arena,
        )
        self._update_frag_gauges()

    def free(self, name: str) -> None:
        """Release every replica extent of ``name``; no-op if absent."""
        po = self._directory.pop(name, None)
        if po is None:
            return
        for ext in po.extents:
            for node_id in ext.replicas:
                self._release_replica(node_id, ext.key(name))
        self._update_frag_gauges()

    def __contains__(self, name: str) -> bool:
        return name in self._directory

    def names(self) -> list[str]:
        """Logical objects currently in the pool (directory order)."""
        return list(self._directory)

    def nbytes(self, name: str) -> int:
        """Logical payload size of ``name`` in bytes (KeyError if absent)."""
        return self._directory[name].nbytes

    def total_bytes(self) -> int:
        """Logical bytes stored (replicas not double-counted)."""
        return sum(po.nbytes for po in self._directory.values())

    def physical_bytes(self) -> int:
        """Bytes resident across nodes, replicas included."""
        return sum(n.total_bytes() for n in self.nodes)

    # -- routing ------------------------------------------------------------
    def _live_replicas(self, name: str, ext: Extent) -> list[int]:
        key = ext.key(name)
        return [
            nid for nid in ext.replicas
            if self.nodes[nid].alive and key in self.nodes[nid]
        ]

    def _pick_replica(self, name: str, ext: Extent) -> tuple[RemoteStore, FabricResource]:
        """Least-loaded live replica: minimize earliest-free-QP time."""
        live = self._live_replicas(name, ext)
        if not live:
            raise ExtentLostError(
                f"extent {ext.key(name)} lost: no live replica "
                f"(had {ext.replicas}); run MemoryPool.recover()"
            )
        best = min(
            (self.nodes[nid] for nid in live),
            key=lambda node: (node.least_loaded_resource().free_at, node.node_id),
        )
        return best, best.least_loaded_resource()

    def _projected_cost(self) -> dict[int, float]:
        """Per-node routing cost seed: when each node's best QP frees up."""
        return {
            n.node_id: n.least_loaded_resource().free_at
            for n in self.alive_nodes()
        }

    def _node_shares(
        self, name: str, cost: dict[int, float] | None = None
    ) -> dict[int, int]:
        """bytes served per node for a full read, after replica selection.

        Replica choice must account for bytes this very transfer has already
        assigned (all extents issue at the same sim-time, so ``free_at``
        alone never advances between picks): otherwise, under replication,
        every extent ties to the same lowest-id node and a striped read
        collapses onto one QP. Passing a shared ``cost`` dict lets a batched
        read spread *several* objects' extents over the pool the same way.
        """
        po = self._directory[name]
        line_bpus = (self.fabric.read_line_gbps or self.fabric.read_gbps) * 1e3
        if cost is None:
            cost = self._projected_cost()
        shares: dict[int, int] = {}
        for ext in po.extents:
            live = self._live_replicas(name, ext)
            if not live:
                raise ExtentLostError(
                    f"extent {ext.key(name)} lost: no live replica "
                    f"(had {ext.replicas}); run MemoryPool.recover()"
                )
            nid = min(live, key=lambda i: (cost[i], i))
            shares[nid] = shares.get(nid, 0) + ext.nbytes
            cost[nid] += ext.nbytes / line_bpus  # projected queue growth
        return shares

    # -- data path ----------------------------------------------------------
    def read(
        self,
        name: str,
        *,
        timeline: str = "main",
        resource: FabricResource | None = None,
        offset: int = 0,
        nbytes: int | None = None,
        issue_at_us: float | None = None,
        sync: bool = True,
    ) -> tuple[np.ndarray, float]:
        """Striped one-sided read; returns (data, completion_time_us).

        Every extent overlapping ``[offset, offset+nbytes)`` is read from its
        least-loaded live replica; all extent reads are issued at the same
        sim-time so distinct nodes' fabric resources run concurrently —
        completion is the max over extents, which is what makes aggregate
        bandwidth scale with node count.
        """
        po = self._directory[name]
        if nbytes is None:
            nbytes = po.nbytes - offset
        t_issue = self.clock.now(timeline) if issue_at_us is None else issue_at_us
        out = np.empty(nbytes, dtype=np.uint8)
        end = t_issue
        for ext in po.extents:
            lo = max(offset, ext.offset)
            hi = min(offset + nbytes, ext.offset + ext.nbytes)
            if lo >= hi:
                continue
            node, qp = self._pick_replica(name, ext)
            chunk, ext_end = node.read(
                ext.key(name),
                timeline=timeline,
                resource=qp,
                offset=lo - ext.offset,
                nbytes=hi - lo,
                issue_at_us=t_issue,
                sync=False,
            )
            out[lo - offset : hi - offset] = chunk
            end = max(end, ext_end)
        if sync:
            self.clock.wait_until(timeline, end)
        return out, end

    def read_object(
        self, name: str, *, timeline: str = "main",
        resource: FabricResource | None = None,
    ) -> tuple[np.ndarray, float]:
        """Fetch the whole object (shaped), synchronously."""
        po = self._directory[name]
        raw, end = self.read(name, timeline=timeline, resource=resource)
        return raw.view(po.dtype).reshape(po.shape), end

    def write(
        self,
        name: str,
        array: np.ndarray,
        *,
        timeline: str = "main",
        resource: FabricResource | None = None,
        epoch: int | None = None,
        sync: bool = False,
    ) -> float:
        """Striped one-sided write to *all* live replicas. Async by default."""
        po = self._directory[name]
        array = np.asarray(array)
        if array.nbytes != po.nbytes:
            raise ValueError(
                f"size mismatch writing {name!r}: {array.nbytes} != {po.nbytes}"
            )
        flat = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
        t_issue = self.clock.now(timeline)
        end = t_issue
        for ext in po.extents:
            chunk = flat[ext.offset : ext.offset + ext.nbytes]
            live = self._live_replicas(name, ext)
            if not live:
                # match read semantics: a write to a lost extent must not
                # silently report success
                raise ExtentLostError(
                    f"extent {ext.key(name)} lost: cannot write; "
                    f"run MemoryPool.recover()"
                )
            for nid in live:
                node = self.nodes[nid]
                qp = node.least_loaded_resource()
                _s, ext_end = qp.issue("write", ext.nbytes, t_issue)
                node.commit_payload(ext.key(name), chunk,
                                    pending_until=ext_end, epoch=epoch)
                end = max(end, ext_end)
        if sync:
            self.clock.wait_until(timeline, end)
        return end

    def fence(self, names: Iterable[str] | None = None, *, timeline: str = "main") -> float:
        """Wait for pending writes on all (or the given) logical objects."""
        if names is None:
            t = 0.0
            for node in self.alive_nodes():
                t = max(t, node.fence(timeline=timeline))
            return self.clock.wait_until(timeline, t)
        t = 0.0
        for name in names:
            po = self._directory.get(name)
            if po is None:
                continue  # freed concurrently — nothing to order against
            for ext in po.extents:
                key = ext.key(name)
                for nid in ext.replicas:
                    if self.nodes[nid].alive:
                        t = max(t, self.nodes[nid].pending_until(key))
        return self.clock.wait_until(timeline, t)

    # -- stream accessors (DolmaRuntime's chunked fetch/commit path) --------
    def payload(self, name: str) -> np.ndarray:
        """Reassemble the object's current data (shaped); no fabric charge."""
        po = self._directory[name]
        out = np.empty(po.nbytes, dtype=np.uint8)
        for ext in po.extents:
            live = self._live_replicas(name, ext)
            if not live:
                raise ExtentLostError(
                    f"extent {ext.key(name)} lost; run MemoryPool.recover()"
                )
            chunk = self.nodes[live[0]].payload(ext.key(name))
            out[ext.offset : ext.offset + ext.nbytes] = chunk.reshape(-1).view(np.uint8)
        return out.view(po.dtype).reshape(po.shape)

    def pending_until(self, name: str) -> float:
        """Latest simulated time (us) an async write to ``name`` lands; 0 if idle."""
        po = self._directory.get(name)
        if po is None:
            return 0.0
        t = 0.0
        for ext in po.extents:
            key = ext.key(name)
            for nid in ext.replicas:
                t = max(t, self.nodes[nid].pending_until(key))
        return t

    def least_loaded_resource(self) -> FabricResource:
        """The alive QP that frees up earliest on the simulated clock."""
        res = self.resources
        if not res:
            raise NodeFailure("no alive memory nodes in the pool")
        return min(res, key=lambda r: (r.free_at, r.name))

    def stream_read(
        self,
        name: str,
        *,
        nbytes: int | None = None,
        chunk_bytes: int,
        issue_at: float,
        mode: str = "windowed",
        resource: FabricResource | None = None,
    ) -> float:
        """Charge a chunked read of ``nbytes``, striped across the pool.

        The transfer is split over the nodes that would serve each extent
        (replica-selected), proportionally to the bytes they hold; each
        node's share streams on its least-loaded QP concurrently, so a
        partial fetch pipelines over multiple nodes' fabric resources.
        """
        po = self._directory[name]
        # nbytes may exceed the real po.nbytes under sim scaling (the caller
        # charges modeled bytes); shares below are proportions, scale-free
        size = po.nbytes if nbytes is None else nbytes
        if size <= 0:
            return issue_at
        shares = self._node_shares(name)
        total = sum(shares.values()) or 1
        t0 = max(issue_at, self.pending_until(name))
        end = t0
        for nid in sorted(shares):
            node_bytes = size * shares[nid] // total
            if node_bytes <= 0:
                continue
            node = self.nodes[nid]
            qp = node.least_loaded_resource()
            _s, node_end = qp.issue_stream("read", node_bytes, chunk_bytes, t0,
                                           pipelined=mode)
            end = max(end, node_end)
        return end

    def stream_read_batch(
        self,
        requests: list[tuple[str, int]],
        *,
        chunk_bytes: int,
        issue_at: float,
        mode: str = "pipelined",
        resource: FabricResource | None = None,
    ) -> dict[str, float]:
        """Coalesced scatter-gather read across the pool.

        All requests' extents are replica-routed against one shared
        projected-cost view (so the whole window spreads over the nodes,
        not just each object individually), then every node streams its
        combined share as a *single* posted op. A request completes when
        the slowest node serving it reaches the end of that request's
        portion of the node's stream — earlier window entries still
        unblock first.
        """
        if not requests:
            return {}
        cost = self._projected_cost()
        t0 = issue_at
        # per node: (request_index, node_bytes) in batch order
        per_node: dict[int, list[tuple[int, int]]] = {}
        for i, (name, nbytes) in enumerate(requests):
            if name not in self._directory:
                raise KeyError(name)
            t0 = max(t0, self.pending_until(name))  # RAW for the whole batch
            if nbytes <= 0:
                continue
            shares = self._node_shares(name, cost)
            total_real = sum(shares.values()) or 1
            for nid in sorted(shares):
                # nbytes may be sim-scaled; shares are proportions (scale-free)
                node_bytes = int(nbytes) * shares[nid] // total_real
                if node_bytes > 0:
                    per_node.setdefault(nid, []).append((i, node_bytes))
        out = {name: t0 for name, _ in requests}
        for nid in sorted(per_node):
            node = self.nodes[nid]
            qp = node.least_loaded_resource()
            entries = per_node[nid]
            _s, completions, _end = qp.issue_batch(
                "read", [nb for _, nb in entries], chunk_bytes, t0, mode=mode
            )
            for (i, _), done in zip(entries, completions):
                name = requests[i][0]
                out[name] = max(out[name], done)
        return out

    def stream_write(
        self,
        name: str,
        array: np.ndarray,
        *,
        chunk_bytes: int,
        issue_at: float,
        mode: str = "pipelined",
        epoch: int | None = None,
        resource: FabricResource | None = None,
        charge_bytes: int | None = None,
    ) -> float:
        """Chunked async write: each replica node streams its share once.

        ``charge_bytes`` (sim-scaled callers) is split across nodes in
        proportion to the real bytes each holds.
        """
        po = self._directory[name]
        array = np.asarray(array)
        if array.nbytes != po.nbytes:
            raise ValueError(
                f"size mismatch writing {name!r}: {array.nbytes} != {po.nbytes}"
            )
        total_charge = charge_bytes or po.nbytes
        flat = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
        # group extents by replica node: one stream per node, then land data
        per_node: dict[int, list[Extent]] = {}
        for ext in po.extents:
            live = self._live_replicas(name, ext)
            if not live:
                raise ExtentLostError(
                    f"extent {ext.key(name)} lost: cannot write; "
                    f"run MemoryPool.recover()"
                )
            for nid in live:
                per_node.setdefault(nid, []).append(ext)
        end = issue_at
        for nid in sorted(per_node):
            node = self.nodes[nid]
            exts = per_node[nid]
            node_bytes = sum(e.nbytes for e in exts)
            node_charge = max(total_charge * node_bytes // max(po.nbytes, 1), 1)
            qp = node.least_loaded_resource()
            _s, node_end = qp.issue_stream("write", node_charge, chunk_bytes,
                                           issue_at, pipelined=mode)
            for ext in exts:
                node.commit_payload(
                    ext.key(name), flat[ext.offset : ext.offset + ext.nbytes],
                    pending_until=node_end, epoch=epoch,
                )
            end = max(end, node_end)
        return end

    # -- atomics (routed by key hash over the *full* node list) --------------
    def _atomic_node(self, key: str) -> RemoteStore:
        """Home node of an atomic: hash over all N nodes, probing forward
        past dead ones. Hashing over the alive list would remap every key
        whenever unrelated membership changes — silently reading 0 from a
        different node while the real counter sits on a healthy one."""
        start = zlib.crc32(key.encode()) % self.n_nodes
        for step in range(self.n_nodes):
            node = self.nodes[(start + step) % self.n_nodes]
            if node.alive:
                return node
        raise NodeFailure("no alive memory nodes in the pool")

    def atomic_fetch_add(self, key: str, delta: int, *, timeline: str = "main") -> int:
        """Serialized fetch-add on a small shared object; returns the old value."""
        return self._atomic_node(key).atomic_fetch_add(key, delta, timeline=timeline)

    def atomic_cas(self, key: str, expected: int, new: int, *, timeline: str = "main") -> bool:
        """Compare-and-swap on a shared object; True iff the swap happened."""
        return self._atomic_node(key).atomic_cas(key, expected, new, timeline=timeline)

    def atomic_read(self, key: str) -> int:
        """Read a shared atomic's current value (synchronous, serialized)."""
        return self._atomic_node(key).atomic_read(key)

    # -- failure injection + recovery ---------------------------------------
    def fail_node(self, node_id: int, *, at_us: float | None = None,
                  timeline: str = "main") -> None:
        """Kill node ``node_id`` at sim-time (its extents are lost)."""
        t = self.clock.now(timeline) if at_us is None else at_us
        self.nodes[node_id].fail(at_us=t)
        self._allocator.drop_node(node_id)
        self._failures.append({"node": node_id, "at_us": t})
        self.telemetry.instant("node_fail", track=timeline, t_us=t,
                               node=node_id)
        self.telemetry.count("pool.node_failures")

    def degraded_extents(self) -> list[tuple[str, Extent]]:
        """Extents with fewer live replicas than the pool's target k."""
        out = []
        k = min(self.replication, max(len(self.alive_nodes()), 1))
        for name, po in self._directory.items():
            for ext in po.extents:
                if len(self._live_replicas(name, ext)) < k:
                    out.append((name, ext))
        return out

    def recover(
        self,
        *,
        timeline: str = "recovery",
        from_blobs: Mapping[str, np.ndarray] | None = None,
    ) -> dict:
        """Rebuild degraded extents onto surviving nodes, charging sim time.

        Each degraded extent is re-replicated up to the target k: copied from
        a surviving replica (read on the source QP + write on the target QP,
        both charged), or — when every replica died — restored from
        ``from_blobs`` (a ``{name: array}`` checkpoint snapshot, e.g.
        ``CheckpointManager.restore_store_blobs()``), charging the write leg.
        Returns counters and the recovery makespan.
        """
        alive_ids = [n.node_id for n in self.alive_nodes()]
        if not alive_ids:
            raise NodeFailure("cannot recover: no alive memory nodes")
        k = min(self.replication, len(alive_ids))
        t0 = self.clock.now(timeline)
        rebuilt = restored = skipped = 0
        end = t0
        for name, po in self._directory.items():
            flat_blob: np.ndarray | None = None
            for ext in po.extents:
                live = self._live_replicas(name, ext)
                full_targets: set[int] = set()  # nodes without room for it
                while len(live) < k:
                    target_id = min(
                        (i for i in alive_ids
                         if i not in live and i not in full_targets),
                        key=lambda i: (self.nodes[i].stored_bytes(), i),
                        default=None,
                    )
                    if target_id is None:
                        # no node can take another replica (too few alive, or
                        # the rest are at capacity): leave the extent at its
                        # current replica count instead of aborting recovery
                        if full_targets:
                            skipped += 1
                        break
                    target = self.nodes[target_id]
                    key = ext.key(name)
                    if live:
                        # copy from the least-loaded survivor: read then write
                        src = self.nodes[min(
                            live,
                            key=lambda i: (
                                self.nodes[i].least_loaded_resource().free_at, i
                            ),
                        )]
                        read_end = src.stream_read(
                            key, chunk_bytes=self.stripe_bytes,
                            issue_at=self.clock.now(timeline), mode="pipelined",
                        )
                        data = src.payload(key)
                        from_replica = True
                    else:
                        if from_blobs is None or name not in from_blobs:
                            raise ExtentLostError(
                                f"extent {key} has no live replica and no "
                                f"checkpoint blob for {name!r}"
                            )
                        if flat_blob is None:
                            blob = np.asarray(from_blobs[name])
                            if blob.nbytes != po.nbytes:
                                raise ValueError(
                                    f"checkpoint blob for {name!r}: "
                                    f"{blob.nbytes} B != {po.nbytes} B"
                                )
                            flat_blob = (
                                np.ascontiguousarray(blob).reshape(-1).view(np.uint8)
                            )
                        data = flat_blob[ext.offset : ext.offset + ext.nbytes]
                        # staging a checkpoint blob back in pays the write leg
                        read_end = self.clock.now(timeline)
                        from_replica = False
                    try:
                        self._place_replica(target_id, key, data, po.arena)
                    except MemoryError:
                        # target is at capacity: try the next candidate
                        full_targets.add(target_id)
                        continue
                    if from_replica:
                        rebuilt += 1
                    else:
                        restored += 1
                    qp = target.least_loaded_resource()
                    _s, w_end = qp.issue("write", ext.nbytes, read_end)
                    target.commit_payload(key, data, pending_until=w_end)
                    self.clock.wait_until(timeline, w_end)
                    end = max(end, w_end)
                    ext.replicas = [i for i in ext.replicas
                                    if self.nodes[i].alive] + [target_id]
                    live = self._live_replicas(name, ext)
        stats = {
            "rebuilt_extents": rebuilt,
            "restored_extents": restored,
            "skipped_extents": skipped,
            "recovery_us": max(end - t0, 0.0),
            "alive_nodes": len(alive_ids),
        }
        self.telemetry.record_span("recover", track=timeline, begin_us=t0,
                                   end_us=max(end, t0), cat="migration",
                                   **stats)
        self.telemetry.count("pool.rebuilt_extents", rebuilt)
        self.telemetry.count("pool.restored_extents", restored)
        self._update_frag_gauges()
        return stats

    # -- elastic capacity: add/drain nodes with background migration ---------
    def rebalance(
        self, *, timeline: str = "migration", exclude: Iterable[int] = ()
    ) -> dict:
        """Migrate every extent onto the canonical layout over the current
        alive membership (minus ``exclude``), make-before-break.

        For each extent: new replicas are copied from a least-loaded live
        source (read charged on the source QP, write on the target QP) and
        committed *before* any old copy is freed, so reads stay bit-identical
        at every intermediate state. A target at physical capacity falls back
        to retaining an old replica instead (the extent is then reported in
        ``retained_extents``). Runs on its own ``timeline`` so the main
        timeline's in-flight reads are never blocked by migration.
        """
        excluded = set(exclude)
        alive_ids = [n.node_id for n in self.alive_nodes()
                     if n.node_id not in excluded]
        if not alive_ids:
            raise NodeFailure("rebalance: no alive memory nodes to target")
        k = min(self.replication, len(alive_ids))
        t0 = self.clock.now(timeline)
        moved = moved_bytes = retained = 0
        end = t0
        for name, po in self._directory.items():
            for ext in po.extents:
                key = ext.key(name)
                cur = self._live_replicas(name, ext)
                if not cur:
                    raise ExtentLostError(
                        f"extent {key} lost: no live replica "
                        f"(had {ext.replicas}); run MemoryPool.recover() "
                        f"before resizing"
                    )
                targets = _striped_replicas(po.home, ext.index, alive_ids, k)
                if set(targets) == set(cur):
                    ext.replicas = targets
                    continue
                data: np.ndarray | None = None
                placed: list[int] = []
                for tid in targets:
                    if tid in cur:
                        placed.append(tid)
                        continue
                    src = self.nodes[min(
                        cur,
                        key=lambda i: (
                            self.nodes[i].least_loaded_resource().free_at, i
                        ),
                    )]
                    read_end = src.stream_read(
                        key, chunk_bytes=self.stripe_bytes,
                        issue_at=self.clock.now(timeline), mode="pipelined",
                    )
                    if data is None:
                        data = src.payload(key)
                    target = self.nodes[tid]
                    try:
                        self._place_replica(tid, key, data, po.arena)
                    except MemoryError:
                        continue  # at capacity: an old replica is kept below
                    qp = target.least_loaded_resource()
                    _s, w_end = qp.issue("write", ext.nbytes, read_end)
                    target.commit_payload(key, data, pending_until=w_end)
                    self.clock.wait_until(timeline, w_end)
                    end = max(end, w_end)
                    moved += 1
                    moved_bytes += ext.nbytes
                    placed.append(tid)
                # capacity fallback: keep old replicas until k copies exist —
                # preferring non-excluded holders, so a drain never pins a
                # copy on the draining node while freeing a survivor's
                leftovers = sorted(
                    (i for i in cur if i not in placed),
                    key=lambda i: (i in excluded, i),
                )
                while len(placed) < k and leftovers:
                    placed.append(leftovers.pop(0))
                    retained += 1
                for nid in cur:
                    if nid not in placed:
                        self._release_replica(nid, key)
                ext.replicas = placed
        stats = {
            "moved_extents": moved,
            "moved_bytes": moved_bytes,
            "retained_extents": retained,
            "migration_us": max(end - t0, 0.0),
            "n_alive": len(alive_ids),
            "replication": k,
        }
        self.telemetry.record_span("rebalance", track=timeline, begin_us=t0,
                                   end_us=max(end, t0), cat="migration",
                                   **stats)
        self.telemetry.count("pool.moved_extents", moved)
        self.telemetry.count("pool.moved_bytes", moved_bytes)
        self.telemetry.count("pool.migration_us", stats["migration_us"])
        self._update_frag_gauges()
        return stats

    # -- background compaction (slab folding on its own timeline) ------------
    def compact(self, *, timeline: str = "compaction",
                rebalance_after: bool = True) -> dict:
        """Fold sparse slabs together; reads stay bit-identical throughout.

        For every (node, arena, size-class) bin the allocator plans the
        minimal set of intra-node extent moves that leaves at most one
        partial slab (see :meth:`SlabAllocator.plan_compaction`); each move
        is executed make-before-break — the copy into the new slot is
        charged (read + write on the node's QP, on the dedicated
        ``timeline``) *before* the old slot is released — and the extent
        key, its node, and its bytes never change, so any concurrent read
        is served identically at every intermediate state.

        With ``rebalance_after`` (default) a :meth:`rebalance` pass then
        folds any inter-node drift back onto the canonical striped layout,
        reusing the same make-before-break migration machinery — at steady
        state both passes move nothing.
        """
        t0 = self.clock.now(timeline)
        before = self._allocator.stats()
        moves = self._allocator.plan_compaction()
        end = t0
        folded_bytes = 0
        for mv in moves:
            node = self.nodes[mv.node_id]
            if not node.alive:
                continue  # lost the race with a failure: nothing to fold
            qp = node.least_loaded_resource()
            _s, r_end = qp.issue("read", mv.nbytes, self.clock.now(timeline))
            _s2, w_end = qp.issue("write", mv.nbytes, r_end)
            self.clock.wait_until(timeline, w_end)
            end = max(end, w_end)
            self._allocator.apply_move(mv)
            folded_bytes += mv.nbytes
        after = self._allocator.stats()
        stats = {
            "compacted_extents": len(moves),
            "compacted_bytes": folded_bytes,
            "external_frag_before": before["external_frag_bytes"],
            "external_frag_after": after["external_frag_bytes"],
            "freed_slab_bytes": before["held_bytes"] - after["held_bytes"],
            "compaction_us": max(end - t0, 0.0),
        }
        if rebalance_after:
            reb = self.rebalance(timeline=timeline)
            stats["moved_extents"] = reb["moved_extents"]
            stats["moved_bytes"] = reb["moved_bytes"]
        else:
            stats["moved_extents"] = stats["moved_bytes"] = 0
        self._compactions.append(stats)
        self.telemetry.record_span(
            "compact", track=timeline, begin_us=t0, end_us=max(end, t0),
            cat="migration", compacted_extents=stats["compacted_extents"],
            compacted_bytes=folded_bytes,
            external_frag_after=stats["external_frag_after"],
        )
        self.telemetry.count("pool.compactions")
        self.telemetry.count("pool.compacted_extents", len(moves))
        self.telemetry.count("pool.compacted_bytes", folded_bytes)
        self._update_frag_gauges()
        return stats

    def _rehome_atomics(self) -> None:
        """Re-assign every atomic to its current hash target. Atomics route
        by ``crc32(key) % n_nodes`` probing past dead nodes (see
        :meth:`_atomic_node`), so any membership change — growth, slot
        reuse, retirement — can silently move a key's home; after one, the
        counter must follow or reads would return 0 from the new home."""
        moved: dict[str, int] = {}
        for node in self.nodes:
            if node.alive:
                moved.update(node.drain_atomics())
        for key, val in moved.items():
            self._atomic_node(key).adopt_atomics({key: val})

    def add_nodes(self, k: int, *, timeline: str = "migration") -> dict:
        """Grow the pool by ``k`` nodes and re-stripe onto them.

        Retired slots are reused first (an oscillating autoscaler must not
        grow ``self.nodes`` without bound), then fresh nodes are appended;
        either way the node inherits the pool's fabric, QP count, and
        per-node capacity. Existing objects are migrated to the canonical
        striped layout over the enlarged membership (background,
        replica-preserving — see :meth:`rebalance`), so aggregate read
        bandwidth scales with the new node count without a realloc or any
        read unavailability.
        """
        if k < 1:
            raise ValueError("add_nodes: k must be >= 1")
        free_slots = [i for i, n in enumerate(self.nodes) if n.retired][:k]
        new_ids = free_slots + list(
            range(len(self.nodes), len(self.nodes) + k - len(free_slots))
        )
        for nid in new_ids:
            store = self._new_node(nid)
            if nid < len(self.nodes):
                self.nodes[nid] = store
            else:
                self.nodes.append(store)
        self._rehome_atomics()
        stats = self.rebalance(timeline=timeline)
        stats["added_nodes"] = k
        stats["reused_slots"] = len(free_slots)
        self._resizes.append({"op": "add_nodes", "k": k, **stats})
        self.telemetry.instant("resize:add", track=timeline, k=k,
                               n_alive=stats["n_alive"])
        self.telemetry.count("pool.resizes", op="add")
        return stats

    def drain_nodes(self, node_ids: Iterable[int], *,
                    timeline: str = "migration") -> dict:
        """Evacuate and retire several nodes in *one* migration pass.

        Replica-preserving: every extent with a copy on a draining node is
        first re-replicated onto the surviving membership (make-before-break
        via :meth:`rebalance` with the whole set excluded from the target
        layout — shrinking by N costs one re-stripe, not N), atomics homed
        there are re-assigned to their post-drain hash targets, and only
        then are the nodes retired. Raises :class:`MemoryError` — with all
        data still intact and readable — if the survivors lack capacity,
        and :class:`NodeFailure` if there is no survivor to evacuate onto.
        """
        draining = sorted(set(node_ids))
        if not draining:
            raise ValueError("drain_nodes: no node ids given")
        for nid in draining:
            if not self.nodes[nid].alive:
                raise ValueError(f"drain_nodes: node {nid} is not alive")
        survivors = [n for n in self.alive_nodes()
                     if n.node_id not in draining]
        if not survivors:
            # refusal must lose nothing — neither extents nor atomics (peek
            # and put back: drain_atomics is the only enumeration surface)
            held = 0
            for nid in draining:
                atomics_held = self.nodes[nid].drain_atomics()
                self.nodes[nid].adopt_atomics(atomics_held)
                held += len(atomics_held)
            if self._directory or held:
                raise NodeFailure(
                    "drain_nodes: no surviving node to evacuate onto; "
                    "add_nodes first"
                )
            stats = {"moved_extents": 0, "moved_bytes": 0,
                     "retained_extents": 0, "migration_us": 0.0,
                     "n_alive": 0, "replication": 0}
        else:
            stats = self.rebalance(timeline=timeline, exclude=set(draining))
        leftovers = [
            ext.key(name)
            for name, po in self._directory.items()
            for ext in po.extents
            if set(ext.replicas) & set(draining)
        ]
        if leftovers:
            # capacity fallback kept copies on a draining node: refuse to
            # retire it (no data loss) — the caller can add_nodes and retry
            raise MemoryError(
                f"drain_nodes: surviving nodes lack capacity for "
                f"{len(leftovers)} extents (e.g. {leftovers[0]!r}); "
                f"add_nodes first"
            )
        evacuated: dict[str, int] = {}
        for nid in draining:
            evacuated.update(self.nodes[nid].drain_atomics())
            self.nodes[nid].retire()
            self._allocator.drop_node(nid)
        for key, val in evacuated.items():
            self._atomic_node(key).adopt_atomics({key: val})
        stats["drained_nodes"] = draining
        self._resizes.append({"op": "drain_nodes", "nodes": draining, **stats})
        self.telemetry.instant("resize:drain", track=timeline, nodes=draining,
                               n_alive=stats["n_alive"])
        self.telemetry.count("pool.resizes", op="drain")
        return stats

    def drain_node(self, node_id: int, *, timeline: str = "migration") -> dict:
        """Evacuate and retire a single node — see :meth:`drain_nodes`."""
        return self.drain_nodes([node_id], timeline=timeline)

    # -- checkpointing hooks -------------------------------------------------
    def snapshot_objects(self) -> dict[str, np.ndarray]:
        """Logical objects, reassembled (shaped) — CheckpointManager input."""
        return {name: self.payload(name) for name in self._directory}

    def restore_objects(self, blobs: dict[str, np.ndarray]) -> None:
        """Repopulate from a checkpoint snapshot (no fabric charge, like
        :meth:`RemoteStore.restore_objects`); unknown names are allocated."""
        for name, data in blobs.items():
            data = np.asarray(data)
            if name in self._directory:
                po = self._directory[name]
                flat = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
                for ext in po.extents:
                    chunk = flat[ext.offset : ext.offset + ext.nbytes]
                    for nid in self._live_replicas(name, ext):
                        self.nodes[nid].commit_payload(ext.key(name), chunk,
                                                       pending_until=0.0)
            else:
                self.alloc(name, data)

    # -- leak audit ----------------------------------------------------------
    def check_no_orphans(self) -> dict:
        """Audit node contents against the directory and the allocator.

        Raises :class:`OrphanExtentError` if any alive node holds an extent
        key the directory doesn't map to it, if a directory replica points
        at an alive node that lost the bytes, or if the slab allocator's
        bookkeeping has drifted from the nodes' actual contents (including
        keys still charged to failed/retired nodes). Returns audit counters
        when clean — call it after failed mid-stripe allocs, drains, and
        recovery, where a rollback bug would otherwise leak quietly.
        """
        expected: dict[int, set[str]] = {}
        for name, po in self._directory.items():
            for ext in po.extents:
                for nid in ext.replicas:
                    expected.setdefault(nid, set()).add(ext.key(name))
        problems: list[str] = []
        audited = replicas = 0
        for node in self.nodes:
            alloc_keys = set(self._allocator.keys_on(node.node_id))
            if not node.alive:
                if alloc_keys:
                    problems.append(
                        f"allocator still charges dead node {node.node_id} "
                        f"for {sorted(alloc_keys)[:3]}..."
                    )
                continue
            audited += 1
            held = set(node.object_names())
            exp = expected.get(node.node_id, set())
            replicas += len(held)
            if held - exp:
                problems.append(
                    f"node {node.node_id}: orphan extents outside the "
                    f"directory: {sorted(held - exp)[:5]}"
                )
            if exp - held:
                problems.append(
                    f"node {node.node_id}: directory replicas missing from "
                    f"the node: {sorted(exp - held)[:5]}"
                )
            if alloc_keys != held:
                drift = alloc_keys.symmetric_difference(held)
                problems.append(
                    f"node {node.node_id}: allocator/node drift on "
                    f"{sorted(drift)[:5]}"
                )
            for key in held & alloc_keys:
                if self._allocator.nbytes_of(node.node_id, key) != \
                        node.nbytes(key):
                    problems.append(
                        f"node {node.node_id}: size drift on {key!r}"
                    )
        if problems:
            raise OrphanExtentError("; ".join(problems))
        return {"nodes_audited": audited, "extent_replicas": replicas,
                "objects": len(self._directory)}

    # -- fragmentation accounting --------------------------------------------
    def fragmentation_stats(self) -> dict:
        """The allocator's pool-wide view plus a per-alive-node average —
        the quantity effective-capacity pricing subtracts from raw node
        capacity (`sizing.pool_nodes_needed`)."""
        s = self._allocator.stats()
        alive = len(self.alive_nodes())
        s["frag_bytes_per_node"] = (s["frag_bytes"] / alive) if alive else 0.0
        s["per_arena"] = self._allocator.arena_stats()
        return s

    def arena_stats(self) -> dict[str, dict]:
        """Per-arena (per-tenant) accounting across the pool.

        Merges the slab allocator's per-arena physical view (live/held/frag
        bytes, slab counts — replicas included) with the directory's logical
        view (object count and logical bytes, replicas not double-counted).
        Serving uses one arena per tenant (``alloc(client=tenant)``), so this
        is the per-tenant occupancy surface the admission controller and the
        multi-tenant benchmark report.
        """
        stats = self._allocator.arena_stats()
        for po in self._directory.values():
            entry = stats.setdefault(
                po.arena, SlabAllocator._zero_stats()
            )
            entry["n_objects"] = entry.get("n_objects", 0) + 1
            entry["logical_bytes"] = entry.get("logical_bytes", 0) + po.nbytes
        for entry in stats.values():
            entry.setdefault("n_objects", 0)
            entry.setdefault("logical_bytes", 0)
        return stats

    def _update_frag_gauges(self) -> None:
        if not self.telemetry.enabled:
            return
        for node in self.alive_nodes():
            ns = self._allocator.node_stats(node.node_id)
            self.telemetry.gauge("pool.slab_occupancy",
                                 ns["slab_occupancy"], node=node.node_id)
            self.telemetry.gauge("pool.internal_frag_bytes",
                                 ns["internal_frag_bytes"], node=node.node_id)
            self.telemetry.gauge("pool.external_frag_bytes",
                                 ns["external_frag_bytes"], node=node.node_id)
        for arena, s in self._allocator.arena_stats().items():
            self.telemetry.gauge("pool.arena_live_bytes",
                                 s["live_bytes"], arena=arena)
            self.telemetry.gauge("pool.arena_frag_bytes",
                                 s["frag_bytes"], arena=arena)

    # -- stats ---------------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate traffic/occupancy counters (bytes, ops, objects, nodes)."""
        per_node = [n.stats() for n in self.nodes]
        return {
            "bytes_read": sum(s["bytes_read"] for s in per_node),
            "bytes_written": sum(s["bytes_written"] for s in per_node),
            "n_ops": sum(s["n_ops"] for s in per_node),
            "n_objects": len(self._directory),
            "n_nodes": self.n_nodes,
            "n_alive": len(self.alive_nodes()),
            "n_retired": sum(1 for n in self.nodes if n.retired),
            "replication": self.replication,
            "stripe_bytes": self.stripe_bytes,
            "logical_bytes": self.total_bytes(),
            "physical_bytes": self.physical_bytes(),
            "allocator": self.fragmentation_stats(),
            "failures": list(self._failures),
            "resizes": list(self._resizes),
            "compactions": list(self._compactions),
            "per_node": per_node,
        }
