"""Remote memory node emulation: sync reads, async writes, atomics, locks.

Host memory stands in for the memory node; every transfer is (a) actually
performed (numpy copy — so workloads compute correct results) and (b) charged
to the fabric performance model on the :class:`SimClock`. The semantics follow
the paper:

  * **reads are synchronous** — the issuing timeline blocks until completion
    (the access barrier, §4.2 step 3);
  * **writes are asynchronous** — issued and forgotten; a ``fence`` (or a
    subsequent read of the same object, read-after-write) waits for them
    (§4.2 "asynchronous remote memory write");
  * **atomics** serve small shared objects (§4.1);
  * **per-object locks** implement the shared-object write lock (§4.3).

A copy of ``repro.core.remote_store`` for this package, numpy as there.
"""
from __future__ import annotations

import threading
from typing import Iterable

import numpy as np

from repro_torch.core.fabric import FabricModel, FabricResource, INFINIBAND_100G, SimClock
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry


class NodeFailure(RuntimeError):
    """Raised when an operation targets a memory node that has failed."""


class RemoteObject:
    __slots__ = ("name", "data", "lock", "pending_write_until", "epoch")

    def __init__(self, name: str, data: np.ndarray):
        self.name = name
        self.data = data
        self.lock = threading.Lock()  # fine-grained shared-object lock (§4.3)
        self.pending_write_until = 0.0  # sim-time when last async write lands
        self.epoch = 0


class RemoteStore:
    """The memory node. One or more fabric resources (QPs) reach it."""

    def __init__(
        self,
        *,
        clock: SimClock | None = None,
        fabric: FabricModel = INFINIBAND_100G,
        n_resources: int = 1,
        node_id: int = 0,
        capacity_bytes: int | None = None,
        telemetry: Telemetry | None = None,
    ) -> None:
        self.clock = clock or SimClock()
        self.fabric = fabric
        self.node_id = node_id
        self.capacity_bytes = capacity_bytes
        self.alive = True
        self.retired = False
        self.failed_at_us: float | None = None
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        if self.telemetry.enabled:
            self.telemetry.bind_clock(self.clock)
        self.resources = [
            FabricResource(self.clock, fabric, telemetry=self.telemetry,
                           track=f"node{node_id}/qp{i}")
            for i in range(n_resources)
        ]
        self._objects: dict[str, RemoteObject] = {}
        self._atomics: dict[str, int] = {}
        self._used_bytes = 0  # running total; keeps capacity checks O(1)
        self._lock = threading.RLock()

    # -- failure injection -------------------------------------------------
    def fail(self, *, at_us: float = 0.0) -> None:
        """Kill the node at sim-time ``at_us``: its data is lost and every
        subsequent operation raises :class:`NodeFailure` (pool recovery
        rebuilds lost extents from replicas or checkpoints)."""
        with self._lock:
            self.alive = False
            self.failed_at_us = at_us
            self._objects.clear()
            self._atomics.clear()
            self._used_bytes = 0

    def retire(self) -> None:
        """Administratively remove a *drained* node (elastic scale-down).

        Unlike :meth:`fail`, retirement is planned: the caller has already
        evacuated every extent and atomic, so nothing is lost — but, like a
        failed node, a retired node serves no further operations.
        """
        with self._lock:
            self.alive = False
            self.retired = True
            self._objects.clear()
            self._atomics.clear()
            self._used_bytes = 0

    def drain_atomics(self) -> dict[str, int]:
        """Hand off (and clear) this node's atomic counters for re-homing."""
        with self._lock:
            out = dict(self._atomics)
            self._atomics.clear()
            return out

    def adopt_atomics(self, values: dict[str, int]) -> None:
        """Install atomics evacuated from a draining peer (control plane —
        no fabric charge; the migration path charges data movement)."""
        self._check_alive()
        with self._lock:
            self._atomics.update(values)

    def _check_alive(self) -> None:
        if not self.alive:
            if self.retired:
                raise NodeFailure(
                    f"memory node {self.node_id} was drained and retired"
                )
            raise NodeFailure(
                f"memory node {self.node_id} failed at t={self.failed_at_us}us"
            )

    # -- allocation -------------------------------------------------------
    def alloc(self, name: str, array: np.ndarray) -> None:
        self._check_alive()
        with self._lock:
            if name in self._objects:
                raise ValueError(f"remote object {name!r} exists")
            nbytes = np.asarray(array).nbytes
            if (
                self.capacity_bytes is not None
                and self._used_bytes + nbytes > self.capacity_bytes
            ):
                raise MemoryError(
                    f"node {self.node_id}: alloc {name!r} ({nbytes} B) exceeds "
                    f"capacity {self.capacity_bytes} B "
                    f"({self._used_bytes} B in use)"
                )
            self._objects[name] = RemoteObject(name, np.array(array, copy=True))
            self._used_bytes += nbytes

    def free(self, name: str) -> None:
        with self._lock:
            obj = self._objects.pop(name, None)
            if obj is not None:
                self._used_bytes -= obj.data.nbytes

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._objects

    def nbytes(self, name: str) -> int:
        with self._lock:
            return self._objects[name].data.nbytes

    def stored_bytes(self) -> int:
        """Physical bytes resident on this node (capacity accounting)."""
        with self._lock:
            return self._used_bytes

    def object_names(self) -> list[str]:
        """Keys resident on this node (the pool's orphan-audit surface)."""
        with self._lock:
            return list(self._objects)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(o.data.nbytes for o in self._objects.values())

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
        """One-sided read; returns (data, completion_time_us).

        Read-after-write consistency: a read waits for any in-flight async
        write to the same object (the fabric's completion-queue ordering the
        paper relies on, §4.1 last para).
        """
        self._check_alive()
        with self._lock:
            obj = self._objects[name]
        res = resource or self.resources[0]
        t_issue = self.clock.now(timeline) if issue_at_us is None else issue_at_us
        t_issue = max(t_issue, obj.pending_write_until)  # RAW ordering
        flat = obj.data.reshape(-1).view(np.uint8)
        if nbytes is None:
            nbytes = flat.nbytes - offset
        _start, end = res.issue("read", nbytes, t_issue)
        if sync:
            self.clock.wait_until(timeline, end)
        chunk = np.array(flat[offset : offset + nbytes], copy=True)
        return chunk, end

    def read_object(
        self, name: str, *, timeline: str = "main",
        resource: FabricResource | None = None,
    ) -> tuple[np.ndarray, float]:
        """Fetch the whole object (shaped), synchronously."""
        with self._lock:
            obj = self._objects[name]
            dtype, shape = obj.data.dtype, obj.data.shape
        raw, end = self.read(name, timeline=timeline, resource=resource)
        return raw.view(dtype).reshape(shape), end

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
        """One-sided write. Async by default: data lands, timeline doesn't wait."""
        self._check_alive()
        with self._lock:
            obj = self._objects[name]
        if array.nbytes != obj.data.nbytes:
            raise ValueError(
                f"size mismatch writing {name!r}: {array.nbytes} != {obj.data.nbytes}"
            )
        res = resource or self.resources[0]
        t_issue = self.clock.now(timeline)
        _start, end = res.issue("write", array.nbytes, t_issue)
        with obj.lock:
            obj.data = np.array(array, copy=True).reshape(obj.data.shape)
            obj.pending_write_until = max(obj.pending_write_until, end)
            if epoch is not None:
                obj.epoch = epoch
        if sync:
            self.clock.wait_until(timeline, end)
        return end

    def fence(self, names: Iterable[str] | None = None, *, timeline: str = "main") -> float:
        """Memory barrier: wait for pending writes (all, or the given set).

        Names freed concurrently (or never allocated) are skipped — a fence
        on a dead object has nothing left to order against.
        """
        with self._lock:
            objs = (
                list(self._objects.values())
                if names is None
                else [self._objects[n] for n in names if n in self._objects]
            )
        t = max([o.pending_write_until for o in objs], default=0.0)
        return self.clock.wait_until(timeline, t)

    # -- public stream/data accessors (shared with MemoryPool) --------------
    def payload(self, name: str) -> np.ndarray:
        """Copy of the object's current data (shaped); no fabric charge."""
        with self._lock:
            obj = self._objects[name]
        with obj.lock:
            return np.array(obj.data, copy=True)

    def pending_until(self, name: str) -> float:
        """Sim-time when the last async write to ``name`` lands (0 if none)."""
        with self._lock:
            obj = self._objects.get(name)
        return obj.pending_write_until if obj is not None else 0.0

    def least_loaded_resource(self) -> FabricResource:
        """The QP that frees up earliest — congestion-aware routing target."""
        return min(self.resources, key=lambda r: (r.free_at, r.name))

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
        """Charge a chunked read of ``nbytes`` of ``name``; return completion.

        Orders after any pending async write (RAW). The caller owns the
        timeline wait — this only occupies the fabric resource.
        """
        self._check_alive()
        with self._lock:
            obj = self._objects[name]
        size = obj.data.nbytes if nbytes is None else nbytes
        res = resource or self.least_loaded_resource()
        t = max(issue_at, obj.pending_write_until)
        _s, end = res.issue_stream("read", size, chunk_bytes, t, pipelined=mode)
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
        """Coalesced scatter-gather read: one posted op spanning many objects.

        ``requests`` is ``[(name, nbytes), ...]`` in access order; returns
        ``{name: completion_time}``. The batch orders after the latest
        pending async write among the named objects (RAW), pays the fabric
        base cost once, and occupies a single QP — each object completes
        when the cumulative stream reaches the end of its extent, so
        earlier window entries unblock their access barrier first.
        """
        self._check_alive()
        if not requests:
            return {}
        with self._lock:
            objs = [self._objects[name] for name, _ in requests]
        t0 = max([issue_at] + [o.pending_write_until for o in objs])
        res = resource or self.least_loaded_resource()
        sizes = [int(nb) for _, nb in requests]
        _s, completions, _end = res.issue_batch(
            "read", sizes, chunk_bytes, t0, mode=mode
        )
        return {name: done for (name, _), done in zip(requests, completions)}

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
        """Chunked async write of the full object; lands data, returns end.

        ``charge_bytes`` lets sim-scaled callers charge the fabric for the
        modeled object size while landing the real (smaller) array.
        """
        self._check_alive()
        with self._lock:
            obj = self._objects[name]
        array = np.asarray(array)
        if array.nbytes != obj.data.nbytes:
            raise ValueError(
                f"size mismatch writing {name!r}: {array.nbytes} != {obj.data.nbytes}"
            )
        res = resource or self.least_loaded_resource()
        _s, end = res.issue_stream("write", charge_bytes or array.nbytes,
                                   chunk_bytes, issue_at, pipelined=mode)
        self.commit_payload(name, array, pending_until=end, epoch=epoch)
        return end

    def commit_payload(
        self, name: str, array: np.ndarray, *,
        pending_until: float, epoch: int | None = None,
    ) -> None:
        """Land data whose fabric time was already charged elsewhere."""
        with self._lock:
            obj = self._objects[name]
        with obj.lock:
            obj.data = np.array(array, copy=True).reshape(obj.data.shape)
            obj.pending_write_until = max(obj.pending_write_until, pending_until)
            if epoch is not None:
                obj.epoch = epoch

    # -- atomics for small shared objects (§4.1) ----------------------------
    def atomic_fetch_add(self, key: str, delta: int, *, timeline: str = "main") -> int:
        self._check_alive()
        res = self.resources[0]
        t_issue = self.clock.now(timeline)
        _start, end = res.issue("atomic", 8, t_issue)
        self.clock.wait_until(timeline, end)
        with self._lock:
            old = self._atomics.get(key, 0)
            self._atomics[key] = old + delta
            return old

    def atomic_cas(self, key: str, expected: int, new: int, *, timeline: str = "main") -> bool:
        self._check_alive()
        res = self.resources[0]
        t_issue = self.clock.now(timeline)
        _start, end = res.issue("atomic", 8, t_issue)
        self.clock.wait_until(timeline, end)
        with self._lock:
            if self._atomics.get(key, 0) == expected:
                self._atomics[key] = new
                return True
            return False

    def atomic_read(self, key: str) -> int:
        with self._lock:
            return self._atomics.get(key, 0)

    # -- checkpointing hooks ------------------------------------------------
    def snapshot_objects(self) -> dict[str, np.ndarray]:
        with self._lock:
            return {n: np.array(o.data, copy=True) for n, o in self._objects.items()}

    def restore_objects(self, blobs: dict[str, np.ndarray]) -> None:
        with self._lock:
            for name, data in blobs.items():
                if name in self._objects:
                    old = self._objects[name]
                    self._used_bytes += data.nbytes - old.data.nbytes
                    old.data = np.array(data, copy=True)
                else:
                    self._objects[name] = RemoteObject(name, np.array(data, copy=True))
                    self._used_bytes += data.nbytes

    # -- stats ----------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n_objects = len(self._objects)
        return {
            "bytes_read": sum(r.bytes_read for r in self.resources),
            "bytes_written": sum(r.bytes_written for r in self.resources),
            "n_ops": sum(r.n_ops for r in self.resources),
            "n_objects": n_objects,
            "alive": self.alive,
            "retired": self.retired,
            "per_resource": [
                {
                    "name": r.name,
                    "bytes_read": r.bytes_read,
                    "bytes_written": r.bytes_written,
                    "n_ops": r.n_ops,
                    "free_at_us": r.free_at,
                }
                for r in self.resources
            ],
        }
