"""The DOLMA metadata region: object -> (tier, status, epoch) table.

The paper's metadata region (§4.2) records which data objects are cached in
local memory, their remote addresses, and their status; the checkpointing
protocol (§4.2, reliability) keeps local and remote checkpoints consistent
*through this table*. This module is the host-runtime implementation; the
compiled-graph tier assignment lives in :mod:`repro_torch.core.placement`.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import threading
from typing import Any, Iterator


class Tier(enum.Enum):
    LOCAL = "local"            # local data-object region (HBM / node DRAM)
    CACHED = "cached"          # remote object, currently in the local cache region
    REMOTE = "remote"          # remote memory node (host DRAM / memory pod)


class Status(enum.Enum):
    PRESENT = "present"        # readable locally
    FETCHING = "fetching"      # RDMA read in flight (barrier required pre-use)
    DIRTY = "dirty"            # local copy newer than remote (async write due)
    FLUSHED = "flushed"        # remote copy is authoritative


@dataclasses.dataclass
class ObjectMeta:
    name: str
    tier: Tier
    status: Status
    size_bytes: int
    epoch: int = 0              # last step/iteration that wrote the object
    remote_addr: int | None = None
    local_slot: int | None = None  # which dual-buffer slot holds it (if CACHED)
    # trace stats (fed by the runtime's access recorder): fetch-event distance
    # between the last two uses — the reuse signal Belady-from-trace evicts by
    reuse_distance: int | None = None
    # observed access counters (runtime recorder) — exported by
    # DolmaRuntime.profile() as the cost model's per-object census
    n_fetches: int = 0
    n_commits: int = 0

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tier"] = self.tier.value
        d["status"] = self.status.value
        return d

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ObjectMeta":
        d = dict(d)
        d["tier"] = Tier(d["tier"])
        d["status"] = Status(d["status"])
        return cls(**d)


class MetadataTable:
    """Thread-safe object->meta table with checkpoint snapshot/restore."""

    def __init__(self) -> None:
        self._table: dict[str, ObjectMeta] = {}
        self._lock = threading.RLock()

    def register(self, meta: ObjectMeta) -> None:
        with self._lock:
            if meta.name in self._table:
                raise ValueError(f"object {meta.name!r} already registered")
            self._table[meta.name] = meta

    def drop(self, name: str) -> None:
        with self._lock:
            self._table.pop(name, None)

    def get(self, name: str) -> ObjectMeta:
        with self._lock:
            return self._table[name]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._table

    def __iter__(self) -> Iterator[ObjectMeta]:
        with self._lock:
            return iter(list(self._table.values()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def update(self, name: str, **fields: Any) -> ObjectMeta:
        with self._lock:
            meta = self._table[name]
            for k, v in fields.items():
                if not hasattr(meta, k):
                    raise AttributeError(f"ObjectMeta has no field {k!r}")
                setattr(meta, k, v)
            return meta

    def dirty_since(self, epoch: int) -> list[ObjectMeta]:
        """Objects modified since ``epoch`` — the checkpoint delta set (§4.2)."""
        with self._lock:
            return [
                m for m in self._table.values()
                if m.epoch > epoch or m.status is Status.DIRTY
            ]

    # -- checkpoint integration ------------------------------------------
    def snapshot(self) -> str:
        with self._lock:
            return json.dumps(
                {name: m.to_json() for name, m in self._table.items()},
                sort_keys=True,
            )

    @classmethod
    def restore(cls, blob: str) -> "MetadataTable":
        table = cls()
        for _name, meta_json in json.loads(blob).items():
            table.register(ObjectMeta.from_json(meta_json))
        return table

    def local_bytes(self) -> int:
        with self._lock:
            return sum(
                m.size_bytes
                for m in self._table.values()
                if m.tier in (Tier.LOCAL, Tier.CACHED)
            )

    def remote_bytes(self) -> int:
        with self._lock:
            return sum(
                m.size_bytes for m in self._table.values() if m.tier is Tier.REMOTE
            )

    def reuse_stats(self) -> dict[str, int]:
        """Observed per-object reuse distances (fetch events between uses)."""
        with self._lock:
            return {
                m.name: m.reuse_distance
                for m in self._table.values()
                if m.reuse_distance is not None
            }

    def access_counts(self) -> dict[str, tuple[int, int]]:
        """Observed (n_fetches, n_commits) per object — profile census."""
        with self._lock:
            return {
                m.name: (m.n_fetches, m.n_commits)
                for m in self._table.values()
            }
