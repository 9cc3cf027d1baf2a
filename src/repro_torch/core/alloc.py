"""Size-class slab allocator for the memory pool (MIND-style).

The seed pool placed every extent directly into a node's object map: fine
for the paper's static HPC working sets, but under the churn this repo now
generates (elastic autoscale + per-wave KV alloc/free in the serving
engine) a fixed-stripe extent map fragments — exactly the failure mode
MIND's allocator study demonstrates with multi-round random alloc/free
harnesses, and exactly what its per-size slab classes fix.

This module is the *intra-node* allocation layer. Inter-node placement —
which nodes hold an extent's replicas — stays the canonical striped walk in
:mod:`repro_torch.core.pool` (``_striped_replicas``); the :class:`SlabAllocator`
decides *where on a node* each extent replica lives:

  * **size classes** — power-of-two classes from :data:`MIN_CLASS_BYTES` up
    to the pool's stripe size; an extent occupies one slot of the smallest
    class that fits it, and the class-minus-payload remainder is accounted
    as *internal* fragmentation;
  * **slabs** — a slab is one stripe-sized region carved into
    ``stripe_bytes // class_bytes`` equal slots for a single (arena, class)
    bin; empty slabs are returned whole, and free slots in carved slabs are
    accounted as *external* fragmentation (space held but serving no data);
  * **arenas** — every slab is owned by exactly one arena (one per client:
    a ``DolmaRuntime`` tenant, the serving engine, ...), so one client's
    alloc/free churn can punch holes only in its own slabs — the
    prerequisite for the ROADMAP multi-client pool;
  * **compaction planning** — :meth:`SlabAllocator.plan_compaction`
    enumerates the extent moves that fold each bin's sparse slabs into its
    dense ones, leaving at most one partial slab per (node, arena, class);
    the pool executes the moves make-before-break on its own timeline and
    commits each via :meth:`SlabAllocator.apply_move`.

The allocator is pure bookkeeping over the simulated nodes: bytes live in
:class:`~repro_torch.core.remote_store.RemoteStore` objects as before (capacity
is still enforced there, byte-granular), so every read stays bit-identical
while the allocator's occupancy/fragmentation view feeds the autoscaler's
effective-capacity pricing and the telemetry gauges.

A copy of ``repro.core.alloc`` for this package (standard library only).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

DEFAULT_STRIPE_BYTES = 1 << 20  # 1 MiB extents (a few RDMA ops each)
MIN_CLASS_BYTES = 4096  # one page: smaller objects are page-padded anyway
DEFAULT_ARENA = "shared"  # allocations not attributed to any client


def size_class_bytes(
    nbytes: int,
    *,
    stripe_bytes: int = DEFAULT_STRIPE_BYTES,
    min_class_bytes: int = MIN_CLASS_BYTES,
) -> int:
    """Smallest power-of-two class >= ``nbytes``, clamped to the stripe.

    The top class is exactly ``stripe_bytes`` (one slot per slab) even when
    the stripe is not itself a power of two, so a full stripe-sized extent
    never pays internal fragmentation.
    """
    if nbytes > stripe_bytes:
        raise ValueError(
            f"extent of {nbytes} B exceeds stripe_bytes={stripe_bytes}"
        )
    c = min_class_bytes
    while c < nbytes and c < stripe_bytes:
        c <<= 1
    return min(c, stripe_bytes)


def object_footprint_bytes(
    nbytes: int,
    *,
    stripe_bytes: int = DEFAULT_STRIPE_BYTES,
    min_class_bytes: int = MIN_CLASS_BYTES,
) -> int:
    """Slab-rounded bytes one replica of a striped object occupies.

    ``nbytes`` splits into full stripes plus a tail extent; the tail is
    rounded up to its size class. This is the load unit slab-aware
    placement plans account with (see ``PlacementPolicy.plan``), so the
    planner prices the same bytes the allocator will actually hold.
    """
    if nbytes <= 0:
        return min(min_class_bytes, stripe_bytes)
    full, tail = divmod(nbytes, stripe_bytes)
    fp = full * stripe_bytes
    if tail:
        fp += size_class_bytes(tail, stripe_bytes=stripe_bytes,
                               min_class_bytes=min_class_bytes)
    return fp


@dataclasses.dataclass
class Slab:
    """One stripe-sized region carved into equal slots of a single class."""

    slab_id: int
    node_id: int
    arena: str
    class_bytes: int
    n_slots: int
    slots: dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def used_slots(self) -> int:
        return len(self.slots)

    @property
    def free_slot_count(self) -> int:
        return self.n_slots - len(self.slots)

    @property
    def footprint_bytes(self) -> int:
        """Bytes this slab holds off the node (carved area)."""
        return self.n_slots * self.class_bytes

    @property
    def free_bytes(self) -> int:
        return self.free_slot_count * self.class_bytes

    @property
    def occupancy(self) -> float:
        return len(self.slots) / self.n_slots

    def first_free_slot(self) -> int:
        for i in range(self.n_slots):
            if i not in self.slots:
                return i
        raise RuntimeError(f"slab {self.slab_id} is full")


@dataclasses.dataclass(frozen=True)
class CompactionMove:
    """Fold one extent from a sparse slab into a denser one (same bin)."""

    node_id: int
    arena: str
    class_bytes: int
    key: str
    nbytes: int
    src_slab_id: int
    dst_slab_id: int


@dataclasses.dataclass
class _Placement:
    slab: Slab
    slot: int
    nbytes: int


class SlabAllocator:
    """Intra-node slab/slot bookkeeping for every extent replica.

    Keys are the pool's extent keys (``"name#e<i>"``); each (node, key)
    pair maps to exactly one slot of one slab. All mutation goes through
    :meth:`place` / :meth:`release` / :meth:`apply_move` /
    :meth:`drop_node`, which keep the per-bin slab lists, the placement
    index, and the fragmentation accounting consistent by construction.
    """

    def __init__(
        self,
        *,
        stripe_bytes: int = DEFAULT_STRIPE_BYTES,
        min_class_bytes: int = MIN_CLASS_BYTES,
    ) -> None:
        if stripe_bytes < min_class_bytes:
            raise ValueError(
                f"stripe_bytes={stripe_bytes} < min class {min_class_bytes}"
            )
        self.stripe_bytes = stripe_bytes
        self.min_class_bytes = min_class_bytes
        # (node_id, arena, class_bytes) -> slabs of that bin, creation order
        self._bins: dict[tuple[int, str, int], list[Slab]] = {}
        self._index: dict[tuple[int, str], _Placement] = {}
        self._next_slab_id = 0

    # -- classing -----------------------------------------------------------
    def class_of(self, nbytes: int) -> int:
        return size_class_bytes(nbytes, stripe_bytes=self.stripe_bytes,
                                min_class_bytes=self.min_class_bytes)

    def classes(self) -> list[int]:
        """All classes currently carved anywhere (ascending)."""
        return sorted({cls for (_n, _a, cls) in self._bins})

    # -- placement ----------------------------------------------------------
    def place(self, node_id: int, key: str, nbytes: int, *,
              arena: str = DEFAULT_ARENA) -> Slab:
        """Assign ``key`` (``nbytes`` of payload) a slot on ``node_id``.

        The fullest partial slab of the (arena, class) bin is preferred —
        the classic slab policy that keeps churn from smearing live slots
        over many half-empty slabs — and a fresh slab is carved only when
        every existing one is full.
        """
        if (node_id, key) in self._index:
            raise ValueError(f"extent {key!r} already placed on node {node_id}")
        cls = self.class_of(nbytes)
        bin_key = (node_id, arena, cls)
        slabs = self._bins.setdefault(bin_key, [])
        # a slab of a stripe-sized class has one slot, and an emptied slab
        # leaves its bin, so every slab there is full: skip the scan (it
        # made registering N such extents O(N^2): a paged full-width MoE
        # layer has 22.5 K of them)
        partial = ([s for s in slabs if s.free_slot_count > 0]
                   if self.stripe_bytes // cls > 1 else [])
        if partial:
            slab = max(partial, key=lambda s: (s.used_slots, -s.slab_id))
        else:
            slab = Slab(
                slab_id=self._next_slab_id,
                node_id=node_id,
                arena=arena,
                class_bytes=cls,
                n_slots=max(self.stripe_bytes // cls, 1),
            )
            self._next_slab_id += 1
            slabs.append(slab)
        slot = slab.first_free_slot()
        slab.slots[slot] = key
        self._index[(node_id, key)] = _Placement(slab=slab, slot=slot,
                                                 nbytes=nbytes)
        return slab

    def release(self, node_id: int, key: str) -> None:
        """Free ``key``'s slot; an emptied slab is returned whole.

        Tolerant of unknown keys (mirrors ``RemoteStore.free``): the pool
        frees replica lists that may include nodes already failed/dropped.
        """
        pl = self._index.pop((node_id, key), None)
        if pl is None:
            return
        del pl.slab.slots[pl.slot]
        if not pl.slab.slots:
            bin_key = (node_id, pl.slab.arena, pl.slab.class_bytes)
            slabs = self._bins.get(bin_key)
            if slabs is not None:
                slabs.remove(pl.slab)
                if not slabs:
                    del self._bins[bin_key]

    def drop_node(self, node_id: int) -> None:
        """Forget everything on ``node_id`` (failure or retirement)."""
        self._bins = {k: v for k, v in self._bins.items() if k[0] != node_id}
        self._index = {k: v for k, v in self._index.items()
                       if k[0] != node_id}

    # -- queries ------------------------------------------------------------
    def has(self, node_id: int, key: str) -> bool:
        return (node_id, key) in self._index

    def keys_on(self, node_id: int) -> list[str]:
        return [k for (nid, k) in self._index if nid == node_id]

    def nbytes_of(self, node_id: int, key: str) -> int:
        return self._index[(node_id, key)].nbytes

    def arena_of(self, node_id: int, key: str) -> str:
        return self._index[(node_id, key)].slab.arena

    def slabs_on(self, node_id: int) -> Iterator[Slab]:
        for (nid, _arena, _cls), slabs in self._bins.items():
            if nid == node_id:
                yield from slabs

    # -- fragmentation accounting -------------------------------------------
    @staticmethod
    def _zero_stats() -> dict:
        return {
            "live_bytes": 0,
            "held_bytes": 0,
            "internal_frag_bytes": 0,
            "external_frag_bytes": 0,
            "frag_bytes": 0,
            "n_slabs": 0,
            "n_partial_slabs": 0,
            "n_extents": 0,
            "slab_occupancy": 1.0,
        }

    def _accumulate(self, out: dict, slabs: Iterator[Slab]) -> dict:
        total_slots = used_slots = 0
        for slab in slabs:
            out["n_slabs"] += 1
            out["held_bytes"] += slab.footprint_bytes
            out["external_frag_bytes"] += slab.free_bytes
            if 0 < slab.used_slots < slab.n_slots:
                out["n_partial_slabs"] += 1
            total_slots += slab.n_slots
            used_slots += slab.used_slots
            for key in slab.slots.values():
                nbytes = self._index[(slab.node_id, key)].nbytes
                out["live_bytes"] += nbytes
                out["internal_frag_bytes"] += slab.class_bytes - nbytes
                out["n_extents"] += 1
        out["frag_bytes"] = out["held_bytes"] - out["live_bytes"]
        out["slab_occupancy"] = (used_slots / total_slots) if total_slots else 1.0
        return out

    def node_stats(self, node_id: int) -> dict:
        return self._accumulate(self._zero_stats(), self.slabs_on(node_id))

    def arena_stats(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for (_nid, arena, _cls), slabs in sorted(self._bins.items()):
            acc = out.setdefault(arena, self._zero_stats())
            self._accumulate(acc, iter(slabs))
        return out

    def stats(self) -> dict:
        all_slabs = (s for slabs in self._bins.values() for s in slabs)
        out = self._accumulate(self._zero_stats(), all_slabs)
        out["n_arenas"] = len({a for (_n, a, _c) in self._bins})
        out["classes"] = self.classes()
        return out

    # -- compaction ----------------------------------------------------------
    def plan_compaction(self) -> list[CompactionMove]:
        """Moves that fold every bin down to at most one partial slab.

        Two-pointer fold per (node, arena, class) bin: donors are drained
        sparsest-first into the free slots of the densest receivers, so the
        move count is the minimum that reaches the <=1-partial-slab state.
        Planning only — nothing changes until each move is committed via
        :meth:`apply_move` (the pool charges the copy in between).
        """
        moves: list[CompactionMove] = []
        for (node_id, arena, cls), slabs in sorted(self._bins.items()):
            partial = [s for s in slabs
                       if 0 < s.used_slots < s.n_slots]
            if len(partial) < 2:
                continue
            partial.sort(key=lambda s: (-s.used_slots, s.slab_id))
            free_left = {s.slab_id: s.free_slot_count for s in partial}
            # drain donors in slot order for determinism
            pending = {s.slab_id: [s.slots[i] for i in sorted(s.slots)]
                       for s in partial}
            i, j = 0, len(partial) - 1
            while i < j:
                recv, donor = partial[i], partial[j]
                if free_left[recv.slab_id] == 0:
                    i += 1
                    continue
                if not pending[donor.slab_id]:
                    j -= 1
                    continue
                key = pending[donor.slab_id].pop()
                moves.append(CompactionMove(
                    node_id=node_id,
                    arena=arena,
                    class_bytes=cls,
                    key=key,
                    nbytes=self._index[(node_id, key)].nbytes,
                    src_slab_id=donor.slab_id,
                    dst_slab_id=recv.slab_id,
                ))
                free_left[recv.slab_id] -= 1
        return moves

    def apply_move(self, move: CompactionMove) -> None:
        """Commit one planned move: re-slot the key, drop emptied slabs."""
        pl = self._index[(move.node_id, move.key)]
        if pl.slab.slab_id != move.src_slab_id:
            raise ValueError(
                f"stale compaction move for {move.key!r}: extent sits in "
                f"slab {pl.slab.slab_id}, plan says {move.src_slab_id}"
            )
        bin_key = (move.node_id, move.arena, move.class_bytes)
        dst = next(
            (s for s in self._bins.get(bin_key, ())
             if s.slab_id == move.dst_slab_id),
            None,
        )
        if dst is None or dst.free_slot_count == 0:
            raise ValueError(
                f"stale compaction move for {move.key!r}: destination slab "
                f"{move.dst_slab_id} is gone or full"
            )
        src = pl.slab
        del src.slots[pl.slot]
        slot = dst.first_free_slot()
        dst.slots[slot] = move.key
        pl.slab, pl.slot = dst, slot
        if not src.slots:
            slabs = self._bins[bin_key]
            slabs.remove(src)
            if not slabs:
                del self._bins[bin_key]
