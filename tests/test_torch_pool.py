"""The port's slab allocator, remote store and memory pool, against the
JAX reference.

The reference's own cases for these modules (``tests/test_alloc.py``,
``test_pool.py``, ``test_pool_elastic.py``, ``test_remote_semantics.py``)
are ported here pointed at ``repro_torch``, one section each; helper names
that two of those files share carry the section's prefix. The two cases of
``test_pool.py`` that need ``CheckpointManager``
(``test_recover_from_checkpoint_blobs``,
``test_store_snapshot_survives_newer_training_checkpoint``) wait for the
training slice. Then the allocator's and the pool's benchmark gates: the
churn of ``benchmarks/fig_alloc_churn.py`` reproduces ``BENCH_pr7.json``
exactly, and ``benchmarks/fig_pool_scaling.py``'s asserts hold, with the
same numbers as the reference's. The pool is numpy in both packages, so
every number is compared with ``==``.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

from repro_torch.core import (
    DolmaRuntime,
    ExtentLostError,
    MemoryPool,
    NodeFailure,
    RemoteStore,
    SimClock,
    TwoLevelScheduler,
)
from repro_torch.core.alloc import (
    DEFAULT_ARENA,
    MIN_CLASS_BYTES,
    SlabAllocator,
    object_footprint_bytes,
    size_class_bytes,
)
from repro_torch.core.placement import PlacementPolicy
from repro_torch.core.pool import OrphanExtentError
from repro_torch.core.sizing import effective_node_capacity, pool_nodes_needed
from repro_torch.hpc import WORKLOADS, pooled_runtime, run_workload

import _torch_hpc_parity as H
from _hypothesis_compat import given, settings, st

KIB = 1 << 10
MIB = 1 << 20
STRIPE = 32 * KIB


# -- the slab allocator (ported from tests/test_alloc.py) -------------------------------------

def _alloc_blob(nbytes: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=nbytes, dtype=np.uint8)


def _alloc_assert_all_readable(pool: MemoryPool, expected: dict) -> None:
    for name, blob in expected.items():
        got, _ = pool.read_object(name)
        assert np.array_equal(got, blob), f"{name} diverged"


class TestSizeClasses:
    def test_power_of_two_rounding(self):
        assert size_class_bytes(1, stripe_bytes=STRIPE) == MIN_CLASS_BYTES
        assert size_class_bytes(4096, stripe_bytes=STRIPE) == 4096
        assert size_class_bytes(4097, stripe_bytes=STRIPE) == 8192
        assert size_class_bytes(STRIPE, stripe_bytes=STRIPE) == STRIPE

    def test_top_class_is_exactly_the_stripe(self):
        # even for a non-power-of-two stripe: full stripes pay no internal
        # fragmentation (a 24K extent in a 24K slot, not a 32K one)
        odd = 24 * KIB
        assert size_class_bytes(odd, stripe_bytes=odd) == odd
        assert size_class_bytes(20 * KIB, stripe_bytes=odd) == odd

    def test_oversized_rejected(self):
        with pytest.raises(ValueError):
            size_class_bytes(STRIPE + 1, stripe_bytes=STRIPE)

    def test_footprint(self):
        # tail-only object: rounds to its class
        assert object_footprint_bytes(5 * KIB, stripe_bytes=STRIPE) == 8 * KIB
        # exact stripes: no rounding at all
        assert object_footprint_bytes(2 * STRIPE, stripe_bytes=STRIPE) \
            == 2 * STRIPE
        # stripes + tail: full stripes plus the class-rounded tail
        assert object_footprint_bytes(STRIPE + 1, stripe_bytes=STRIPE) \
            == STRIPE + MIN_CLASS_BYTES
        # empty object still occupies one minimum-class slot
        assert object_footprint_bytes(0, stripe_bytes=STRIPE) \
            == MIN_CLASS_BYTES

    @settings(max_examples=50, deadline=None)
    @given(st.integers(1, 3 * STRIPE))
    def test_footprint_bounds(self, nbytes):
        fp = object_footprint_bytes(nbytes, stripe_bytes=STRIPE)
        assert fp >= nbytes
        # waste is the tail's class slack: zero for exact stripes, under
        # one min-class slot for tiny tails, < tail itself otherwise
        # (the class is the smallest power of two >= the tail)
        waste = fp - nbytes
        tail = nbytes % STRIPE
        if tail == 0:
            assert waste == 0
        else:
            assert waste < max(MIN_CLASS_BYTES, tail)
        assert waste < STRIPE


class TestSlabAllocator:
    def test_place_release_roundtrip(self):
        a = SlabAllocator(stripe_bytes=STRIPE)
        a.place(0, "x#e0", 5 * KIB)
        assert a.has(0, "x#e0")
        assert a.nbytes_of(0, "x#e0") == 5 * KIB
        assert a.arena_of(0, "x#e0") == DEFAULT_ARENA
        s = a.stats()
        assert s["live_bytes"] == 5 * KIB
        assert s["held_bytes"] == STRIPE          # one carved slab
        assert s["internal_frag_bytes"] == 3 * KIB  # 5K in an 8K slot
        a.release(0, "x#e0")
        assert not a.has(0, "x#e0")
        assert a.stats()["held_bytes"] == 0        # emptied slab returned

    def test_duplicate_place_rejected_and_release_tolerant(self):
        a = SlabAllocator(stripe_bytes=STRIPE)
        a.place(0, "x#e0", KIB)
        with pytest.raises(ValueError):
            a.place(0, "x#e0", KIB)
        a.release(0, "never-placed")               # no-op, like the store
        a.release(3, "x#e0")                       # wrong node: no-op too
        assert a.has(0, "x#e0")

    def test_prefers_fullest_partial_slab(self):
        a = SlabAllocator(stripe_bytes=STRIPE)     # 8 slots per 4K slab
        for i in range(16):                        # two full slabs
            a.place(0, f"k{i}#e0", 4 * KIB)
        # empty slab 0 down to 1 slot, slab 1 down to 7
        for i in range(7):
            a.release(0, f"k{i}#e0")
        a.release(0, "k8#e0")
        slabs = {s.slab_id: s.used_slots for s in a.slabs_on(0)}
        fullest = max(slabs, key=lambda sid: slabs[sid])
        a.place(0, "new#e0", 4 * KIB)
        slabs2 = {s.slab_id: s.used_slots for s in a.slabs_on(0)}
        assert slabs2[fullest] == slabs[fullest] + 1

    def test_arenas_never_share_slabs(self):
        a = SlabAllocator(stripe_bytes=STRIPE)
        a.place(0, "h#e0", 4 * KIB, arena="hpc")
        a.place(0, "s#e0", 4 * KIB, arena="serving")
        for slab in a.slabs_on(0):
            arenas = {a.arena_of(0, k) for k in slab.slots.values()}
            assert arenas == {slab.arena}
        per = a.arena_stats()
        assert per["hpc"]["live_bytes"] == 4 * KIB
        assert per["serving"]["live_bytes"] == 4 * KIB
        # two slabs carved even though one could hold both extents
        assert a.stats()["n_slabs"] == 2

    def test_compaction_folds_to_one_partial_slab(self):
        a = SlabAllocator(stripe_bytes=STRIPE)     # 8 slots per 4K slab
        for i in range(32):
            a.place(0, f"k{i}#e0", 4 * KIB)
        for i in range(0, 32, 2):                  # shoot holes in every slab
            a.release(0, f"k{i}#e0")
        before = a.stats()
        moves = a.plan_compaction()
        for mv in moves:
            a.apply_move(mv)
        after = a.stats()
        assert after["n_partial_slabs"] <= 1
        assert after["external_frag_bytes"] <= before["external_frag_bytes"]
        assert after["live_bytes"] == before["live_bytes"]
        assert a.plan_compaction() == []           # fixpoint

    def test_stale_move_rejected(self):
        a = SlabAllocator(stripe_bytes=STRIPE)
        for i in range(16):
            a.place(0, f"k{i}#e0", 4 * KIB)
        for i in range(0, 16, 2):
            a.release(0, f"k{i}#e0")
        moves = a.plan_compaction()
        assert moves
        for mv in moves:
            a.apply_move(mv)
        with pytest.raises(ValueError):
            a.apply_move(moves[0])                 # already committed


class TestAllocRollback:
    """Satellite 1: a failed mid-stripe alloc must leak nothing."""

    def test_mid_stripe_memoryerror_rolls_back_everything(self):
        pool = MemoryPool(1, stripe_bytes=8 * KIB,
                          node_capacity_bytes=24 * KIB)
        with pytest.raises(MemoryError):
            pool.alloc("big", _alloc_blob(40 * KIB, seed=1))  # dies at stripe 4
        assert "big" not in pool
        assert pool.physical_bytes() == 0
        assert pool._allocator.stats()["n_extents"] == 0
        assert pool._allocator.stats()["held_bytes"] == 0
        pool.check_no_orphans()
        # the pool is fully usable afterwards
        blob = _alloc_blob(16 * KIB, seed=2)
        pool.alloc("fits", blob)
        _alloc_assert_all_readable(pool, {"fits": blob})
        pool.check_no_orphans()

    def test_partial_node_failure_rollback_across_nodes(self):
        # node 1 fills first; extents already landed on node 0 roll back
        pool = MemoryPool(2, stripe_bytes=4 * KIB, replication=2,
                          node_capacity_bytes=8 * KIB)
        with pytest.raises(MemoryError):
            pool.alloc("wide", _alloc_blob(12 * KIB, seed=3))
        assert pool.physical_bytes() == 0
        pool.check_no_orphans()


class TestOrphanAudit:
    def test_clean_after_drain_and_recover(self):
        pool = MemoryPool(3, stripe_bytes=4 * KIB, replication=2)
        expected = {}
        for i in range(5):
            blob = _alloc_blob((i + 1) * 3 * KIB, seed=10 + i)
            pool.alloc(f"o{i}", blob)
            expected[f"o{i}"] = blob
        pool.check_no_orphans()
        pool.add_nodes(1)
        pool.check_no_orphans()
        pool.drain_nodes([1])
        pool.check_no_orphans()
        pool.fail_node(0)
        pool.recover()
        pool.check_no_orphans()
        _alloc_assert_all_readable(pool, expected)

    def test_detects_node_orphan(self):
        pool = MemoryPool(2, stripe_bytes=4 * KIB)
        pool.alloc("x", _alloc_blob(6 * KIB, seed=1))
        # bypass the pool: an extent lands on a node behind its back
        pool.nodes[0].alloc("ghost#e0", _alloc_blob(KIB, seed=2))
        with pytest.raises(OrphanExtentError, match="orphan|drift"):
            pool.check_no_orphans()

    def test_detects_allocator_drift(self):
        pool = MemoryPool(2, stripe_bytes=4 * KIB)
        pool.alloc("x", _alloc_blob(6 * KIB, seed=1))
        pool._allocator.place(0, "phantom#e0", KIB)
        with pytest.raises(OrphanExtentError, match="drift"):
            pool.check_no_orphans()


class TestPoolCompaction:
    def test_compaction_preserves_reads_and_reduces_frag(self):
        pool = MemoryPool(2, stripe_bytes=STRIPE)
        expected = {}
        for i in range(24):
            blob = _alloc_blob(4 * KIB, seed=i)
            pool.alloc(f"o{i}", blob)
            expected[f"o{i}"] = blob
        for i in range(0, 24, 2):                  # fragment the slabs
            pool.free(f"o{i}")
            del expected[f"o{i}"]
        before = pool.fragmentation_stats()
        stats = pool.compact()
        after = pool.fragmentation_stats()
        assert after["external_frag_bytes"] <= before["external_frag_bytes"]
        assert after["live_bytes"] == before["live_bytes"]
        assert stats["compaction_us"] >= 0.0
        _alloc_assert_all_readable(pool, expected)
        pool.check_no_orphans()
        # steady state: a second pass moves nothing
        again = pool.compact()
        assert again["compacted_extents"] == 0
        assert again["moved_extents"] == 0

    def test_compaction_is_charged_on_its_own_timeline(self):
        pool = MemoryPool(2, stripe_bytes=STRIPE)
        for i in range(16):
            pool.alloc(f"o{i}", _alloc_blob(4 * KIB, seed=i))
        for i in range(0, 16, 2):
            pool.free(f"o{i}")
        t_main = pool.clock.now("main")
        stats = pool.compact()
        assert stats["compacted_extents"] > 0
        assert pool.clock.now("main") == t_main    # reads don't pay for it
        assert pool.clock.now("compaction") > 0.0


class TestEffectiveCapacitySizing:
    def test_effective_capacity_floors_at_one(self):
        assert effective_node_capacity(10 * KIB) == 10 * KIB
        assert effective_node_capacity(10 * KIB, 4 * KIB) == 6 * KIB
        assert effective_node_capacity(10 * KIB, 100 * KIB) == 1

    def test_pool_nodes_needed(self):
        cap = 16 * KIB
        assert pool_nodes_needed(0, node_capacity_bytes=cap) == 1
        assert pool_nodes_needed(cap, node_capacity_bytes=cap) == 1
        assert pool_nodes_needed(cap + 1, node_capacity_bytes=cap) == 2
        assert pool_nodes_needed(3 * cap, replication=2,
                                 node_capacity_bytes=cap) == 6
        # fragmentation shrinks effective capacity -> more nodes
        assert pool_nodes_needed(3 * cap, node_capacity_bytes=cap,
                                 frag_bytes_per_node=cap / 2) == 6
        # clamps
        assert pool_nodes_needed(100 * cap, node_capacity_bytes=cap,
                                 max_nodes=4) == 4
        assert pool_nodes_needed(1, node_capacity_bytes=cap,
                                 min_nodes=3) == 3


class TestAllocatorProperties:
    """Random interleavings (tentpole property battery): bookkeeping and
    data integrity hold at every step, not just at quiescence."""

    @settings(max_examples=10, deadline=None)
    @given(st.data())
    def test_random_churn_keeps_reads_bit_identical(self, data):
        pool = MemoryPool(data.draw(st.integers(1, 3)),
                          stripe_bytes=8 * KIB,
                          replication=data.draw(st.integers(1, 2)))
        expected: dict[str, np.ndarray] = {}
        arena_of: dict[str, str] = {}
        seq = 0
        for _ in range(data.draw(st.integers(6, 14))):
            op = data.draw(st.sampled_from(
                ["alloc", "free", "write", "resize_obj", "compact",
                 "add_nodes", "drain"]))
            if op == "alloc":
                name = f"obj{seq}"
                seq += 1
                arena = data.draw(st.sampled_from(["hpc", "serving"]))
                blob = _alloc_blob(data.draw(st.integers(1, 40)) * KIB, seed=seq)
                pool.alloc(name, blob, client=arena)
                expected[name] = blob
                arena_of[name] = arena
            elif op == "free" and expected:
                name = data.draw(st.sampled_from(sorted(expected)))
                pool.free(name)
                del expected[name]
                del arena_of[name]
            elif op == "write" and expected:
                name = data.draw(st.sampled_from(sorted(expected)))
                seq += 1
                blob = _alloc_blob(expected[name].nbytes, seed=1000 + seq)
                pool.write(name, blob, sync=True)
                expected[name] = blob
            elif op == "resize_obj" and expected:
                name = data.draw(st.sampled_from(sorted(expected)))
                seq += 1
                pool.free(name)
                blob = _alloc_blob(data.draw(st.integers(1, 40)) * KIB,
                             seed=2000 + seq)
                pool.alloc(name, blob, client=arena_of[name])
                expected[name] = blob
            elif op == "compact":
                before = pool.fragmentation_stats()["external_frag_bytes"]
                pool.compact()
                after = pool.fragmentation_stats()["external_frag_bytes"]
                assert after <= before + 1e-9
            elif op == "add_nodes":
                if len(pool.alive_nodes()) < 5:
                    pool.add_nodes(1)
            elif op == "drain":
                alive = [n.node_id for n in pool.alive_nodes()]
                if len(alive) > 1:
                    pool.drain_nodes([data.draw(st.sampled_from(alive))])
            _alloc_assert_all_readable(pool, expected)
            pool.check_no_orphans()
            self._assert_allocator_consistent(pool, arena_of)

    @staticmethod
    def _assert_allocator_consistent(pool, arena_of):
        # allocator extent count == directory replica count
        dir_replicas = sum(
            len(ext.replicas)
            for po in pool._directory.values()
            for ext in po.extents
        )
        s = pool._allocator.stats()
        assert s["n_extents"] == dir_replicas
        # every slab is single-arena and matches the owning object's tenant
        for node in pool.alive_nodes():
            for slab in pool._allocator.slabs_on(node.node_id):
                for key in slab.slots.values():
                    name = key.rsplit("#e", 1)[0]
                    assert slab.arena == arena_of.get(
                        name, slab.arena
                    ), f"{key} in arena {slab.arena}"
                assert 0 < slab.used_slots <= slab.n_slots
        # per-arena live bytes reconcile with the directory
        per = pool._allocator.arena_stats()
        for arena in set(arena_of.values()):
            dir_bytes = sum(
                ext.nbytes * len(ext.replicas)
                for name, po in pool._directory.items()
                for ext in po.extents
                if arena_of[name] == arena
            )
            got = per.get(arena, {"live_bytes": 0})["live_bytes"]
            assert got == dir_bytes, f"arena {arena}: {got} != {dir_bytes}"


# -- the memory pool (ported from tests/test_pool.py) -----------------------------------------

def _blob(nbytes, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, size=nbytes, dtype=np.uint8
    )


class TestStriping:
    def test_striped_read_equals_oracle(self):
        arr = np.random.default_rng(1).standard_normal((64, 1024))
        pool = MemoryPool(4, stripe_bytes=64 * KIB)
        pool.alloc("x", arr)
        got, _end = pool.read_object("x")
        assert got.shape == arr.shape and got.dtype == arr.dtype
        assert np.array_equal(got, arr)

    def test_partial_read_equals_oracle_bytes(self):
        raw = _blob(300 * KIB, seed=2)
        pool = MemoryPool(3, stripe_bytes=64 * KIB)
        pool.alloc("x", raw)
        chunk, _ = pool.read("x", offset=100 * KIB, nbytes=120 * KIB)
        assert np.array_equal(chunk, raw[100 * KIB : 220 * KIB])

    def test_extents_spread_over_nodes(self):
        pool = MemoryPool(4, stripe_bytes=64 * KIB)
        pool.alloc("x", _blob(1 * MIB))
        assert all(n.total_bytes() > 0 for n in pool.nodes)

    def test_aggregate_bandwidth_scales(self):
        """4-node striped read > 2x single-node (the acceptance bar)."""
        raw = _blob(4 * MIB)

        def eff_bw(n_nodes):
            pool = MemoryPool(n_nodes, stripe_bytes=256 * KIB)
            pool.alloc("x", raw)
            _d, end = pool.read("x", issue_at_us=0.0, sync=False)
            return raw.nbytes / end

        assert eff_bw(4) > 2 * eff_bw(1)

    def test_write_then_read_roundtrip(self):
        pool = MemoryPool(3, stripe_bytes=64 * KIB, replication=2)
        a = _blob(200 * KIB, seed=3)
        b = _blob(200 * KIB, seed=4)
        pool.alloc("x", a)
        pool.write("x", b)
        got, _ = pool.read_object("x")
        assert np.array_equal(got, b)  # RAW ordering across all replicas

    def test_small_object_single_extent(self):
        pool = MemoryPool(4, stripe_bytes=1 * MIB)
        pool.alloc("s", np.arange(16))
        assert len(pool._directory["s"].extents) == 1


class TestRouting:
    def test_reads_spread_over_qps(self):
        pool = MemoryPool(2, stripe_bytes=64 * KIB, qps_per_node=2)
        pool.alloc("x", _blob(1 * MIB))
        for _ in range(4):
            pool.read("x")
        busy = [r for r in pool.resources if r.bytes_read > 0]
        assert len(busy) > 2  # least-loaded pick uses both QPs per node

    def test_replica_choice_prefers_idle_node(self):
        pool = MemoryPool(2, stripe_bytes=1 * MIB, replication=2)
        pool.alloc("x", _blob(64 * KIB))
        # occupy node 0's only QP far into the future
        pool.nodes[0].resources[0].issue("read", 32 * MIB, 0.0)
        _d, end = pool.read("x", issue_at_us=0.0, sync=False)
        # served from idle node 1, not queued behind node 0's transfer
        assert end < pool.nodes[0].resources[0].free_at

    def test_stream_read_spreads_under_replication(self):
        """With k=2 every extent has 2 candidate nodes; the stream path must
        still split the transfer instead of collapsing onto the lowest id."""
        size = 1 * MIB
        shares = {}
        ends = {}
        for repl in (1, 2):
            pool = MemoryPool(2, stripe_bytes=128 * KIB, replication=repl)
            pool.alloc("x", _blob(size))
            shares[repl] = pool._node_shares("x")
            ends[repl] = pool.stream_read("x", chunk_bytes=128 * KIB,
                                          issue_at=0.0, mode="pipelined")
        assert len(shares[2]) == 2  # both nodes serve
        assert max(shares[2].values()) <= size * 3 // 4  # roughly balanced
        # replicated stream reads keep (most of) the 2-node speedup
        assert ends[2] < ends[1] * 1.5

    def test_atomics_routed_and_consistent(self):
        pool = MemoryPool(3)
        assert pool.atomic_fetch_add("ctr", 5) == 0
        assert pool.atomic_fetch_add("ctr", 2) == 5
        assert pool.atomic_cas("ctr", 7, 11)
        assert pool.atomic_read("ctr") == 11


class TestFailure:
    def test_killed_node_raises(self):
        pool = MemoryPool(2)
        pool.fail_node(1)
        with pytest.raises(NodeFailure):
            pool.nodes[1].alloc("x", np.zeros(4))

    def test_replicated_read_survives_node_loss(self):
        arr = np.random.default_rng(5).standard_normal(128 * KIB // 8)
        pool = MemoryPool(4, stripe_bytes=32 * KIB, replication=2)
        pool.alloc("x", arr)
        before = pool.read_object("x")[0]
        pool.fail_node(2)
        after = pool.read_object("x")[0]
        assert np.array_equal(before, arr)
        assert np.array_equal(after, arr)  # bit-identical under failure

    def test_unreplicated_loss_raises_extent_lost(self):
        pool = MemoryPool(2, stripe_bytes=32 * KIB, replication=1)
        pool.alloc("x", _blob(128 * KIB))
        pool.fail_node(0)
        with pytest.raises(ExtentLostError):
            pool.read_object("x")

    def test_recover_rebuilds_replication_and_charges_time(self):
        pool = MemoryPool(4, stripe_bytes=32 * KIB, replication=2)
        arr = _blob(256 * KIB, seed=6)
        pool.alloc("x", arr)
        pool.fail_node(1)
        assert pool.degraded_extents()
        stats = pool.recover()
        assert stats["rebuilt_extents"] > 0
        assert stats["recovery_us"] > 0  # re-replication isn't free
        assert not pool.degraded_extents()
        got, _ = pool.read_object("x")
        assert np.array_equal(got, arr)

    def test_recover_without_source_raises(self):
        pool = MemoryPool(2, stripe_bytes=32 * KIB, replication=1)
        pool.alloc("x", _blob(64 * KIB))
        pool.fail_node(0)
        with pytest.raises(ExtentLostError):
            pool.recover()

    def test_write_to_lost_extent_raises(self):
        """A write whose data would be dropped must not report success."""
        pool = MemoryPool(2, stripe_bytes=32 * KIB, replication=1)
        pool.alloc("x", _blob(128 * KIB))
        pool.fail_node(0)
        with pytest.raises(ExtentLostError):
            pool.write("x", _blob(128 * KIB, seed=1))
        with pytest.raises(ExtentLostError):
            pool.stream_write("x", _blob(128 * KIB, seed=1),
                              chunk_bytes=32 * KIB, issue_at=0.0)

    def test_atomic_routing_stable_under_unrelated_failure(self):
        """Killing an unrelated node must not remap atomic keys."""
        pool = MemoryPool(3)
        pool.atomic_fetch_add("ctr", 5)
        holder = pool._atomic_node("ctr").node_id
        victim = next(i for i in range(3) if i != holder)
        pool.fail_node(victim)
        assert pool._atomic_node("ctr").node_id == holder
        assert pool.atomic_read("ctr") == 5

    def test_finalize_respects_replicated_capacity(self):
        """The review repro: plan capacity must account for replication.

        Two 800 KiB objects on a 2-node/1 MiB-capacity/k=2 pool used to pass
        planning (800K <= 1M per home) then crash in pool.alloc because every
        node needs both replicas (~1.6 MiB). Now the plan (or the physical
        fallback) keeps them local and finalize completes.
        """
        pool = MemoryPool(2, replication=2, stripe_bytes=64 * KIB,
                          node_capacity_bytes=1 * MIB)
        rt = DolmaRuntime(local_fraction=0.0, store=pool,
                          policy=PlacementPolicy(all_large_remote=True))
        rt.alloc("a", np.zeros(800 * KIB, dtype=np.uint8))
        rt.alloc("b", np.zeros(800 * KIB, dtype=np.uint8))
        plan = rt.finalize()  # must not raise
        from repro_torch.core.metadata import Tier
        for name in ("a", "b"):
            assert plan.tier_of(name) is rt.metadata.get(name).tier
        # whatever went remote physically fits, replicas included
        for node in pool.nodes:
            assert node.stored_bytes() <= 1 * MIB
        with rt.step():
            assert rt.fetch("a").nbytes == 800 * KIB  # still usable

    def test_recover_skips_full_target_nodes(self):
        """Recovery must degrade gracefully when survivors are at capacity."""
        cap = 160 * KIB
        pool = MemoryPool(3, stripe_bytes=32 * KIB, replication=2,
                          node_capacity_bytes=cap)
        arr = _blob(96 * KIB, seed=8)
        pool.alloc("x", arr)  # 3 extents x 2 replicas over 3 nodes
        # fill remaining capacity on every node so no replica can move
        for node in pool.nodes:
            pad = cap - node.stored_bytes()
            if pad > 0:
                node.alloc(f"pad{node.node_id}", np.zeros(pad, dtype=np.uint8))
        pool.fail_node(0)
        stats = pool.recover()  # must not raise MemoryError
        assert stats["rebuilt_extents"] == 0
        assert stats["skipped_extents"] > 0
        got, _ = pool.read_object("x")  # degraded but intact via replicas
        assert np.array_equal(got, arr)

    def test_alloc_capacity_failure_rolls_back(self):
        """A mid-stripe MemoryError must not leak orphan extents."""
        pool = MemoryPool(2, stripe_bytes=4 * KIB,
                          node_capacity_bytes=8 * KIB)
        with pytest.raises(MemoryError):
            pool.alloc("big", _blob(20 * KIB))
        assert "big" not in pool
        assert pool.physical_bytes() == 0  # capacity fully reclaimed
        pool.alloc("big", _blob(8 * KIB))  # same name now fits cleanly
        assert np.array_equal(pool.payload("big"), _blob(8 * KIB))


class TestPoolStats:
    def test_logical_vs_physical_bytes(self):
        pool = MemoryPool(3, stripe_bytes=32 * KIB, replication=2)
        pool.alloc("x", _blob(96 * KIB))
        assert pool.total_bytes() == 96 * KIB
        assert pool.physical_bytes() == 2 * 96 * KIB
        s = pool.stats()
        assert s["n_nodes"] == 3 and s["n_alive"] == 3
        assert len(s["per_node"]) == 3

    def test_snapshot_restore_roundtrip(self):
        pool = MemoryPool(3, stripe_bytes=32 * KIB)
        arr = np.arange(64 * KIB // 8, dtype=np.float64)
        pool.alloc("x", arr)
        blobs = pool.snapshot_objects()
        pool.write("x", np.zeros_like(arr))
        pool.restore_objects(blobs)
        assert np.array_equal(pool.payload("x"), arr)


class TestPlacementNodes:
    def test_remote_objects_assigned_to_nodes(self):
        from repro_torch.core.objects import DataObject, ObjectCatalog

        objs = [
            DataObject(name=f"o{i}", shape=(64 * KIB,), dtype=np.uint8)
            for i in range(8)
        ]
        plan = PlacementPolicy().plan(
            ObjectCatalog(objs), local_fraction=0.0, n_nodes=4
        )
        assert set(plan.node_of) == {o.name for o in objs}
        loads = plan.node_bytes()
        assert len(loads) == 4
        assert max(loads.values()) - min(loads.values()) <= 64 * KIB

    def test_node_capacity_keeps_overflow_local(self):
        from repro_torch.core.metadata import Tier
        from repro_torch.core.objects import DataObject, ObjectCatalog

        objs = [
            DataObject(name=f"o{i}", shape=(64 * KIB,), dtype=np.uint8)
            for i in range(4)
        ]
        plan = PlacementPolicy().plan(
            ObjectCatalog(objs), local_fraction=0.0,
            n_nodes=2, node_capacity_bytes=64 * KIB,
        )
        remote = plan.remote_names()
        assert len(remote) == 2  # one per node; the rest stay local
        for name, tier in plan.tiers.items():
            if name not in remote:
                assert tier is Tier.LOCAL
        assert all(v <= 64 * KIB for v in plan.node_bytes().values())


class TestSchedulerPool:
    def test_clusters_prefer_distinct_nodes(self):
        pool = MemoryPool(4, qps_per_node=1)
        sched = TwoLevelScheduler(
            n_threads=8, threads_per_cluster=2,
            buffer_bytes=8 * MIB, pool=pool,
        )
        prefs = {sched.node_of_cluster(c) for c in range(sched.n_clusters)}
        assert prefs == {0, 1, 2, 3}

    def test_failed_node_not_preferred(self):
        pool = MemoryPool(2)
        sched = TwoLevelScheduler(
            n_threads=4, threads_per_cluster=2,
            buffer_bytes=8 * MIB, pool=pool,
        )
        pool.fail_node(0)
        for c in range(sched.n_clusters):
            assert sched.node_of_cluster(c) == 1
        assert sched.resource_of(0) in pool.nodes[1].resources

    def test_pool_simulation_uses_pool_qps(self):
        pool = MemoryPool(2, qps_per_node=1)
        sched = TwoLevelScheduler(
            n_threads=4, threads_per_cluster=2,
            buffer_bytes=8 * MIB, pool=pool,
        )
        makespan = sched.simulate(
            n_iters=2, compute_us_total=100.0, fetch_bytes_total=4 * MIB
        )
        assert makespan > 0
        assert sum(r.bytes_read for r in pool.resources) > 0

    def test_shared_clock_enforced(self):
        pool = MemoryPool(2)
        with pytest.raises(ValueError):
            TwoLevelScheduler(
                n_threads=2, buffer_bytes=MIB, pool=pool, clock=SimClock()
            )


class TestRuntimeOnPool:
    def test_workload_bit_exact_on_pool(self):
        cls = WORKLOADS["CG"]
        oracle = run_workload(cls(scale=0.2, seed=3),
                              DolmaRuntime(local_fraction=1.0), n_iters=3)
        pooled = run_workload(
            cls(scale=0.2, seed=3),
            pooled_runtime(4, local_fraction=0.2, replication=2,
                           stripe_bytes=64 * KIB, sim_scale=1000.0 / 0.2),
            n_iters=3,
        )
        assert pooled.checksum == pytest.approx(oracle.checksum, rel=1e-9)
        assert pooled.stats["n_nodes"] == 4

    def test_pool_faster_than_single_node_remote(self):
        """More nodes = more aggregate fabric; same workload, same budget."""
        cls = WORKLOADS["CG"]

        def elapsed(n_nodes):
            rt = pooled_runtime(
                n_nodes, local_fraction=0.2, stripe_bytes=64 * KIB,
                sim_scale=1000.0 / 0.2, dual_buffer=False,
                policy=PlacementPolicy(all_large_remote=True),
            )
            return run_workload(cls(scale=0.2, seed=3), rt, 3).elapsed_us

        assert elapsed(4) < elapsed(1)

    def test_plan_homes_match_pool_directory(self):
        rt = pooled_runtime(3, local_fraction=0.0, stripe_bytes=1 * MIB,
                            policy=PlacementPolicy(all_large_remote=True))
        rt.alloc("a", np.zeros(256 * KIB // 8))
        rt.alloc("b", np.zeros(256 * KIB // 8))
        plan = rt.finalize()
        for name in plan.remote_names():
            assert rt.store._directory[name].home == plan.node_of[name]


# -- the elastic pool (ported from tests/test_pool_elastic.py) --------------------------------

def _elastic_blob(nbytes, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, size=max(nbytes, 1), dtype=np.uint8
    )


def _extent_counts(pool, name):
    counts: dict[int, int] = {}
    for ext in pool._directory[name].extents:
        for nid in ext.replicas:
            counts[nid] = counts.get(nid, 0) + 1
    return counts


def _assert_balanced(pool):
    """Per-object: extent counts across alive nodes within one stripe of
    balanced per replica rank (what canonical round-robin striping gives)."""
    alive = [n.node_id for n in pool.alive_nodes()]
    for name in pool.names():
        counts = _extent_counts(pool, name)
        vals = [counts.get(i, 0) for i in alive]
        assert max(vals) - min(vals) <= pool.replication, (name, counts)


def _elastic_assert_all_readable(pool, expected):
    for name, blob in expected.items():
        got, _end = pool.read_object(name)
        np.testing.assert_array_equal(got, blob)


class TestAddNodes:
    def test_reads_bit_identical_and_balanced(self):
        pool = MemoryPool(2, stripe_bytes=16 * KIB)
        expected = {}
        for i in range(4):
            expected[f"o{i}"] = _elastic_blob((i + 1) * 50 * KIB, seed=i)
            pool.alloc(f"o{i}", expected[f"o{i}"])
        stats = pool.add_nodes(2)
        assert stats["n_alive"] == 4
        assert stats["moved_extents"] > 0
        _elastic_assert_all_readable(pool, expected)
        _assert_balanced(pool)

    def test_new_nodes_actually_serve_reads(self):
        pool = MemoryPool(1, stripe_bytes=16 * KIB)
        pool.alloc("x", _elastic_blob(256 * KIB))
        pool.add_nodes(3)
        pool.read("x")
        serving = [n.node_id for n in pool.nodes
                   if any(r.bytes_read for r in n.resources)]
        assert len(serving) == 4  # striped read touches every node

    def test_bandwidth_scales_after_growth(self):
        raw = _elastic_blob(4 << 20)
        single = MemoryPool(1, stripe_bytes=256 * KIB)
        single.alloc("x", raw)
        _d, end1 = single.read("x", issue_at_us=0.0, sync=False)
        grown = MemoryPool(1, stripe_bytes=256 * KIB)
        grown.alloc("x", raw)
        grown.add_nodes(3)
        # issue once migration's QP occupancy drains (steady state)
        t0 = max(r.free_at for r in grown.resources)
        _d, end4 = grown.read("x", issue_at_us=t0, sync=False)
        assert end4 - t0 < end1 / 2  # 4 nodes read >2x faster than 1

    def test_migration_charges_own_timeline_not_main(self):
        pool = MemoryPool(1, stripe_bytes=16 * KIB)
        pool.alloc("x", _elastic_blob(128 * KIB))
        main_before = pool.clock.now("main")
        stats = pool.add_nodes(1)
        assert stats["migration_us"] > 0.0  # fabric time really charged
        assert pool.clock.now("main") == main_before  # reads never stalled

    def test_replication_preserved(self):
        pool = MemoryPool(2, stripe_bytes=16 * KIB, replication=2)
        pool.alloc("x", _elastic_blob(100 * KIB, seed=7))
        pool.add_nodes(2)
        for ext in pool._directory["x"].extents:
            assert len(set(ext.replicas)) == 2

    def test_invalid_count_rejected(self):
        with pytest.raises(ValueError):
            MemoryPool(2).add_nodes(0)

    def test_atomics_rehomed_on_growth(self):
        """Growth changes the atomic hash space (crc32 % n_nodes): counters
        must follow their new homes, not read back as 0 from a fresh node."""
        pool = MemoryPool(2)
        for i in range(12):
            pool.atomic_fetch_add(f"ctr{i}", i + 1)
        pool.add_nodes(3)
        for i in range(12):
            assert pool.atomic_read(f"ctr{i}") == i + 1
        assert pool.atomic_fetch_add("ctr0", 5) == 1  # RMW keeps working


class TestDrainNode:
    def test_reads_bit_identical_after_drain(self):
        pool = MemoryPool(3, stripe_bytes=16 * KIB, replication=2)
        expected = {f"o{i}": _elastic_blob(70 * KIB, seed=10 + i) for i in range(3)}
        for name, blob in expected.items():
            pool.alloc(name, blob)
        stats = pool.drain_node(1)
        assert stats["drained_nodes"] == [1]
        _elastic_assert_all_readable(pool, expected)
        assert all(
            1 not in ext.replicas
            for po in pool._directory.values() for ext in po.extents
        )
        # retired node serves nothing further
        with pytest.raises(NodeFailure):
            pool.nodes[1].alloc("y", _elastic_blob(1 * KIB))

    def test_replication_preserved_through_drain(self):
        pool = MemoryPool(3, stripe_bytes=16 * KIB, replication=2)
        pool.alloc("x", _elastic_blob(100 * KIB, seed=3))
        pool.drain_node(0)
        for ext in pool._directory["x"].extents:
            assert len(set(ext.replicas)) == 2
            assert 0 not in ext.replicas

    def test_atomics_rehomed(self):
        pool = MemoryPool(3)
        for i in range(8):
            pool.atomic_fetch_add(f"ctr{i}", i + 1)
        pool.drain_node(2)
        pool.drain_node(1)
        for i in range(8):
            assert pool.atomic_read(f"ctr{i}") == i + 1

    def test_refuses_last_node_with_data(self):
        pool = MemoryPool(1)
        pool.alloc("x", _elastic_blob(8 * KIB))
        with pytest.raises(NodeFailure):
            pool.drain_node(0)
        got, _ = pool.read_object("x")  # refusal lost nothing
        np.testing.assert_array_equal(got, _elastic_blob(8 * KIB))

    def test_refuses_last_node_holding_only_atomics(self):
        """An atomics-only last node must refuse the drain *before* clearing
        anything — the counters are state too."""
        pool = MemoryPool(1)
        pool.atomic_fetch_add("ctr", 7)
        with pytest.raises(NodeFailure):
            pool.drain_node(0)
        assert pool.atomic_read("ctr") == 7  # refusal lost nothing

    def test_empty_last_node_can_drain(self):
        pool = MemoryPool(1)
        pool.drain_node(0)
        assert len(pool.alive_nodes()) == 0

    def test_refuses_when_survivors_lack_capacity(self):
        pool = MemoryPool(2, stripe_bytes=16 * KIB,
                          node_capacity_bytes=64 * KIB)
        blob = _elastic_blob(100 * KIB, seed=5)
        pool.alloc("x", blob)
        with pytest.raises(MemoryError):
            pool.drain_node(0)
        got, _ = pool.read_object("x")  # data fully intact after refusal
        np.testing.assert_array_equal(got, blob)
        # growing first unblocks the drain
        pool.add_nodes(2)
        pool.drain_node(0)
        got, _ = pool.read_object("x")
        np.testing.assert_array_equal(got, blob)

    def test_capacity_refusal_preserves_replication(self):
        """A refused drain must leave every extent at full replication —
        the capacity fallback may never trade a survivor's copy for one
        pinned on the draining node."""
        pool = MemoryPool(3, stripe_bytes=16 * KIB, replication=2,
                          node_capacity_bytes=40 * KIB)
        blob = _elastic_blob(48 * KIB, seed=9)  # 3 extents x 2 replicas, ~32K/node
        pool.alloc("x", blob)
        with pytest.raises(MemoryError):
            pool.drain_node(0)  # survivors lack headroom for a 3rd extent
        got, _ = pool.read_object("x")
        np.testing.assert_array_equal(got, blob)
        for ext in pool._directory["x"].extents:
            assert len(pool._live_replicas("x", ext)) == 2

    def test_batch_drain_is_one_migration_pass(self):
        pool = MemoryPool(4, stripe_bytes=16 * KIB)
        expected = {f"o{i}": _elastic_blob(60 * KIB, seed=20 + i) for i in range(3)}
        for name, blob in expected.items():
            pool.alloc(name, blob)
        stats = pool.drain_nodes([1, 3])
        assert stats["drained_nodes"] == [1, 3]
        assert len(pool._resizes) == 1  # shrink-by-2 = one re-stripe
        _elastic_assert_all_readable(pool, expected)
        assert all(
            not ({1, 3} & set(ext.replicas))
            for po in pool._directory.values() for ext in po.extents
        )

    def test_oscillating_resize_reuses_retired_slots(self):
        """Grow/shrink cycles must not grow self.nodes without bound."""
        pool = MemoryPool(1, stripe_bytes=8 * KIB)
        blob = _elastic_blob(40 * KIB, seed=2)
        pool.alloc("x", blob)
        pool.atomic_fetch_add("ctr", 3)
        for _ in range(3):
            pool.add_nodes(2)
            alive = sorted(n.node_id for n in pool.alive_nodes())
            pool.drain_nodes(alive[1:])
        assert len(pool.nodes) == 3  # retired slots reused, not appended
        got, _ = pool.read_object("x")
        np.testing.assert_array_equal(got, blob)
        assert pool.atomic_read("ctr") == 3  # survived every membership flip

    def test_drain_then_write_then_read(self):
        pool = MemoryPool(3, stripe_bytes=16 * KIB)
        pool.alloc("x", _elastic_blob(90 * KIB, seed=1))
        pool.drain_node(2)
        new = _elastic_blob(90 * KIB, seed=2)
        pool.write("x", new)
        got, _ = pool.read_object("x")
        np.testing.assert_array_equal(got, new)

    def test_alloc_after_drain_avoids_retired_node(self):
        pool = MemoryPool(3, stripe_bytes=16 * KIB)
        pool.drain_node(1)
        pool.alloc("x", _elastic_blob(100 * KIB))
        assert all(
            1 not in ext.replicas
            for ext in pool._directory["x"].extents
        )


class TestElasticProperties:
    """Random alloc/write/resize/drain sequences: every
    object's read stays bit-identical at every step, and extent placement
    stays within one stripe of balanced after each ``add_nodes``."""

    @settings(max_examples=12, deadline=None)
    @given(st.data())
    def test_random_resize_sequence(self, data):
        n0 = data.draw(st.integers(1, 3))
        repl = data.draw(st.integers(1, 2))
        pool = MemoryPool(n0, stripe_bytes=8 * KIB, replication=repl)
        expected: dict[str, np.ndarray] = {}
        seq = 0
        n_ops = data.draw(st.integers(4, 9))
        for _ in range(n_ops):
            op = data.draw(st.sampled_from(
                ["alloc", "write", "add_nodes", "drain"]))
            if op == "alloc":
                name = f"obj{seq}"
                seq += 1
                blob = _elastic_blob(data.draw(st.integers(1, 80)) * KIB, seed=seq)
                pool.alloc(name, blob)
                expected[name] = blob
            elif op == "write" and expected:
                name = data.draw(st.sampled_from(sorted(expected)))
                seq += 1
                blob = _elastic_blob(expected[name].nbytes, seed=1000 + seq)
                pool.write(name, blob)
                expected[name] = blob
            elif op == "add_nodes":
                if len(pool.alive_nodes()) >= 6:
                    continue
                pool.add_nodes(data.draw(st.integers(1, 2)))
                _assert_balanced(pool)
            elif op == "drain":
                alive = [n.node_id for n in pool.alive_nodes()]
                if len(alive) <= 1:
                    continue
                pool.drain_node(data.draw(st.sampled_from(alive)))
            _elastic_assert_all_readable(pool, expected)
        _elastic_assert_all_readable(pool, expected)
        assert pool.total_bytes() == sum(b.nbytes for b in expected.values())


# -- remote-memory semantics (ported from tests/test_remote_semantics.py) ---------------------

class TestReadAfterWrite:
    def test_read_waits_for_async_write(self):
        store = RemoteStore()
        store.alloc("x", np.zeros(64 * KIB))
        end = store.write("x", np.ones(64 * KIB), timeline="writer")
        data, t_read = store.read("x", timeline="reader")
        assert t_read >= end
        assert np.all(data.view(np.float64) == 1.0)

    def test_stream_read_orders_after_pending_write(self):
        store = RemoteStore()
        store.alloc("x", np.zeros(64 * KIB))
        w_end = store.stream_write("x", np.ones(64 * KIB),
                                   chunk_bytes=16 * KIB, issue_at=0.0)
        r_end = store.stream_read("x", chunk_bytes=16 * KIB, issue_at=0.0)
        assert r_end > w_end

    def test_pool_read_after_write(self):
        pool = MemoryPool(3, stripe_bytes=16 * KIB, replication=2)
        pool.alloc("x", np.zeros(64 * KIB, dtype=np.uint8))
        pool.write("x", np.full(64 * KIB, 9, dtype=np.uint8), timeline="w")
        data, _ = pool.read("x", timeline="r")
        assert np.all(data == 9)


class TestFence:
    def test_fence_subset_waits_only_for_named(self):
        clock = SimClock()
        store = RemoteStore(clock=clock)
        store.alloc("fast", np.zeros(4 * KIB))
        store.alloc("slow", np.zeros(16 * MIB))
        store.write("fast", np.ones(4 * KIB), timeline="w")
        store.write("slow", np.ones(16 * MIB), timeline="w")
        t_subset = store.fence(["fast"], timeline="a")
        t_all = store.fence(timeline="b")
        assert t_subset < t_all

    def test_fence_skips_concurrently_freed_names(self):
        store = RemoteStore()
        store.alloc("x", np.zeros(4 * KIB))
        store.free("x")
        # seed behavior: KeyError; now a freed name has nothing to order on
        assert store.fence(["x", "never-existed"]) == 0.0

    def test_pool_fence_subset(self):
        pool = MemoryPool(2, stripe_bytes=16 * KIB)
        pool.alloc("x", np.zeros(64 * KIB, dtype=np.uint8))
        end = pool.write("x", np.ones(64 * KIB, dtype=np.uint8))
        t = pool.fence(["x", "ghost"], timeline="f")
        assert t >= end


class TestMultiResourceAccounting:
    def test_stats_sum_and_break_down_by_qp(self):
        store = RemoteStore(n_resources=3)
        store.alloc("x", np.zeros(96 * KIB))
        for res in store.resources:
            store.read("x", resource=res, nbytes=32 * KIB)
        s = store.stats()
        assert s["bytes_read"] == 96 * KIB
        assert [r["bytes_read"] for r in s["per_resource"]] == [32 * KIB] * 3
        assert s["n_ops"] == sum(r["n_ops"] for r in s["per_resource"])

    def test_write_accounting(self):
        store = RemoteStore(n_resources=2)
        store.alloc("x", np.zeros(64 * KIB))
        store.write("x", np.ones(64 * KIB), resource=store.resources[1])
        s = store.stats()
        assert s["bytes_written"] == 64 * KIB * 8  # float64 object
        assert s["per_resource"][0]["bytes_written"] == 0

    def test_least_loaded_resource_tracks_free_at(self):
        store = RemoteStore(n_resources=2)
        store.alloc("x", np.zeros(4 * MIB))
        busy = store.resources[0]
        busy.issue("read", 32 * MIB, 0.0)
        assert store.least_loaded_resource() is store.resources[1]


class TestThreadSafety:
    def test_concurrent_contains_nbytes_read_free(self):
        """The seed raced unlocked __contains__/nbytes/read against free."""
        store = RemoteStore()
        errors = []

        def churn(i):
            try:
                for k in range(200):
                    name = f"t{i}_{k}"
                    store.alloc(name, np.zeros(1 * KIB))
                    assert name in store
                    assert store.nbytes(name) == 1 * KIB * 8
                    store.read(name, timeline=f"tl{i}")
                    store.free(name)
                    store.fence([name], timeline=f"tl{i}")
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors

    def test_fence_all_with_concurrent_free(self):
        store = RemoteStore()
        for i in range(32):
            store.alloc(f"o{i}", np.zeros(1 * KIB))
        stop = threading.Event()

        def freeer():
            for i in range(32):
                store.free(f"o{i}")
            stop.set()

        t = threading.Thread(target=freeer)
        t.start()
        while not stop.is_set():
            store.fence(timeline="main")
        t.join()


def test_capacity_limit_enforced():
    store = RemoteStore(capacity_bytes=8 * KIB)
    store.alloc("a", np.zeros(4 * KIB, dtype=np.uint8))
    with pytest.raises(MemoryError):
        store.alloc("b", np.zeros(8 * KIB, dtype=np.uint8))
    store.free("a")
    store.alloc("b", np.zeros(8 * KIB, dtype=np.uint8))


# -- the benchmark gates: BENCH_pr7.json and fig_pool_scaling ---------------

@pytest.fixture(scope="module")
def pkgs():
    return H.package("repro"), H.package("repro_torch")


def test_alloc_churn_reproduces_bench_pr7(pkgs):
    """The full 10000-round churn through the port gives
    ``BENCH_pr7.json``'s fragmentation ratios, compactions, resizes and
    verified reads exactly (``ops_per_s`` is wall clock and excluded)."""
    got = H.alloc_churn(pkgs[1], rounds=10_000)
    want = H.committed("BENCH_pr7")
    assert want["rounds"] == 10_000
    for key in H.CHURN_KEYS + ("live_objects", "live_bytes",
                               "internal_frag_bytes", "external_frag_bytes"):
        assert got[key] == want[key], key


def test_alloc_churn_smoke_matches_reference(pkgs):
    """The 800-round churn: every number, the ratio at each compaction
    included, equal to the reference's."""
    ref, pt = (H.alloc_churn(p, rounds=800) for p in pkgs)
    assert pt == ref


def test_pool_scaling_matches_reference(pkgs):
    """fig_pool_scaling's asserts hold through the port (4-node scaling
    above 2x, failure runs bit-identical to the clean run), with the
    reference's bandwidths, times and checksums."""
    ref, pt = (H.pool_scaling(p) for p in pkgs)
    assert pt == ref
    assert all(per[4]["scaling_x"] > 2.0 for per in pt["bandwidth"].values())
