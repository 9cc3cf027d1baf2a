"""Batched serving engine with DOLMA-tiered KV cache and online autoscaling.

A port of ``repro.serving.engine``. The engine runs batched greedy decoding
over a fixed slot pool, on the device its parameters are on. DOLMA
integration: the KV cache is cataloged as data objects (one per leaf); the
placement policy decides, from the HBM budget, whether cache tiers stay
device-local or overflow — mirroring §4.2's local-region/remote-region
split for serving workloads. On a card a demoted tier would be pinned host
memory behind the copy stream (``placement_summary()`` says so); with
``pool_nodes`` the demoted tiers are written to the multi-node memory pool
after every wave.

Online autoscaling (DESIGN.md §8) closes sizing → capacity: every
``generate()`` wave appends its KV fetch/commit traffic to a rolling
:class:`~repro_torch.core.sizing.RollingProfile`; every ``readvise_every``
waves the quantitative sizing advisor re-runs against the degradation
target, the advised budget is translated into pool capacity (``add_nodes``
/ ``drain_node`` with background extent migration), and the old→new
placement plans are *diffed* into promote/demote object moves instead of a
full re-offload.

The decode step is :func:`~repro_torch.models.transformer.decode_step`
called eagerly; it writes K/V into the engine's cache in place. The pool
and the sizing advisor are numpy, as in the reference, so the autoscale
and admission decisions equal the reference's.

MoE expert paging (DESIGN.md §13, ``EngineConfig.expert_paging``): the
routed experts' ``(layer, expert)`` slabs live in the pool's ``"experts"``
arena (:mod:`repro_torch.serving.expert_paging`) and each decode step runs
on the store's assembled view, in a fixpoint: a step whose routed experts
were not all resident fetches them and runs again on the same cache, which
the step rewrites in place with the same values.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.alloc import DEFAULT_STRIPE_BYTES
from repro_torch.core.objects import (
    DataObject,
    ObjectCatalog,
    ObjectKind,
    _leaves_with_keys,
)
from repro_torch.core.placement import (
    PlacementPolicy,
    diff_plans,
    expert_slab_objects,
)
from repro_torch.core.pool import MemoryPool
from repro_torch.core.sizing import (
    CostModel,
    ModelConfig as SizingModelConfig,
    ObjectProfile,
    RollingProfile,
    advise_expert_residency,
    advise_local_size,
    pool_nodes_needed,
    simulate_profile,
)
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.core.tiering import supports_host_offload
from repro_torch.models import get_model
from repro_torch.serving.expert_paging import (
    ExpertPager,
    ExpertPagingConfig,
    ExpertParamStore,
)


@dataclasses.dataclass
class AutoscaleConfig:
    """Online KV-working-set autoscaler knobs (DESIGN.md §8).

    ``node_capacity_bytes`` is the *planning* capacity of one memory node:
    the advised remote KV bytes (× replication) divided by it gives the
    target pool size. ``compute_us_per_token`` is the deterministic modeled
    decode cost the profile charges per batched token — it sets the
    compute/fetch ratio the degradation prediction is priced against (wall
    clock would make the advice machine-dependent and the tests flaky).
    """

    readvise_every: int = 2        # waves between advisor runs
    degradation_target: float = 0.16  # the paper's knee (§6.1)
    window: int = 8                # waves of profile history
    decay: float = 0.5             # per-wave-age working-set decay
    node_capacity_bytes: int = 8 << 20
    min_nodes: int = 1
    max_nodes: int = 8
    compute_us_per_token: float = 200.0
    sizing_iters: int = 4          # horizon the cost model prices


def kv_wave_profile(
    catalog: ObjectCatalog, frac: float, compute_us: float
) -> tuple[list[tuple[str, Any]], dict[str, ObjectProfile]]:
    """Build one wave of KV fetch/commit traffic for a rolling profile.

    ``frac`` is the wave's live KV occupancy (batch x sequence fill, in
    ``[0, 1]``): each KV-cache object's touched bytes scale with it while
    params are read in full every step. ``compute_us`` is the modeled decode
    compute the wave charges (deterministic, so advice is machine-
    independent). Events mirror the runtime convention — interleaved
    ``fetch``/``compute`` slices, then ``commit`` for written tiers. Shared
    by the single-tenant autoscaler (:meth:`ServingEngine._record_wave`) and
    the multi-tenant scheduler's per-tenant profiles.
    """
    frac = min(max(frac, 0.0), 1.0)
    slice_us = compute_us / max(len(catalog), 1)
    rows: dict[str, ObjectProfile] = {}
    events: list[tuple[str, Any]] = []
    committed: list[str] = []
    for obj in catalog:
        is_cache = obj.kind is ObjectKind.KV_CACHE
        touched = (max(int(obj.size_bytes * frac), 1) if is_cache
                   else obj.size_bytes)
        rows[obj.name] = ObjectProfile(
            name=obj.name,
            size_bytes=touched,
            real_nbytes=touched,
            kind=obj.kind.value,
            n_reads=1,
            n_writes=1 if is_cache else 0,
            lifetime_iters=math.inf,
            n_fetch_events=1,
            n_commit_events=1 if is_cache else 0,
        )
        events.append(("fetch", obj.name))
        events.append(("compute", slice_us))
        if is_cache:
            committed.append(obj.name)
    for name in committed:
        events.append(("commit", name))
    return events, rows


@dataclasses.dataclass
class EngineConfig:
    """Decode-engine knobs: slot pool size, context length, HBM budget,
    and the optional KV-overflow pool / autoscaler configuration."""

    max_batch: int = 8
    max_len: int = 512
    hbm_budget_bytes: int | None = None   # None = no cache tiering pressure
    greedy: bool = True
    # KV-cache overflow target: a multi-node memory pool. 0 = overflow is
    # recorded in the plan only (seed behavior). With autoscaling enabled
    # this is the *initial* pool size (defaults to autoscale.min_nodes).
    pool_nodes: int = 0
    pool_replication: int = 1
    pool_stripe_bytes: int = DEFAULT_STRIPE_BYTES
    autoscale: AutoscaleConfig | None = None
    # MoE expert paging (DESIGN.md §13): page routed-expert weight slabs
    # through the pool's "experts" arena so total expert bytes may exceed
    # hbm_budget_bytes. Requires a MoE model; forces a pool (>= 1 node).
    expert_paging: ExpertPagingConfig | None = None


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bf16 as the same bytes viewed as uint16
    (numpy has no bfloat16; ``convert.tensor_from_numpy`` reads them back)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ServingEngine:
    """Batched greedy-decode server over a tiered param/KV object catalog.

    The engine catalogs parameters and the decode KV cache as DOLMA data
    objects, runs the §4.1 placement policy against ``hbm_budget_bytes``
    (bytes), and serves either synchronous ``generate()`` waves or — via
    ``enable_lane_decode()`` — per-lane continuous batching for the §12
    multi-tenant scheduler. Demoted cache tiers overflow into a striped
    ``MemoryPool``; with ``autoscale=`` set, each wave is profiled and the
    pool is resized online from the sizing advisor (DESIGN.md §8). Decode
    runs on the wall clock (real compute on the params' device,
    microseconds); pool/fabric traffic is charged to the shared simulated
    clock.
    """

    def __init__(self, cfg: ModelConfig, params: Any, engine_cfg: EngineConfig,
                 *, telemetry: Telemetry | None = None):
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg
        # the device the params are on: the cache is made there
        self.device = next(_leaves_with_keys(params))[1].device
        # serving spans run on the wall clock (decode is real device work,
        # not simulated); fabric/pool spans stay on the shared simulated clock
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self._t0_wall = time.perf_counter()
        self.model = get_model(cfg)
        self.cache = self._new_cache()
        self.pool: MemoryPool | None = None
        acfg = engine_cfg.autoscale
        self._pool_target_nodes = engine_cfg.pool_nodes or (
            acfg.min_nodes if acfg is not None else 0
        )
        self.expert_store: ExpertParamStore | None = None
        self.expert_pager: ExpertPager | None = None
        if engine_cfg.expert_paging is not None:
            if cfg.family != "moe":
                raise ValueError(
                    "expert paging requires a routed-MoE model "
                    f"(family 'moe'), got family {cfg.family!r}"
                )
            # the pool is where the slabs live: paging without one is a
            # misconfiguration, so quietly provision the minimum
            self._pool_target_nodes = max(self._pool_target_nodes, 1)
        self._rolling = (
            RollingProfile(window=acfg.window, decay=acfg.decay,
                           source="serving")
            if acfg is not None else None
        )
        self._wave = 0
        self.autoscale_log: list[dict] = []
        # per-step host latencies (us) of the last generate() wave
        self.wave_step_us: list[float] = []
        self.catalog = self._build_catalog()
        self.placement = self._decide_cache_placement()
        self._offload_overflow(initial=True)
        if engine_cfg.expert_paging is not None:
            self.expert_store = ExpertParamStore(
                params, cfg, self.ensure_pool(),
                paging=engine_cfg.expert_paging, telemetry=self.telemetry,
            )
            self.expert_store.ensure_registered()
            self.expert_pager = ExpertPager(
                self.expert_store.n_moe_layers,
                self.expert_store.n_experts,
                decay=engine_cfg.expert_paging.ema_decay,
            )

    def _new_cache(self) -> dict:
        return self.model.init_decode_cache(
            self.cfg, self.ecfg.max_batch, self.ecfg.max_len,
            device=self.device,
        )

    def _step(self, params: Any, cache: dict,
              tok: torch.Tensor) -> tuple[torch.Tensor, dict]:
        return self.model.decode_step(params, cache, tok, self.cfg,
                                      moe_groups=1)

    def _step_routed(self, params: Any, cache: dict, tok: torch.Tensor):
        """The *same* step, asked to also surface the router's top-k
        decision — the signal the expert pager predicts from."""
        return self.model.decode_step(params, cache, tok, self.cfg,
                                      moe_groups=1, return_routing=True)

    # -- DOLMA placement over serving objects -------------------------------
    def _build_catalog(self) -> ObjectCatalog:
        catalog = ObjectCatalog()
        paging = self.ecfg.expert_paging is not None
        for key, leaf in _leaves_with_keys(self.params):
            name = "params" + key
            if paging and name.startswith("params['layers']['moe']['w_"):
                # paged experts are cataloged per (layer, expert) slab
                # below; keeping the stacked leaves too would double-count
                # their bytes against the HBM budget
                continue
            catalog.add(DataObject(
                name=name,
                shape=tuple(leaf.shape), dtype=leaf.dtype,
                kind=ObjectKind.PARAM,
                n_reads=1,  # touched every decode step
            ))
        if paging:
            for obj in expert_slab_objects(self.cfg):
                catalog.add(obj)
        for key, leaf in _leaves_with_keys(self.cache):
            catalog.add(DataObject(
                name="cache" + key,
                shape=tuple(leaf.shape), dtype=leaf.dtype,
                kind=ObjectKind.KV_CACHE,
                n_reads=1, n_writes=1,
            ))
        return catalog

    def _pool_frag_per_node(self) -> float:
        """Measured per-node allocator fragmentation (phantom space)."""
        if self.pool is None:
            return 0.0
        return self.pool.fragmentation_stats()["frag_bytes_per_node"]

    def _decide_cache_placement(self):
        budget = self.ecfg.hbm_budget_bytes or self.catalog.total_bytes
        return PlacementPolicy().plan(
            self.catalog,
            local_budget_bytes=budget,
            n_nodes=max(self._pool_target_nodes, 1),
            stripe_bytes=self.ecfg.pool_stripe_bytes,
        )

    @property
    def offload_memory_kind(self) -> str | None:
        """Memory kind demoted objects would get on this device: on a card
        the plan's remote tiers map to pinned host memory
        (``"pinned_host"``); elsewhere the demotion is recorded in the plan
        (and, with ``pool_nodes``, materialized in the memory pool)."""
        if self.placement.remote_names() and supports_host_offload(
                self.device):
            return "pinned_host"
        return None

    def placement_summary(self) -> dict:
        """Plan summary plus how this device would realize the demotions."""
        summary = dict(self.placement.summary())
        summary["offload_memory_kind"] = self.offload_memory_kind
        return summary

    # -- KV-cache overflow -> memory pool -----------------------------------
    def _cache_leaves(self, names: set[str] | None = None) -> dict[str, np.ndarray]:
        """Host copies of cache leaves (bf16 as uint16 bytes); ``names``
        limits the device->host transfer to the demoted tiers (the resident
        majority stays put)."""
        out = {}
        for key, leaf in _leaves_with_keys(self.cache):
            name = "cache" + key
            if names is None or name in names:
                out[name] = _host_array(leaf)
        return out

    def _demoted_cache_names(self) -> list[str]:
        return [n for n in self.placement.remote_names()
                if n.startswith("cache")]

    def _offload_overflow(self, *, initial: bool = False) -> None:
        """Push demoted KV-cache objects to the multi-node pool.

        First call allocates (striped, optionally replicated, homed per the
        placement plan); later calls write back the current values
        asynchronously — the serving analogue of DOLMA's async demotion.
        """
        if not self._pool_target_nodes:
            return
        demoted = self._demoted_cache_names()
        if not demoted:
            return
        if self.pool is None:
            self.pool = MemoryPool(
                self._pool_target_nodes,
                replication=self.ecfg.pool_replication,
                stripe_bytes=self.ecfg.pool_stripe_bytes,
                telemetry=self.telemetry,
            )
        leaves = self._cache_leaves(set(demoted))
        for name in demoted:
            if name in self.pool:
                self.pool.write(name, leaves[name])  # async overflow write
            else:
                # the engine is one pool tenant: its churn stays in its own
                # allocator arena (per-client slab isolation)
                self.pool.alloc(name, leaves[name],
                                home=self.placement.node_of.get(name),
                                client="serving")
        if not initial:
            self.pool.fence(demoted)

    def reset(self) -> None:
        """Clear the KV cache (fresh request wave).

        Pool copies of demoted cache tiers are freed too: a stale overflow
        entry would otherwise survive the wave boundary and alias the next
        wave's (re-allocated) cache object. Paged expert extents follow the
        same rule: the experts arena is torn down with the wave —
        ``check_no_orphans()`` stays clean across generate→reset→generate —
        and lazily re-registers (cold start) on the next paged step.
        """
        if self.pool is not None:
            for name in self.pool.names():
                if name.startswith("cache"):
                    self.pool.free(name)
        if self.expert_store is not None:
            self.expert_store.teardown()
        self.cache = self._new_cache()

    # -- continuous-batching lane API (DESIGN.md §12) ------------------------
    @property
    def lane_mode(self) -> bool:
        """True once :meth:`enable_lane_decode` switched the cache to
        per-lane decode positions (the continuous-batching step path)."""
        return getattr(self, "_lane_mode", False)

    def enable_lane_decode(self) -> None:
        """Switch the decode cache to per-lane positions (phase-split path).

        After this call every batch lane decodes at its own position: the
        cache's scalar ``pos`` becomes a ``(max_batch,)`` int32 vector on
        the engine's device, and :meth:`decode_lanes` / :meth:`reset_lanes`
        drive the slot pool with requests joining and retiring mid-stream
        (no wave barriers). The engine's own wave-oriented
        ``generate()``/autoscale loop must not be mixed with lane mode — the
        :class:`~repro_torch.serving.scheduler.ContinuousScheduler` owns
        admission and profiling instead. Generic whole-cache pool overflow
        entries are dropped here; per-tenant KV slices
        (:meth:`offload_tenant_kv`) replace them.
        """
        if self.ecfg.autoscale is not None:
            raise ValueError(
                "lane mode and the engine's single-tenant autoscaler are "
                "mutually exclusive; drive admission via ContinuousScheduler"
            )
        if self.expert_store is not None:
            raise ValueError(
                "lane mode and expert paging are mutually exclusive: the "
                "pager's fixpoint step owns the decode path, lane mode "
                "bypasses it"
            )
        if "pos" not in self.cache:
            raise ValueError("lane decode requires a decoder-style cache "
                             "with a 'pos' entry")
        self.cache = dict(self.cache)
        self.cache["pos"] = torch.zeros((self.ecfg.max_batch,),
                                        dtype=torch.int32, device=self.device)
        self._lane_mode = True
        if self.pool is not None:
            for name in self.pool.names():
                if name.startswith("cache"):
                    self.pool.free(name)

    def ensure_pool(self) -> MemoryPool | None:
        """Create the KV-overflow pool at the configured initial size if it
        does not exist yet; returns it (or None when pooling is disabled)."""
        if self.pool is None and self._pool_target_nodes:
            self.pool = MemoryPool(
                self._pool_target_nodes,
                replication=self.ecfg.pool_replication,
                stripe_bytes=self.ecfg.pool_stripe_bytes,
                telemetry=self.telemetry,
            )
        return self.pool

    def lane_positions(self) -> np.ndarray:
        """Per-lane decode positions as a host ``(max_batch,)`` int array."""
        return np.array(self.cache["pos"].cpu()).reshape(-1)

    def decode_lanes(self, tokens: np.ndarray) -> tuple[np.ndarray, float]:
        """One shared batched decode step across all lanes (phase-split).

        ``tokens`` is the per-lane feed, shape ``(max_batch,)``: a prompt
        token for lanes in prefill, the last sampled token for lanes in
        decode, anything for free lanes (their output is discarded — each
        lane's arithmetic is independent of the others). Returns the greedy
        next token per lane and the wall-clock step latency in us (the
        argmax is taken on the device and copied to the host once, so the
        latency includes the device's step).
        """
        if not self.lane_mode:
            raise RuntimeError("call enable_lane_decode() first")
        toks = np.asarray(tokens, np.int32).reshape(self.ecfg.max_batch, 1)
        t0 = time.perf_counter()
        logits, self.cache = self._step(
            self.params, self.cache,
            torch.from_numpy(toks).to(self.device))
        cur = logits[:, :, : self.cfg.vocab_size].argmax(-1).to(torch.int32)
        nxt = cur.cpu().numpy().reshape(-1)
        step_us = (time.perf_counter() - t0) * 1e6
        return nxt, step_us

    def reset_lanes(self, lanes: list[int]) -> None:
        """Zero the given lanes' cache slices and positions, in place.

        Called when a request joins (fresh context) and when it retires
        (drop its KV occupancy); other lanes are untouched, so in-flight
        requests never observe the reset. Every cache leaf holds its lanes
        on axis 1 (``k``, ``v``, ``conv``, ``state``, ``shared_k``,
        ``shared_v``), ``pos`` on axis 0.
        """
        if not self.lane_mode:
            raise RuntimeError("call enable_lane_decode() first")
        if not lanes:
            return
        idx = torch.tensor(sorted(lanes), device=self.device)
        for key, leaf in self.cache.items():
            leaf.index_fill_(0 if key == "pos" else 1, idx, 0)

    def lane_kv_bytes(self, lanes: list[int]) -> int:
        """KV-cache bytes held live by these lanes at their current decode
        positions — the per-tenant occupancy the admission controller sums
        (a lane at position *p* holds ``p / max_len`` of its cache share)."""
        if not lanes:
            return 0
        pos = self.lane_positions()
        total = 0
        for key, leaf in _leaves_with_keys(self.cache):
            if key == "['pos']":
                continue
            per_lane = _nbytes(leaf) // self.ecfg.max_batch
            for lane in lanes:
                frac = min(int(pos[lane]) / self.ecfg.max_len, 1.0)
                total += int(per_lane * frac)
        return total

    def tenant_kv_names(self, tenant: str) -> list[str]:
        """Pool object names holding this tenant's offloaded KV slices."""
        if self.pool is None:
            return []
        prefix = f"kv:{tenant}:"
        return [n for n in self.pool.names() if n.startswith(prefix)]

    def offload_tenant_kv(self, tenant: str, lanes: list[int]) -> None:
        """Write this tenant's demoted KV slices into its own pool arena.

        The serving analogue of DOLMA's async demotion, per tenant: each
        demoted cache tier is sliced to the tenant's lanes (on the device,
        before the copy to the host) and written into the shared pool under
        the tenant's allocator arena (``alloc(client=tenant)`` — slab
        isolation), so arena accounting and shed/retire cleanup are exact
        per tenant. Existing entries of matching size are overwritten in
        place; shape changes (lane count drift) free + re-alloc.
        """
        if not lanes or not self._pool_target_nodes:
            return
        demoted = set(self._demoted_cache_names())
        demoted.discard("cache['pos']")
        if not demoted:
            return
        self.ensure_pool()
        idx = torch.tensor(sorted(lanes), device=self.device)
        for key, leaf in _leaves_with_keys(self.cache):
            name = "cache" + key
            if name not in demoted:
                continue
            data = _host_array(leaf.index_select(1, idx))
            key = f"kv:{tenant}:{name}"
            if key in self.pool and self.pool.nbytes(key) == data.nbytes:
                self.pool.write(key, data)
            else:
                if key in self.pool:
                    self.pool.free(key)
                self.pool.alloc(key, data, client=tenant)

    def free_tenant_kv(self, tenant: str) -> None:
        """Drop every pool entry of this tenant's KV arena (request
        retirement / tenant idle): extents are released back to the slab
        allocator, leaving no orphans (``check_no_orphans()`` stays clean)."""
        for key in self.tenant_kv_names(tenant):
            self.pool.free(key)

    # -- the online autoscaler (DESIGN.md §8) -------------------------------
    def _record_wave(self, batch: int, seq_len: int) -> None:
        """Append one wave's KV traffic to the rolling profile.

        Each cache tier's *touched* bytes scale with the wave's live
        batch/sequence occupancy (the KV working set); params are read in
        full every step. Events mirror the runtime convention: interleaved
        ``fetch``/``compute`` slices, then ``commit`` for written tiers.
        """
        acfg = self.ecfg.autoscale
        assert acfg is not None and self._rolling is not None
        frac = min(seq_len / self.ecfg.max_len, 1.0) * (
            batch / self.ecfg.max_batch
        )
        compute_us = batch * seq_len * acfg.compute_us_per_token
        events, rows = kv_wave_profile(self.catalog, frac, compute_us)
        self._rolling.append_wave(events, rows)
        kv_bytes = sum(p.size_bytes for p in rows.values()
                       if p.kind == ObjectKind.KV_CACHE.value)
        self.telemetry.gauge("serving.kv_occupancy_bytes", kv_bytes)
        self._wave += 1

    def resize_pool(self, target: int) -> dict | None:
        """Grow/shrink the pool toward ``target`` alive nodes in one
        make-before-break migration pass; returns the migration stats
        (extents moved, bytes, simulated time) or None if already sized.
        Used by both the single-tenant autoscaler and the multi-tenant
        scheduler's admission controller."""
        return self._resize_pool(target)

    def _resize_pool(self, target: int) -> dict | None:
        if self.pool is None:
            return None
        alive = sorted(n.node_id for n in self.pool.alive_nodes())
        if target > len(alive):
            return self.pool.add_nodes(target - len(alive))
        if target < len(alive):
            return self.pool.drain_nodes(alive[target:])
        return None

    def _readvise(self) -> dict:
        """Re-run the sizing advisor on the rolling profile and act on it:
        resize the pool to the advised capacity and apply the plan diff."""
        acfg = self.ecfg.autoscale
        assert acfg is not None and self._rolling is not None
        profile = self._rolling.profile()
        n_now = (len(self.pool.alive_nodes()) if self.pool is not None
                 else max(self._pool_target_nodes, 1))
        mcfg = SizingModelConfig(
            n_nodes=max(n_now, 1),
            n_iters=acfg.sizing_iters,
            stripe_bytes=self.ecfg.pool_stripe_bytes,
            replication=self.ecfg.pool_replication,
        )
        advice = advise_local_size(profile, acfg.degradation_target,
                                   config=mcfg)
        catalog = profile.catalog()
        # the profile round-trip drops the pin flag; restore it so the
        # re-advise plans never promote a paged slab (the pool copy is the
        # authoritative one — diff.promote would free it out from under the
        # expert store)
        for obj in catalog:
            if obj.name.startswith("expert:"):
                obj.pinned_remote = True

        # advised budget -> pool capacity: remote KV bytes over *effective*
        # node size — raw capacity minus measured allocator fragmentation,
        # so the autoscaler never scales down onto phantom space (the
        # demoted set depends only on the budget, not the node count)
        prelim = PlacementPolicy().plan(
            catalog, local_budget_bytes=advice.advised_budget_bytes,
            n_nodes=max(n_now, 1),
            stripe_bytes=self.ecfg.pool_stripe_bytes,
        )
        remote_kv = sum(catalog[n].size_bytes for n in prelim.remote_names()
                        if n.startswith("cache"))
        frag_per_node = self._pool_frag_per_node()
        if remote_kv:
            target = pool_nodes_needed(
                remote_kv,
                replication=self.ecfg.pool_replication,
                node_capacity_bytes=acfg.node_capacity_bytes,
                frag_bytes_per_node=frag_per_node,
                min_nodes=acfg.min_nodes,
                max_nodes=acfg.max_nodes,
            )
        else:
            target = acfg.min_nodes

        # diff first and free promoted objects *before* resizing, so the
        # migration never copies extents of entries about to be dropped
        new_plan = PlacementPolicy().plan(
            catalog, local_budget_bytes=advice.advised_budget_bytes,
            n_nodes=target,
            stripe_bytes=self.ecfg.pool_stripe_bytes,
        )
        diff = diff_plans(self.placement, new_plan)
        for name in diff.promote:
            if self.pool is not None and name in self.pool:
                self.pool.free(name)
        migration = self._resize_pool(target)
        self._pool_target_nodes = target
        self.placement = new_plan
        self._offload_overflow()  # newly demoted tiers alloc + write back

        # re-simulate the installed operating point against the oracle —
        # through the real simulator (DolmaRuntime + MemoryPool), not the
        # cost model that chose the budget
        sim_cfg = dataclasses.replace(mcfg, n_nodes=max(target, 1))
        sim_oracle = simulate_profile(profile, local_fraction=1.0,
                                      config=sim_cfg)
        sim_installed = simulate_profile(
            profile, local_budget_bytes=advice.advised_budget_bytes,
            config=sim_cfg,
        )
        resim = sim_installed / sim_oracle - 1.0 if sim_oracle else 0.0
        installed_pred = CostModel(profile).predict(
            local_budget_bytes=advice.advised_budget_bytes, config=sim_cfg,
        ).elapsed_us
        entry = {
            "wave": self._wave,
            "advised_budget_bytes": advice.advised_budget_bytes,
            "advised_fraction": advice.advised_fraction,
            "feasible": advice.feasible,
            "memory_saving": advice.memory_saving,
            "predicted_degradation": advice.degradation,
            "resimulated_degradation": resim,
            # model-vs-simulator agreement at the installed point (§7's
            # MODEL_TOLERANCE contract, observable per re-advise)
            "model_rel_error": (abs(installed_pred - sim_installed)
                                / sim_installed if sim_installed else 0.0),
            "target_nodes": target,
            "remote_kv_bytes": remote_kv,  # planned working-set bytes
            "frag_bytes_per_node": frag_per_node,
            "effective_node_capacity_bytes": (
                acfg.node_capacity_bytes - int(frag_per_node)
            ),
            "n_alive": (len(self.pool.alive_nodes())
                        if self.pool is not None else 0),
            "pool_logical_bytes": (self.pool.total_bytes()
                                   if self.pool is not None else 0),
            "diff": diff.summary(),
            "migration": migration,
        }
        if self.expert_store is not None:
            entry["expert"] = self._readvise_experts()
        self.autoscale_log.append(entry)
        self.telemetry.instant(
            "readvise", track="serving", t_us=self._now_us(),
            wave=entry["wave"], advised_fraction=advice.advised_fraction,
            target_nodes=target, feasible=advice.feasible,
            resimulated_degradation=resim,
        )
        self.telemetry.count("serving.readvise")
        self.telemetry.gauge("serving.target_nodes", target)
        return entry

    def _readvise_experts(self) -> dict:
        """Expert-aware leg of the autoscaler: size the resident set from
        the pager's observed router-mass EMA, exactly as
        :func:`~repro_torch.core.sizing.advise_local_size` sizes the KV
        budget — a hit-rate curve over resident-set size, priced against the
        degradation target, clamped to the HBM budget."""
        store, pager = self.expert_store, self.expert_pager
        acfg = self.ecfg.autoscale
        advice = advise_expert_residency(
            pager.ema,
            bytes_per_expert=store.slab_bytes,
            # measured mean modeled slab transfer; cold engines (no fetch
            # yet) price a nominal 1us so the advisor stays defined
            fetch_us_per_expert=store.mean_fetch_us() or 1.0,
            compute_us_per_step=store.pcfg.compute_us_per_step,
            experts_per_step=store.experts_per_step(),
            degradation_target=acfg.degradation_target,
            hbm_budget_bytes=self.ecfg.hbm_budget_bytes,
        )
        store.pcfg.resident_max = max(int(advice.advised_resident), 1)
        self.telemetry.gauge(
            "serving.expert_resident_max", store.pcfg.resident_max
        )
        return {
            "advice": advice.summary(),
            "resident_max": store.pcfg.resident_max,
            "measured_hit_rate": store.hit_rate(),
            "measured_degradation": store.degradation(),
        }

    # -- decoding ----------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0_wall) * 1e6

    def _decode(self, cache: dict,
                tok: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One batched decode step — paged fixpoint when experts are tiered,
        the plain step otherwise."""
        if self.expert_store is None:
            return self._step(self.params, cache, tok)
        return self._paged_step(cache, tok)

    def _paged_step(self, cache: dict,
                    tok: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Fixpoint decode step over the paged expert view.

        Runs the *identical* step on the assembled view (non-resident
        experts are zero rows). If every routed expert was resident, the
        output is bit-identical to untiered — accept. Otherwise sync-fetch
        the missing experts (misses) and re-run on the same cache (the step
        rewrites the slots it wrote with the values of the exact run): the
        resident set only grows, and the first layer whose inputs were
        already exact routes correctly, so each re-run completes at least
        one more layer — convergence in <= n_moe_layers + 1 runs.
        Eviction/prefetch happen only after the step is accepted, and never
        evict this step's routed experts. The router decision is copied to
        the host once a run: the fixpoint test needs it.
        """
        store, pager = self.expert_store, self.expert_pager
        store.begin_step()
        logits = new_cache = routed = None
        for _ in range(store.n_moe_layers + 2):
            logits, new_cache, routing = self._step_routed(
                store.params_view(), cache, tok
            )
            routing_host = {k: v.cpu().numpy() for k, v in routing.items()}
            routed = pager.routed_sets(routing_host)
            missing = store.missing(routed)
            if not missing:
                break
            for layer, experts in missing:
                store.fetch_sync(layer, experts)
        else:  # pragma: no cover - the bound above is provably sufficient
            raise RuntimeError("expert-paging fixpoint did not converge")
        store.end_step(routed)
        pager.observe(routing_host)
        for layer in range(store.n_moe_layers):
            store.retarget(
                layer,
                pager.predict(layer, store.pcfg.resident_max),
                protect=routed[layer],
            )
        return logits, new_cache

    def _warm_start_experts(self) -> None:
        """Wave-boundary prefetch: the pager's EMA survives ``reset()``
        while residency goes cold, so post the predicted resident set
        *before* the wave's first step. The async transfers overlap each
        other on the pool fabric (one batched window of stall), where the
        cold-start miss path would serialize one blocking fetch per routed
        expert inside the fixpoint loop — and the warmed experts count as
        hits, which is the point of predicting."""
        store, pager = self.expert_store, self.expert_pager
        if pager.observed_steps == 0:
            return  # nothing observed yet: genuinely cold, let misses seed
        store.ensure_registered()
        for layer in range(store.n_moe_layers):
            store.retarget(
                layer,
                pager.predict(layer, store.pcfg.resident_max),
                protect=set(),
            )

    def generate(self, prompts: np.ndarray, max_new: int = 16) -> np.ndarray:
        """Greedy batched generation. prompts: (B, P) int32, B <= max_batch.

        Prefill is performed through the decode path (token-at-a-time); this
        engine is the correctness/latency harness. The new tokens stay on
        the device until the wave ends and are copied to the host once; a
        step's latency (``wave_step_us``) is the host's time to issue it.
        """
        B, P = prompts.shape
        if B > self.ecfg.max_batch:
            raise ValueError(f"{B} prompts > max_batch={self.ecfg.max_batch}")
        if self.expert_store is not None:
            self._warm_start_experts()
        pad = self.ecfg.max_batch - B
        toks = torch.from_numpy(
            np.pad(prompts, ((0, pad), (0, 0))).astype(np.int32)
        ).to(self.device)
        wave_id = self._wave
        t_begin = self._now_us()
        step_us: list[float] = []

        cache = self.cache
        logits = None
        miss0 = self.expert_store.misses if self.expert_store else 0
        for t in range(P):
            t0 = time.perf_counter()
            logits, cache = self._decode(cache, toks[:, t:t + 1])
            step_us.append((time.perf_counter() - t0) * 1e6)
        out = []
        V = self.cfg.vocab_size
        cur = logits[:, :, :V].argmax(-1).to(torch.int32)
        for _ in range(max_new):
            out.append(cur)
            t0 = time.perf_counter()
            logits, cache = self._decode(cache, cur)
            step_us.append((time.perf_counter() - t0) * 1e6)
            cur = logits[:, :, :V].argmax(-1).to(torch.int32)
        self.cache = cache
        self.wave_step_us = step_us
        if self.expert_store is not None:
            store = self.expert_store
            self.telemetry.gauge("serving.expert_hit_rate", store.hit_rate())
            self.telemetry.gauge(
                "serving.expert_resident",
                float(np.mean(store.resident_counts)),
            )
            self.telemetry.gauge(
                "serving.expert_miss_stall_us", store.sim_stall_us
            )
            self.telemetry.count(
                "serving.expert_misses", store.misses - miss0
            )
        if self.telemetry.enabled and step_us:
            p50 = float(np.percentile(step_us, 50))
            p99 = float(np.percentile(step_us, 99))
            self.telemetry.record_span(
                f"wave:{wave_id}", track="serving", begin_us=t_begin,
                end_us=self._now_us(), cat="serve", batch=B, prompt_len=P,
                new_tokens=max_new, p50_step_us=p50, p99_step_us=p99,
            )
            self.telemetry.gauge("serving.p50_step_us", p50)
            self.telemetry.gauge("serving.p99_step_us", p99)
            self.telemetry.count("serving.waves")
            self.telemetry.count("serving.tokens", B * max_new)
        acfg = self.ecfg.autoscale
        if acfg is not None:
            pos = self.cache.get("pos")
            seq_len = (int(pos) if pos is not None and pos.dim() == 0
                       else P + max_new)
            self._record_wave(B, min(seq_len, self.ecfg.max_len))
        if acfg is not None and self._wave % acfg.readvise_every == 0:
            # _readvise installs the new plan and runs the write-back itself
            # — offloading here too would push every demoted tier twice
            self._readvise()
        else:
            self._offload_overflow()  # demoted cache tiers -> pool, async
        return torch.cat(out, dim=1)[:B].cpu().numpy()

    def stats(self) -> dict:
        """Snapshot cache footprint (bytes), placement, pool, expert
        paging (None without it) and autoscale log."""
        return {
            "cache_bytes": sum(
                _nbytes(x) for _, x in _leaves_with_keys(self.cache)
            ),
            "placement": self.placement_summary(),
            "pool": self.pool.stats() if self.pool is not None else None,
            "experts": (self.expert_store.stats()
                        if self.expert_store is not None else None),
            "autoscale": {
                "n_waves": self._wave,
                "n_readvise": len(self.autoscale_log),
                "log": list(self.autoscale_log),
            } if self.ecfg.autoscale is not None else None,
        }
