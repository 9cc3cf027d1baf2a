"""Expert paging: serve MoE models larger than HBM via router-driven prefetch.

A port of ``repro.serving.expert_paging``. DOLMA's thesis is that HPC data
objects with predictable access patterns can live in remote memory behind a
dual-buffer prefetch at <16% degradation. Routed-expert weights are the
serving-side analogue: huge, cold-skewed (top-k of E per token), and
*predictable* — the router's own probabilities say which experts the next
step will touch. This module pages each expert's ``(w_gate, w_up,
w_down)`` slab through the :class:`~repro_torch.core.pool.MemoryPool` (its
own ``client="experts"`` allocator arena) and keeps only a small resident
set real in the assembled view on the device:

* :class:`ExpertParamStore` — owns the pool slabs and the *assembled view*:
  full-shape ``(nL, E, d, ff)`` buffers on the params' device in which
  non-resident experts' rows are zeros, written in place row by row. The
  MoE dispatch is capacity-based scatter/gather, so a zero row is *exact*
  whenever the expert receives no valid token — outputs are bit-identical
  to untiered as long as every **routed** expert is resident, which the
  engine's fixpoint step loop enforces (re-run the identical step after
  sync-fetching any missing expert; the routing of a layer whose inputs
  were already exact is the true routing, so the loop converges in at most
  one pass per MoE layer).

* :class:`ExpertPager` — the predictor: a decayed per-expert EMA of router
  mass, seeded by prefill's top-k histogram, ranks experts; the top
  ``resident_max`` are the *target set*. Predicted-but-absent experts are
  prefetched one step ahead through :class:`~repro_torch.core.exec.
  HostFetchEngine` (on a card the bytes really move, host to device on its
  copy stream, from the store's pinned host copy); a routed-but-absent
  expert falls back to a blocking sync fetch (a *miss*). Eviction is
  LRU-by-router-mass: the resident expert with the least EMA mass that was
  not routed this step leaves first.

Time accounting follows the repo convention (bytes really move on the wall
clock; cost is charged to the shared simulated clock): every slab fetch is
priced by ``MemoryPool.stream_read`` on the pool's fabric. Prefetches issue
at the *end* of the previous step so they overlap the next step's modeled
compute; their residual (arrival after the next step begins) and every sync
miss are stalls. ``degradation = stall_us / compute_us``. The simulated
clock, the hit/miss ledger and the pager are numpy and equal the
reference's.

The assembled view is full-shape, as in the reference, so the paged engine
holds as many device bytes for the routed experts as an untiered one; only
the rows' contents are paged. bf16 slabs go into the pool as their uint16
bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.exec import HostFetchEngine
from repro_torch.core.placement import expert_slab_name
from repro_torch.core.pool import MemoryPool
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry

Params = dict[str, Any]

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class ExpertPagingConfig:
    """Expert-pager knobs (DESIGN.md §13).

    ``resident_max`` is the per-MoE-layer resident-set size in experts
    (may be re-advised online by the engine's autoscaler via
    :func:`repro_torch.core.sizing.advise_expert_residency`).
    ``compute_us_per_step`` is the deterministic modeled decode cost one
    batched step charges — the denominator of the degradation metric, kept
    modeled (not wall clock) so benchmarks and CI are machine-independent.
    ``throttle`` scales the :class:`HostFetchEngine` wall pacing (0 = bytes
    still move, no sleep — the test/CI setting).
    """

    resident_max: int = 4
    ema_decay: float = 0.8
    prefetch: bool = True
    throttle: float = 0.0
    chunk_bytes: int = 1 << 20
    compute_us_per_step: float = 400.0
    timeline: str = "experts"


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t``, pinned when the fetches go to a card (the copy
    stream reads pinned memory asynchronously), made without a pageable
    intermediate."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return out.copy_(t)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as numpy (bf16 as uint16), without a copy."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class ExpertParamStore:
    """Pool-backed store of per-expert weight slabs + the assembled view.

    The authoritative copy of every ``(layer, expert)`` slab lives in the
    shared :class:`MemoryPool` under the ``"experts"`` allocator arena (one
    first-class pool object per expert, named by
    :func:`~repro_torch.core.placement.expert_slab_name`). The fetch source
    is the store's host copy of the stacked expert weights. The device
    holds the assembled view: stacked ``(nL, E, ...)`` buffers whose
    non-resident rows are zeros. ``params_view()`` splices those buffers
    into the original param tree for the decode step.
    """

    def __init__(
        self,
        params: Params,
        cfg,
        pool: MemoryPool,
        *,
        paging: ExpertPagingConfig | None = None,
        telemetry: Telemetry | None = None,
    ) -> None:
        self.cfg = cfg
        self.pool = pool
        self.pcfg = paging or ExpertPagingConfig()
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        moe = params["layers"]["moe"]
        self.device = moe["w_gate"].device
        # host copies are the fetch source (and the pool write source): the
        # stacked device originals can then be dropped by the caller
        pin = self.device.type == "cuda"
        self._host = {k: _host_copy(moe[k], pin) for k in _EXPERT_KEYS}
        self.n_moe_layers, self.n_experts = self._host["w_gate"].shape[:2]
        self.slab_bytes = int(sum(a[0, 0].numel() * a.element_size()
                                  for a in self._host.values()))

        self._base_params = params
        self._wg = torch.zeros_like(moe["w_gate"])
        self._wu = torch.zeros_like(moe["w_up"])
        self._wd = torch.zeros_like(moe["w_down"])
        self.resident: list[set[int]] = [set() for _ in range(self.n_moe_layers)]
        self._step_start_resident: list[set[int]] = [set() for _ in
                                                     range(self.n_moe_layers)]
        # (layer, expert, modeled_completion_us, Future) posted one step ahead
        self._pending: list[tuple[int, int, float, Any]] = []
        self._registered = False
        self._engine = HostFetchEngine(
            throttle=self.pcfg.throttle,
            chunk_bytes=self.pcfg.chunk_bytes,
            telemetry=self.telemetry,
            track="wall/experts",
            device=self.device,
        )

        # simulated-time ledger (degradation = stall / compute)
        self.sim_now = float(pool.clock.now(self.pcfg.timeline))
        self.sim_compute_us = 0.0
        self.sim_stall_us = 0.0
        self.sim_fetch_us = 0.0
        # hit/miss ledger: unique (layer, expert) per accepted step
        self.hits = 0
        self.misses = 0
        self.prefetch_commits = 0
        self.sync_fetches = 0
        self.bytes_fetched = 0
        self.routed_events = 0
        self.steps = 0

    # -- registration / teardown -------------------------------------------
    def ensure_registered(self) -> None:
        """Alloc every expert slab in the pool (idempotent; lazy re-register
        after :meth:`teardown` so a wave boundary can drop the arena)."""
        if self._registered:
            return
        for layer in range(self.n_moe_layers):
            for e in range(self.n_experts):
                self.pool.alloc(expert_slab_name(layer, e),
                                self._slab_host(layer, e),
                                client="experts")
        self._registered = True

    def _slab_host(self, layer: int, e: int) -> np.ndarray:
        return np.concatenate([_as_numpy(self._host[k][layer, e]).ravel()
                               for k in _EXPERT_KEYS])

    def teardown(self) -> None:
        """Free every paged expert extent and drop residency (wave reset).

        The stale-alias rule applied to the experts arena: pool entries
        must not outlive the serving state that owns them —
        ``check_no_orphans()`` stays clean across generate→reset→generate.
        The next wave lazily re-registers and re-warms (cold start).
        """
        self._engine.drain()
        self._pending.clear()
        for layer in range(self.n_moe_layers):
            for e in range(self.n_experts):
                self.pool.free(expert_slab_name(layer, e))
        self.resident = [set() for _ in range(self.n_moe_layers)]
        self._step_start_resident = [set() for _ in range(self.n_moe_layers)]
        for view in (self._wg, self._wu, self._wd):
            view.zero_()
        self._registered = False

    def close(self) -> None:
        """Shut down the fetch engine's worker thread."""
        self._engine.close()

    # -- the assembled view -------------------------------------------------
    def params_view(self) -> Params:
        """The param tree with expert weights replaced by the assembled
        (resident-rows-real, absent-rows-zero) buffers."""
        view = dict(self._base_params)
        layers = dict(view["layers"])
        moe = dict(layers["moe"])
        moe["w_gate"], moe["w_up"], moe["w_down"] = self._wg, self._wu, self._wd
        layers["moe"] = moe
        view["layers"] = layers
        return view

    def _commit_rows(self, layer: int, e: int,
                     dev: dict[str, torch.Tensor]) -> None:
        """One expert's fetched weights into its rows of the view, in
        place, on the current stream (which ``acquire`` made wait for the
        copy)."""
        self._wg[layer, e].copy_(dev["w_gate"])
        self._wu[layer, e].copy_(dev["w_up"])
        self._wd[layer, e].copy_(dev["w_down"])
        self.resident[layer].add(e)

    def _payloads(self, layer: int, e: int) -> dict[str, torch.Tensor]:
        return {k: self._host[k][layer, e] for k in _EXPERT_KEYS}

    # -- step protocol ------------------------------------------------------
    def begin_step(self) -> None:
        """Commit prefetches posted last step; snapshot residency for the
        hit/miss ledger. A prefetch whose modeled completion lands after
        the step boundary stalls the step for the residual (the transfer
        was only partially hidden by the previous step's compute)."""
        self.ensure_registered()
        for layer, e, end_us, fut in self._pending:
            self._commit_rows(layer, e, self._engine.acquire(fut))
            self.prefetch_commits += 1
            if end_us > self.sim_now:
                self.sim_stall_us += end_us - self.sim_now
                self.sim_now = end_us
        self._pending.clear()
        self._step_start_resident = [set(s) for s in self.resident]

    def missing(self, routed: list[set[int]]) -> list[tuple[int, list[int]]]:
        """Per-layer routed experts not yet resident (fixpoint test)."""
        out = []
        for layer, need in enumerate(routed):
            absent = sorted(need - self.resident[layer])
            if absent:
                out.append((layer, absent))
        return out

    def fetch_sync(self, layer: int, experts: list[int]) -> None:
        """Blocking miss path: charge the full modeled transfer as a stall,
        really move the bytes, commit the rows."""
        for e in experts:
            name = expert_slab_name(layer, e)
            end = self.pool.stream_read(
                name, chunk_bytes=self.pcfg.chunk_bytes,
                issue_at=self.sim_now, mode="pipelined",
            )
            dev = self._engine.acquire(
                self._engine.fetch(name, self._payloads(layer, e)))
            self._commit_rows(layer, e, dev)
            self.sim_fetch_us += end - self.sim_now
            self.sim_stall_us += end - self.sim_now
            self.sim_now = end
            self.sync_fetches += 1
            self.bytes_fetched += self.slab_bytes

    def end_step(self, routed: list[set[int]]) -> None:
        """Charge the step's modeled compute and settle the hit ledger.

        A routed expert counts as a *hit* iff it was resident when the step
        began (prefetched or retained) — everything the fixpoint loop had
        to sync-fetch is a miss.
        """
        self.sim_now += self.pcfg.compute_us_per_step
        self.sim_compute_us += self.pcfg.compute_us_per_step
        for layer, need in enumerate(routed):
            start = self._step_start_resident[layer]
            self.hits += len(need & start)
            self.misses += len(need - start)
            self.routed_events += len(need)
        self.steps += 1

    def retarget(self, layer: int, target: list[int],
                 protect: set[int]) -> None:
        """Install the pager's target set: evict residents outside it (LRU
        by router mass — ``target`` arrives mass-ranked, so the evictees
        are exactly the least-mass residents), never evicting an expert
        routed this step; then prefetch predicted-but-absent experts one
        step ahead (issued now = overlapped with the next step's compute).
        """
        keep = set(target[: self.pcfg.resident_max]) | protect
        for e in sorted(self.resident[layer] - keep):
            self._evict(layer, e)
        if not self.pcfg.prefetch:
            return
        for e in target[: self.pcfg.resident_max]:
            if e in self.resident[layer]:
                continue
            name = expert_slab_name(layer, e)
            end = self.pool.stream_read(
                name, chunk_bytes=self.pcfg.chunk_bytes,
                issue_at=self.sim_now, mode="pipelined",
            )
            fut = self._engine.fetch(name, self._payloads(layer, e))
            self._pending.append((layer, e, end, fut))
            self.sim_fetch_us += end - self.sim_now
            self.bytes_fetched += self.slab_bytes

    def _evict(self, layer: int, e: int) -> None:
        for view in (self._wg, self._wu, self._wd):
            view[layer, e].zero_()
        self.resident[layer].discard(e)

    # -- introspection ------------------------------------------------------
    @property
    def resident_counts(self) -> list[int]:
        """Resident experts per MoE layer."""
        return [len(s) for s in self.resident]

    @property
    def copy_bytes(self) -> int:
        """Bytes the fetch engine has really moved to the device."""
        return self._engine.bytes_read

    def hit_rate(self) -> float:
        """Unique-(layer, expert, step) hit rate since construction/reset."""
        total = self.hits + self.misses
        return self.hits / total if total else 1.0

    def degradation(self) -> float:
        """Simulated stall time over simulated compute time (the §6.1 knee
        metric for the paged-expert serving path)."""
        return (self.sim_stall_us / self.sim_compute_us
                if self.sim_compute_us else 0.0)

    def mean_fetch_us(self) -> float:
        """Mean modeled transfer time of one expert slab (sync + prefetch)."""
        n = self.sync_fetches + self.prefetch_commits + len(self._pending)
        return self.sim_fetch_us / n if n else 0.0

    def experts_per_step(self) -> float:
        """Mean unique experts routed per MoE layer per step (the miss-cost
        multiplier :func:`~repro_torch.core.sizing.advise_expert_residency`
        prices)."""
        denom = self.steps * self.n_moe_layers
        return self.routed_events / denom if denom else float(
            min(self.cfg.top_k, self.n_experts))

    def stats(self) -> dict:
        """Counter snapshot for telemetry/benchmarks."""
        return {
            "n_moe_layers": self.n_moe_layers,
            "n_experts": self.n_experts,
            "slab_bytes": self.slab_bytes,
            "resident_max": self.pcfg.resident_max,
            "resident": self.resident_counts,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate(),
            "prefetch_commits": self.prefetch_commits,
            "sync_fetches": self.sync_fetches,
            "bytes_fetched": self.bytes_fetched,
            "sim_compute_us": self.sim_compute_us,
            "sim_stall_us": self.sim_stall_us,
            "degradation": self.degradation(),
            "steps": self.steps,
        }


class ExpertPager:
    """Router-mass predictor + LRU-by-mass ranking (DESIGN.md §13).

    Keeps a decayed per-``(layer, expert)`` EMA of routed probability mass.
    Prefill seeds it (each prefill token's top-k histogram is observed like
    a decode step), decode keeps it fresh; :meth:`predict` ranks experts by
    EMA — the target residency the store installs, which doubles as the
    eviction order (least mass leaves first).
    """

    def __init__(self, n_layers: int, n_experts: int, *,
                 decay: float = 0.8) -> None:
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay!r}")
        self.decay = float(decay)
        self.ema = np.zeros((n_layers, n_experts), np.float64)
        self.observed_steps = 0

    def routed_sets(self, routing: dict[str, Any]) -> list[set[int]]:
        """Unique experts each MoE layer routed this step."""
        top_i = np.asarray(routing["top_i"])
        return [set(np.unique(top_i[layer]).tolist())
                for layer in range(top_i.shape[0])]

    def observe(self, routing: dict[str, Any]) -> None:
        """Fold one step's router decision into the EMA. ``routing`` is the
        decode step's ``{"top_i", "top_p"}`` (layer-stacked host arrays)."""
        top_i = np.asarray(routing["top_i"])
        top_p = np.asarray(routing["top_p"], np.float64)
        n_layers = top_i.shape[0]
        mass = np.zeros_like(self.ema)
        for layer in range(n_layers):
            np.add.at(mass[layer], top_i[layer].ravel(), top_p[layer].ravel())
        self.ema = self.decay * self.ema + (1.0 - self.decay) * mass
        self.observed_steps += 1

    def predict(self, layer: int, n: int) -> list[int]:
        """Top-``n`` experts for this layer by EMA mass (ties: lower id).

        Stable mass-descending order — callers rely on rank order both for
        prefetch priority and for the eviction ranking.
        """
        ema = self.ema[layer]
        order = np.lexsort((np.arange(len(ema)), -ema))
        return [int(e) for e in order[:n]]


__all__ = [
    "ExpertPager",
    "ExpertPagingConfig",
    "ExpertParamStore",
]
