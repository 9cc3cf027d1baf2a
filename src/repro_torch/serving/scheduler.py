"""Continuous-batching multi-tenant scheduler with cost-model admission.

Multiple named tenants stream requests at one shared :class:`ServingEngine`
slot pool. The scheduler interleaves prefill and decode across tenants into
shared batched steps — a request joins the batch the step after it is
granted a lane and retires on EOS, with no wave barriers (continuous
batching). Each lane's arithmetic is independent of the others (batched
matmuls / per-lane softmax / per-lane cache scatter), so every admitted
request's tokens are bit-identical to running it alone at the same batch
shape.

Admission control is priced by the DOLMA cost model rather than by static
quotas: each tenant carries its own :class:`~repro_torch.core.sizing.
RollingProfile`; on arrival and at every ``readvise_every`` decode steps the
sizing advisor (:func:`~repro_torch.core.sizing.advise_tenants`) prices every
tenant's KV working set against the *per-tenant* degradation SLO, and
:func:`~repro_torch.core.sizing.combined_feasibility` checks whether the shared
elastic pool can hold the sum at effective (fragmentation-adjusted) node
capacity. Tenants that do not fit are shed — they stop receiving lanes
while queued work waits and in-flight requests drain — and are re-admitted
automatically once the fleet working set decays. The pool is resized to the
feasible target (make-before-break migration), and each admitted tenant's
operating point is re-simulated through the real event simulator so the
≤16% knee is verified by machinery independent of the model that chose it.

Per-tenant KV occupancy lives in per-tenant allocator arenas
(``MemoryPool.alloc(client=tenant)``), so arena accounting, shedding, and
retirement cleanup are exact per tenant (``check_no_orphans()`` stays
clean). See DESIGN.md §12.

A copy of ``repro.serving.scheduler`` for this package, numpy as there: the
same arrivals give the reference's lane grants, admission decisions and
node trajectory.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from repro_torch.core.sizing import (
    ModelConfig as SizingModelConfig,
)
from repro_torch.core.sizing import (
    RollingProfile,
    SizingAdvice,
    advise_local_size,
    advise_tenants,
    combined_feasibility,
    simulate_profile,
    tenant_remote_kv_bytes,
)
from repro_torch.serving.engine import ServingEngine, kv_wave_profile


@dataclasses.dataclass
class Request:
    """One generation request from a named tenant.

    ``prompt`` is a 1-D int32 token array; generation is greedy and stops
    after ``max_new`` tokens or when ``eos_token`` is produced (the EOS
    token is included in the output). ``request_id`` and ``submit_step``
    are stamped by the scheduler at :meth:`ContinuousScheduler.submit`.
    """

    tenant: str
    prompt: np.ndarray
    max_new: int = 16
    eos_token: int | None = None
    request_id: str = ""
    submit_step: int = -1


@dataclasses.dataclass
class SchedulerConfig:
    """Admission-controller and batching knobs.

    ``readvise_every`` is in shared decode *steps* (not waves).
    ``node_capacity_bytes`` is the planning capacity of one pool node; the
    feasibility check divides the summed per-tenant advised remote KV bytes
    (× replication) by the *effective* capacity — raw minus measured
    allocator fragmentation. ``compute_us_per_token`` is the deterministic
    modeled decode cost per token charged to tenant profiles (wall clock
    would make admission decisions machine-dependent and tests flaky).
    """

    readvise_every: int = 8
    degradation_target: float = 0.16   # per-tenant SLO: the paper's knee
    window: int = 8                    # admission waves of profile history
    decay: float = 0.5                 # per-wave-age working-set decay
    node_capacity_bytes: int = 8 << 20
    min_nodes: int = 1
    max_nodes: int = 8
    compute_us_per_token: float = 200.0
    sizing_iters: int = 4
    max_lanes_per_tenant: int | None = None  # fairness cap; None = no cap


class RequestQueue:
    """Per-tenant FIFO of pending (not yet lane-granted) requests."""

    def __init__(self) -> None:
        """Create an empty queue set."""
        self._queues: dict[str, collections.deque[Request]] = {}

    def push(self, request: Request) -> None:
        """Append ``request`` to its tenant's FIFO."""
        self._queues.setdefault(request.tenant, collections.deque()).append(
            request
        )

    def pop(self, tenant: str) -> Request | None:
        """Pop the tenant's oldest pending request (None when empty)."""
        q = self._queues.get(tenant)
        return q.popleft() if q else None

    def depth(self, tenant: str) -> int:
        """Pending requests for one tenant."""
        return len(self._queues.get(tenant, ()))

    def total_depth(self) -> int:
        """Pending requests across all tenants."""
        return sum(len(q) for q in self._queues.values())

    def pending(self, tenant: str) -> list[Request]:
        """Snapshot of the tenant's pending requests, oldest first."""
        return list(self._queues.get(tenant, ()))

    def tenants(self) -> list[str]:
        """Sorted tenant names that have ever enqueued (stable order)."""
        return sorted(self._queues)


@dataclasses.dataclass
class TenantState:
    """Live per-tenant scheduler state (profile, lanes, SLO bookkeeping)."""

    name: str
    rolling: RollingProfile
    admitted: bool = True
    lanes: set[int] = dataclasses.field(default_factory=set)
    shed_count: int = 0
    completed: list[dict] = dataclasses.field(default_factory=list)
    step_lat_us: list[float] = dataclasses.field(default_factory=list)
    tokens_out: int = 0
    last_advice: SizingAdvice | None = None
    last_resim: float = 0.0


@dataclasses.dataclass
class _Lane:
    """One occupied batch lane: the request plus its phase cursor."""

    request: Request
    prompt: np.ndarray
    prompt_idx: int = 0
    tokens: list[int] = dataclasses.field(default_factory=list)
    start_step: int = 0
    first_token_step: int | None = None
    start_us: float = 0.0


class ContinuousScheduler:
    """Continuous-batching front end over a lane-mode :class:`ServingEngine`.

    Drive it with :meth:`submit` + :meth:`step` (one shared batched decode
    step per call), or :meth:`drain` to run until every queue is empty.
    Admission passes run on arrival (new or shed tenants) and every
    ``readvise_every`` steps; their decisions are appended to
    :attr:`admission_log`.
    """

    def __init__(self, engine: ServingEngine, scfg: SchedulerConfig) -> None:
        """Bind to ``engine`` (switched into lane mode here) and create the
        shared elastic pool at ``scfg.min_nodes`` if the engine has none."""
        self.engine = engine
        self.scfg = scfg
        self.telemetry = engine.telemetry
        engine.enable_lane_decode()
        engine._pool_target_nodes = max(
            engine._pool_target_nodes, scfg.min_nodes
        )
        engine.ensure_pool()
        self.queue = RequestQueue()
        self.tenants: dict[str, TenantState] = {}
        self.admission_log: list[dict] = []
        self._lanes: dict[int, _Lane] = {}
        self._free_lanes: list[int] = list(range(engine.ecfg.max_batch))
        self._step_id = 0
        self._n_requests = 0
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- request intake -----------------------------------------------------
    def submit(self, request: Request) -> str:
        """Enqueue a request; returns its (stamped) request id.

        Arrival admission: a brand-new tenant starts admitted (its first
        profile waves accrue before the next readvise reprices it); an
        arrival for a currently-shed tenant triggers a full admission pass
        immediately so newly-freed capacity can re-admit it without waiting
        for the interval.
        """
        prompt = np.asarray(request.prompt, np.int32).ravel()
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + request.max_new > self.engine.ecfg.max_len:
            raise ValueError(
                f"prompt+max_new exceeds engine max_len="
                f"{self.engine.ecfg.max_len}"
            )
        self._n_requests += 1
        request = dataclasses.replace(
            request,
            prompt=prompt,
            request_id=request.request_id
            or f"{request.tenant}/{self._n_requests}",
            submit_step=self._step_id,
        )
        is_new = request.tenant not in self.tenants
        if is_new:
            self.tenants[request.tenant] = TenantState(
                name=request.tenant,
                rolling=RollingProfile(
                    window=self.scfg.window, decay=self.scfg.decay,
                    source=f"tenant:{request.tenant}",
                ),
            )
        self.queue.push(request)
        self.telemetry.gauge(
            "sched.queue_depth", self.queue.depth(request.tenant),
            tenant=request.tenant,
        )
        self.telemetry.count("sched.submitted", tenant=request.tenant)
        if not is_new and not self.tenants[request.tenant].admitted:
            self._admission()
        return request.request_id

    # -- lane management ----------------------------------------------------
    def _grant_lanes(self) -> None:
        """Round-robin grant of free lanes to admitted tenants' queues."""
        progressed = True
        while self._free_lanes and progressed:
            progressed = False
            for tenant in self.queue.tenants():
                if not self._free_lanes:
                    break
                ts = self.tenants[tenant]
                if not ts.admitted:
                    continue
                cap = self.scfg.max_lanes_per_tenant
                if cap is not None and len(ts.lanes) >= cap:
                    continue
                req = self.queue.pop(tenant)
                if req is None:
                    continue
                lane = self._free_lanes.pop(0)
                self.engine.reset_lanes([lane])
                self._lanes[lane] = _Lane(
                    request=req, prompt=req.prompt,
                    start_step=self._step_id, start_us=self._now_us(),
                )
                ts.lanes.add(lane)
                progressed = True

    def _retire(self, lane: int) -> None:
        """Retire a finished request: record it, free the lane + tenant KV."""
        st = self._lanes.pop(lane)
        tenant = st.request.tenant
        ts = self.tenants[tenant]
        ts.lanes.discard(lane)
        self.engine.reset_lanes([lane])
        self._free_lanes.append(lane)
        self._free_lanes.sort()
        now = self._now_us()
        ts.completed.append({
            "request_id": st.request.request_id,
            "tenant": tenant,
            "tokens": np.asarray(st.tokens, np.int32),
            "submit_step": st.request.submit_step,
            "start_step": st.start_step,
            "first_token_step": st.first_token_step,
            "done_step": self._step_id,
            "wall_us": now - st.start_us,
        })
        if not ts.lanes:
            # last active request gone: release the tenant's pool arena
            self.engine.free_tenant_kv(tenant)
        self.telemetry.count("sched.completed", tenant=tenant)
        self.telemetry.record_span(
            st.request.request_id, track=f"tenant:{tenant}",
            begin_us=st.start_us, end_us=now, cat="request",
            tokens=len(st.tokens),
            queued_steps=st.start_step - st.request.submit_step,
        )

    # -- the shared batched step --------------------------------------------
    def step(self) -> bool:
        """Run one shared batched decode step across all occupied lanes.

        Grants free lanes first (a request submitted mid-decode joins this
        very step), feeds each lane its next prompt token (prefill) or its
        last sampled token (decode), retires lanes that hit EOS/``max_new``,
        and runs the admission pass every ``readvise_every`` steps. Returns
        False when nothing is active (idle — queues empty or all shed).
        """
        self._grant_lanes()
        if not self._lanes:
            return False
        feed = np.zeros((self.engine.ecfg.max_batch,), np.int32)
        for lane, st in self._lanes.items():
            if st.prompt_idx < len(st.prompt):
                feed[lane] = st.prompt[st.prompt_idx]
            else:
                feed[lane] = st.tokens[-1]
        nxt, step_us = self.engine.decode_lanes(feed)
        self._step_id += 1
        charged: set[str] = set()
        retired: list[int] = []
        for lane, st in self._lanes.items():
            tenant = st.request.tenant
            if tenant not in charged:
                charged.add(tenant)
                self.tenants[tenant].step_lat_us.append(step_us)
            if st.prompt_idx < len(st.prompt) - 1:
                st.prompt_idx += 1   # mid-prefill: output is discarded
                continue
            if st.prompt_idx == len(st.prompt) - 1:
                st.prompt_idx += 1   # last prompt token fed -> first output
            tok = int(nxt[lane])
            st.tokens.append(tok)
            if st.first_token_step is None:
                st.first_token_step = self._step_id
            self.tenants[tenant].tokens_out += 1
            req = st.request
            if (req.eos_token is not None and tok == req.eos_token) or (
                len(st.tokens) >= req.max_new
            ):
                retired.append(lane)
        for lane in retired:
            self._retire(lane)
        if (self.scfg.readvise_every
                and self._step_id % self.scfg.readvise_every == 0):
            self._admission()
        return True

    def drain(self, max_steps: int = 100_000) -> int:
        """Step until every queue is empty and no lane is active.

        When all pending work belongs to shed tenants, an admission pass is
        forced (the fleet working set may have decayed); if they stay shed
        the drain stops with their requests still queued. Returns the number
        of steps run.
        """
        steps = 0
        while steps < max_steps and (
            self._lanes or self.queue.total_depth()
        ):
            if not self.step():
                self._admission()
                if not any(
                    self.tenants[t].admitted and self.queue.depth(t)
                    for t in self.queue.tenants()
                ):
                    break
            else:
                steps += 1
        return steps

    # -- cost-model admission control ---------------------------------------
    def _tenant_demand_fraction(self, ts: TenantState) -> float:
        """Tenant's KV slot-pool demand in [0,1]: live lane occupancy plus
        expected occupancy of its queued requests."""
        ecfg = self.engine.ecfg
        pool_tokens = ecfg.max_batch * ecfg.max_len
        pos = self.engine.lane_positions()
        active = sum(min(int(pos[lane]), ecfg.max_len) for lane in ts.lanes)
        queued = sum(
            min(len(r.prompt) + r.max_new, ecfg.max_len)
            for r in self.queue.pending(ts.name)
        )
        return min((active + queued) / pool_tokens, 1.0)

    def _advise_within_slo(
        self, profile, sim_cfg: SizingModelConfig,
        min_budget_bytes: int = 0,
    ) -> tuple[SizingAdvice, float]:
        """Advise a budget whose *re-simulated* degradation meets the SLO.

        The cost model picks the budget; the real event simulator audits it.
        If the audit exceeds the target (model error), the model target is
        halved and re-advised — budgets are monotone in the target, so this
        converges toward fully-local (zero degradation).
        ``min_budget_bytes`` floors the budget (the capacity clamp: overflow
        the pool cannot hold must stay local, which only lowers degradation).
        """
        slo = self.scfg.degradation_target
        oracle = simulate_profile(profile, local_fraction=1.0, config=sim_cfg)
        target = slo
        advice, resim = None, 0.0
        for _ in range(4):
            advice = advise_local_size(profile, target, config=sim_cfg)
            if advice.advised_budget_bytes < min_budget_bytes:
                advice = dataclasses.replace(
                    advice, advised_budget_bytes=min_budget_bytes
                )
            installed = simulate_profile(
                profile, local_budget_bytes=advice.advised_budget_bytes,
                config=sim_cfg,
            )
            resim = installed / oracle - 1.0 if oracle else 0.0
            if resim <= slo or not advice.feasible:
                break
            target *= 0.5
        return advice, resim

    def _clamp_budget_to_capacity(
        self, profile, advice: SizingAdvice, capacity_bytes: int,
    ) -> int:
        """Smallest budget (≥ the advised one) whose demoted KV working set
        fits ``capacity_bytes`` of pool space — the capacity clamp applied
        when the pool's ``max_nodes`` cannot hold a tenant's advised remote
        set: the overflow stays local instead of being shed forever."""
        budget = max(advice.advised_budget_bytes, 1)
        for _ in range(64):
            rb = tenant_remote_kv_bytes(
                profile,
                dataclasses.replace(advice, advised_budget_bytes=budget),
                n_nodes=max(self.scfg.max_nodes, 1),
                stripe_bytes=self.engine.ecfg.pool_stripe_bytes,
            )
            if rb <= capacity_bytes:
                return budget
            budget = int(budget * 1.25) + 1
        return budget

    def _admission(self) -> dict:
        """One full admission pass: profile → advise → shed → resize → audit.

        1. Append one demand wave per tenant (idle tenants get a zero wave
           so stale working sets decay out and shed tenants can return).
        2. ``advise_tenants`` prices every tenant against the per-tenant SLO.
        3. ``combined_feasibility`` checks the summed advised working sets
           against effective pool capacity; largest-working-set tenants are
           shed until the fleet fits (recomputed from scratch each pass, so
           re-admission is automatic when load drops).
        4. The pool is resized to the feasible target (make-before-break).
        5. Every admitted tenant's operating point is re-simulated through
           the real simulator; budgets are tightened if the audit misses.
        6. Admitted tenants' demoted KV is offloaded to their pool arenas.
        """
        scfg, engine = self.scfg, self.engine
        ecfg = engine.ecfg
        for _tenant, ts in sorted(self.tenants.items()):
            frac = self._tenant_demand_fraction(ts)
            if frac <= 0.0 and ts.rolling.n_waves_seen == 0:
                continue   # never-seen demand: nothing to profile yet
            compute_us = (frac * ecfg.max_batch * ecfg.max_len
                          * scfg.compute_us_per_token)
            events, rows = kv_wave_profile(engine.catalog, frac, compute_us)
            ts.rolling.append_wave(events, rows)
        profiles = {
            t: ts.rolling.profile()
            for t, ts in sorted(self.tenants.items())
            if ts.rolling.n_waves_seen
        }
        n_now = (len(engine.pool.alive_nodes()) if engine.pool is not None
                 else max(engine._pool_target_nodes, scfg.min_nodes))
        mcfg = SizingModelConfig(
            n_nodes=max(n_now, 1),
            n_iters=scfg.sizing_iters,
            stripe_bytes=ecfg.pool_stripe_bytes,
            replication=ecfg.pool_replication,
        )
        advs = advise_tenants(
            profiles, scfg.degradation_target, config=mcfg,
            stripe_bytes=ecfg.pool_stripe_bytes,
        )
        remote = {t: a.remote_kv_bytes for t, a in advs.items()}
        frag = engine._pool_frag_per_node()

        # shed largest working sets until the fleet fits the pool clamp
        admitted = sorted(remote)
        shed_now: list[str] = []
        while True:
            fleet = combined_feasibility(
                {t: remote[t] for t in admitted},
                replication=ecfg.pool_replication,
                node_capacity_bytes=scfg.node_capacity_bytes,
                frag_bytes_per_node=frag,
                min_nodes=scfg.min_nodes,
                max_nodes=scfg.max_nodes,
            )
            if fleet.feasible or len(admitted) <= 1:
                break
            victim = max(admitted, key=lambda t: (remote[t], t))
            admitted.remove(victim)
            shed_now.append(victim)

        # liveness: never let the fleet idle while shed work is queued — if
        # no admitted tenant has work, re-admit the lightest runnable one
        def _has_work(tenant: str) -> bool:
            return bool(self.queue.depth(tenant)
                        or self.tenants[tenant].lanes)

        if shed_now and not any(_has_work(t) for t in admitted):
            runnable = [t for t in shed_now if _has_work(t)]
            if runnable:
                comeback = min(runnable, key=lambda t: (remote[t], t))
                shed_now.remove(comeback)
                admitted.append(comeback)
                admitted.sort()

        # capacity clamp: when even max_nodes cannot hold the admitted
        # working sets, the largest tenants keep their overflow local (a
        # budget floor) instead of deadlocking the fleet on the pool clamp
        min_budgets: dict[str, int] = {}
        pool_cap = (scfg.max_nodes * fleet.effective_node_capacity_bytes
                    ) // max(ecfg.pool_replication, 1)
        for _ in range(len(admitted)):
            if sum(remote[t] for t in admitted) <= pool_cap:
                break
            heavy = max(
                (t for t in admitted if t not in min_budgets),
                key=lambda t: (remote[t], t), default=None,
            )
            if heavy is None:
                break
            avail = max(
                pool_cap - sum(remote[o] for o in admitted if o != heavy), 0
            )
            min_budgets[heavy] = self._clamp_budget_to_capacity(
                profiles[heavy], advs[heavy].advice, avail
            )
            remote[heavy] = tenant_remote_kv_bytes(
                profiles[heavy],
                dataclasses.replace(
                    advs[heavy].advice,
                    advised_budget_bytes=min_budgets[heavy],
                ),
                n_nodes=max(scfg.max_nodes, 1),
                stripe_bytes=ecfg.pool_stripe_bytes,
            )
        if min_budgets or len(admitted) != len(fleet.per_tenant_remote_bytes):
            fleet = combined_feasibility(
                {t: remote[t] for t in admitted},
                replication=ecfg.pool_replication,
                node_capacity_bytes=scfg.node_capacity_bytes,
                frag_bytes_per_node=frag,
                min_nodes=scfg.min_nodes,
                max_nodes=scfg.max_nodes,
            )

        for tenant, ts in self.tenants.items():
            was = ts.admitted
            ts.admitted = tenant in admitted or tenant not in remote
            if was and not ts.admitted:
                ts.shed_count += 1
                self.telemetry.count("sched.shed", tenant=tenant)

        migration = (engine.resize_pool(fleet.target_nodes)
                     if engine.pool is not None else None)
        engine._pool_target_nodes = fleet.target_nodes

        # per-tenant SLO audit at the installed node count
        sim_cfg = dataclasses.replace(
            mcfg, n_nodes=max(fleet.target_nodes, 1)
        )
        for tenant in admitted:
            advice, resim = self._advise_within_slo(
                profiles[tenant], sim_cfg,
                min_budget_bytes=min_budgets.get(tenant, 0),
            )
            ts = self.tenants[tenant]
            ts.last_advice, ts.last_resim = advice, resim
            remote[tenant] = tenant_remote_kv_bytes(
                profiles[tenant], advice,
                n_nodes=fleet.target_nodes,
                stripe_bytes=ecfg.pool_stripe_bytes,
            )
            self.telemetry.gauge("sched.resim_degradation", resim,
                                 tenant=tenant)
            if ts.lanes:
                engine.offload_tenant_kv(tenant, sorted(ts.lanes))

        entry = {
            "step": self._step_id,
            "tenants": {
                tenant: {
                    "admitted": self.tenants[tenant].admitted,
                    "advised_budget_bytes": (
                        advs[tenant].advice.advised_budget_bytes
                        if tenant in advs else None
                    ),
                    "remote_kv_bytes": remote.get(tenant, 0),
                    "resim_degradation": self.tenants[tenant].last_resim,
                    "queue_depth": self.queue.depth(tenant),
                    "active_lanes": len(self.tenants[tenant].lanes),
                }
                for tenant in sorted(self.tenants)
            },
            "shed": shed_now,
            "target_nodes": fleet.target_nodes,
            "required_nodes": fleet.required_nodes,
            "total_remote_bytes": fleet.total_remote_bytes,
            "effective_node_capacity_bytes":
                fleet.effective_node_capacity_bytes,
            "n_alive": (len(engine.pool.alive_nodes())
                        if engine.pool is not None else 0),
            "migration": migration,
        }
        self.admission_log.append(entry)
        for tenant in sorted(self.tenants):
            self.telemetry.gauge("sched.queue_depth",
                                 self.queue.depth(tenant), tenant=tenant)
        self.telemetry.gauge("sched.target_nodes", fleet.target_nodes)
        self.telemetry.count("sched.readvise")
        self.telemetry.instant(
            "admission", track="scheduler", t_us=self._now_us(),
            step=self._step_id, target_nodes=fleet.target_nodes,
            shed=len(shed_now),
        )
        return entry

    def readvise(self) -> dict:
        """Force one admission pass now (outside the step interval).

        Useful after a drain to let idle tenants' working sets decay out of
        the rolling profiles — the pool scales back down and shed tenants
        become admissible again. Returns the admission-log entry.
        """
        return self._admission()

    # -- results & stats ----------------------------------------------------
    def results(self) -> dict[str, list[dict]]:
        """Completed requests per tenant (in completion order)."""
        return {t: list(ts.completed) for t, ts in sorted(self.tenants.items())}

    def latency_stats(self) -> dict[str, dict]:
        """Per-tenant step-latency percentiles (us) over steps where the
        tenant had at least one active lane, plus token/shed counters."""
        out = {}
        for tenant, ts in sorted(self.tenants.items()):
            lat = ts.step_lat_us
            stats = {
                "n_steps": len(lat),
                "p50_step_us": float(np.percentile(lat, 50)) if lat else 0.0,
                "p99_step_us": float(np.percentile(lat, 99)) if lat else 0.0,
                "tokens_out": ts.tokens_out,
                "n_completed": len(ts.completed),
                "shed_count": ts.shed_count,
                "resim_degradation": ts.last_resim,
            }
            out[tenant] = stats
            self.telemetry.gauge("sched.p50_step_us", stats["p50_step_us"],
                                 tenant=tenant)
            self.telemetry.gauge("sched.p99_step_us", stats["p99_step_us"],
                                 tenant=tenant)
        return out
