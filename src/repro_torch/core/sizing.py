"""Quantitative local-memory sizing: trace-built cost model + solver.

The paper promises "quantitative analysis to decide a suitable local memory
size"; until this module the reproduction only *consumed* a ``local_fraction``.
Following Wahlgren et al. (arXiv:2308.14780) — a cost model over access
profiles answering "how much local memory is enough" — this module closes the
loop in three parts:

* :class:`WorkloadProfile` — what one instrumented warmup run exports
  (``DolmaRuntime(record_profile=True).profile()``): the per-object census the
  placement policy ranks by, plus the per-step event stream (fetch / commit /
  compute charges, in order) the runtime observed.

* :class:`CostModel` — predicts ``elapsed_us(local_fraction, fabric, n_nodes,
  window)`` *without re-simulating*: no workload execution, no data movement.
  It replays the recorded event stream through the fabric's closed-form cost
  equations (:meth:`FabricModel.stream_us` via real :class:`FabricResource`
  occupancy), mirroring the runtime's demand / dual-buffer / trace-pipeline
  control flow — O(events) float arithmetic per prediction, ~10^3x cheaper
  than driving the numpy workload through the simulator.

* :func:`advise_local_size` — walks the placement policy's demotion order,
  prices every (demotion prefix x cache headroom) budget with the cost model,
  and returns the smallest local budget whose predicted degradation vs the
  untiered oracle meets the target (default 16%, the paper's knee: <=16%
  slowdown at up to 63% memory saving), with per-object marginal-cost
  attribution ("demoting ``lhs_halo`` next costs 3.1%").

The advised budget is monotone in the target by construction: a tighter
target shrinks the feasible set, so its minimum can only grow.

A copy of ``repro.core.sizing`` for this package, numpy as there.
"""
from __future__ import annotations

import dataclasses
import json
import zlib
from typing import Any

import numpy as np

from repro_torch.core.alloc import DEFAULT_STRIPE_BYTES
from repro_torch.core.fabric import FabricModel, FabricResource, INFINIBAND_100G
from repro_torch.core.objects import (
    DataObject,
    ObjectCatalog,
    ObjectKind,
    itemsize,
)
from repro_torch.core.placement import PlacementPlan, PlacementPolicy, demotion_order

DEFAULT_DEGRADATION_TARGET = 0.16  # the paper's headline knee (§6.1)
# model-vs-simulator agreement contract (asserted by tests/test_sizing.py and
# benchmarks/fig_sizing.py): predictions within this relative error
MODEL_TOLERANCE = 0.15

_EventList = list[tuple[str, Any]]  # ("fetch", name) | ("commit", name) | ("compute", us)


# ---------------------------------------------------------------------------
# the profile: what one instrumented warmup run exports
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ObjectProfile:
    """Census row for one data object, as the runtime's recorder saw it."""

    name: str
    size_bytes: int          # modeled (sim-scaled) size — what placement ranks
    real_nbytes: int         # physical array size — what pool striping splits
    kind: str = ObjectKind.INPUT.value
    n_reads: int = 0         # declared reads/iter (placement rule 2 input)
    n_writes: int = 0
    lifetime_iters: float = float("inf")
    pinned_local: bool = False
    n_fetch_events: int = 0  # observed fetch() calls across the recorded run
    n_commit_events: int = 0
    reuse_distance: int | None = None

    def to_data_object(self) -> DataObject:
        """Lower this profile entry to a placement-policy ``DataObject``.

        Shape is the flat real byte count; ``sim_bytes`` carries the
        (possibly scaled) bytes the simulator charges per transfer.
        """
        return DataObject(
            name=self.name,
            shape=(self.real_nbytes,),
            dtype=np.uint8,
            kind=ObjectKind(self.kind),
            n_reads=self.n_reads,
            n_writes=self.n_writes,
            lifetime_iters=self.lifetime_iters,
            pinned_local=self.pinned_local,
            sim_bytes=self.size_bytes,
        )


@dataclasses.dataclass
class WorkloadProfile:
    """One instrumented run: object census + per-step access/compute events.

    ``steps[i]`` is step *i*'s ordered event list; every event is one of
    ``("fetch", name)``, ``("commit", name)``, ``("compute", us)``. The
    stream is placement-independent (workload bodies fetch/commit/charge the
    same way at every local fraction — tests assert bit-identical results),
    which is what lets one oracle-run profile price *every* candidate budget.
    """

    objects: dict[str, ObjectProfile]
    steps: list[_EventList]
    sim_scale: float = 1.0
    compute_gflops: float = 0.0
    fabric_name: str = ""
    recorded_fraction: float = 1.0
    source: str = ""

    def catalog(self) -> ObjectCatalog:
        """Byte census of the recorded objects, ready for placement."""
        return ObjectCatalog(o.to_data_object() for o in self.objects.values())

    @property
    def peak_bytes(self) -> int:
        """Sum of all recorded object sizes (simulated bytes)."""
        return sum(o.size_bytes for o in self.objects.values())

    def compute_us_per_step(self) -> float:
        """Total compute charged in the (steady-state) last recorded step."""
        if not self.steps:
            return 0.0
        return sum(v for op, v in self.steps[-1] if op == "compute")

    # -- (de)serialization for benchmark artifacts --------------------------
    def to_json(self) -> dict[str, Any]:
        """Serialize to a plain dict (benchmark artifact round-trip)."""
        return {
            "objects": {n: dataclasses.asdict(o) for n, o in self.objects.items()},
            "steps": [[list(e) for e in step] for step in self.steps],
            "sim_scale": self.sim_scale,
            "compute_gflops": self.compute_gflops,
            "fabric_name": self.fabric_name,
            "recorded_fraction": self.recorded_fraction,
            "source": self.source,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any] | str) -> "WorkloadProfile":
        """Inverse of :meth:`to_json`; accepts a dict or a JSON string."""
        if isinstance(d, str):
            d = json.loads(d)
        return cls(
            objects={n: ObjectProfile(**o) for n, o in d["objects"].items()},
            steps=[[(e[0], e[1]) for e in step] for step in d["steps"]],
            sim_scale=d.get("sim_scale", 1.0),
            compute_gflops=d.get("compute_gflops", 0.0),
            fabric_name=d.get("fabric_name", ""),
            recorded_fraction=d.get("recorded_fraction", 1.0),
            source=d.get("source", ""),
        )


class RollingProfile:
    """Incremental :class:`WorkloadProfile` accumulator with windowed decay.

    The serving autoscaler appends one wave of KV fetch/commit traffic per
    ``generate()`` call and periodically re-runs :func:`advise_local_size`
    on the exported profile. Two mechanisms keep the advice tracking the
    *live* working set (Wahlgren et al.: disaggregation decisions must
    follow the working set, not the peak):

    * **window** — only the last ``window`` waves contribute event steps, so
      a long-dead access pattern stops shaping the prediction;
    * **decay** — each object's size estimate is the *decayed max* of its
      per-wave touched bytes, ``max_w(touched_w · decay^age_w)`` (age 0 =
      newest). A long-context burst keeps the estimate high for a few waves
      (hysteresis against thrash), then ages out and the advised budget —
      and with it the pool capacity — shrinks back.
    """

    def __init__(self, *, window: int = 8, decay: float = 0.5,
                 source: str = "rolling") -> None:
        if window < 1:
            raise ValueError("window must be >= 1")
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        self.window = window
        self.decay = decay
        self.source = source
        self._waves: list[tuple[_EventList, dict[str, ObjectProfile]]] = []
        self.n_waves_seen = 0

    def __len__(self) -> int:
        return len(self._waves)

    def append_wave(self, events: _EventList,
                    objects: dict[str, ObjectProfile]) -> None:
        """Append one wave: its ordered event list + touched-bytes census."""
        for op, _val in events:
            if op not in ("fetch", "commit", "compute"):
                raise ValueError(f"unknown profile event {op!r}")
        self._waves.append((
            [tuple(e) for e in events],
            {n: dataclasses.replace(o) for n, o in objects.items()},
        ))
        del self._waves[:-self.window]
        self.n_waves_seen += 1

    def profile(self) -> WorkloadProfile:
        """Export the windowed profile (decayed-max census + event steps)."""
        merged: dict[str, ObjectProfile] = {}
        n = len(self._waves)
        for idx, (_events, rows) in enumerate(self._waves):  # oldest first
            weight = self.decay ** (n - 1 - idx)
            for name, row in rows.items():
                est = max(int(row.size_bytes * weight), 1)
                cur = merged.get(name)
                if cur is None:
                    merged[name] = dataclasses.replace(
                        row, size_bytes=est, real_nbytes=est)
                else:
                    cur.size_bytes = max(cur.size_bytes, est)
                    cur.real_nbytes = cur.size_bytes
                    # access *rates* follow the newest wave; event counters
                    # accumulate over the window
                    cur.n_reads = row.n_reads
                    cur.n_writes = row.n_writes
                    cur.kind = row.kind
                    cur.pinned_local = row.pinned_local
                    cur.n_fetch_events += row.n_fetch_events
                    cur.n_commit_events += row.n_commit_events
        return WorkloadProfile(
            objects=merged,
            steps=[list(ev) for ev, _rows in self._waves],
            source=self.source,
        )


def synthetic_profile(
    catalog: ObjectCatalog,
    *,
    compute_us_per_step: float,
    n_steps: int = 2,
    source: str = "synthetic",
) -> WorkloadProfile:
    """Build a profile from a catalog and an assumed access pattern.

    For consumers without a ``DolmaRuntime`` recording (e.g. the compiled-
    graph tiering path sizing HBM for a train step): every object is fetched
    once per step in catalog order with the compute spread evenly between
    fetches, and written-to objects are committed at step end. Coarser than
    a recorded trace, but enough for the solver to price demotion prefixes.
    """
    objects = {
        o.name: ObjectProfile(
            name=o.name,
            size_bytes=o.size_bytes,
            real_nbytes=max(
                int(np.prod(o.shape, dtype=np.int64))
                * itemsize(o.dtype),
                1,
            ),
            kind=o.kind.value,
            n_reads=o.n_reads,
            n_writes=o.n_writes,
            lifetime_iters=o.lifetime_iters,
            pinned_local=o.pinned_local,
            n_fetch_events=1,
            n_commit_events=1 if o.n_writes else 0,
        )
        for o in catalog
    }
    names = [o.name for o in catalog]
    slice_us = compute_us_per_step / max(len(names), 1)
    events: _EventList = []
    for name in names:
        events.append(("fetch", name))
        events.append(("compute", slice_us))
    for o in catalog:
        if o.n_writes:
            events.append(("commit", o.name))
    return WorkloadProfile(
        objects=objects,
        steps=[list(events) for _ in range(max(n_steps, 1))],
        source=source,
    )


# ---------------------------------------------------------------------------
# store replays: fabric-time accounting with the runtime's routing, no data
# ---------------------------------------------------------------------------
class _StoreReplay:
    """Single remote node: QPs + per-object pending-write ordering (RAW)."""

    def __init__(self, fabric: FabricModel, n_resources: int = 1) -> None:
        self.fabric = fabric
        self.resources = [FabricResource(None, fabric) for _ in range(n_resources)]
        self.pending: dict[str, float] = {}

    def _least_loaded(self) -> FabricResource:
        return min(self.resources, key=lambda r: (r.free_at, r.name))

    def stream_read(self, name: str, nbytes: int, chunk_bytes: int,
                    issue_at: float, mode: str) -> float:
        t = max(issue_at, self.pending.get(name, 0.0))
        _s, end = self._least_loaded().issue_stream(
            "read", nbytes, chunk_bytes, t, pipelined=mode)
        return end

    def stream_read_batch(self, requests: list[tuple[str, int]],
                          chunk_bytes: int, issue_at: float,
                          mode: str) -> dict[str, float]:
        if not requests:
            return {}
        t0 = max([issue_at] + [self.pending.get(n, 0.0) for n, _ in requests])
        _s, completions, _end = self._least_loaded().issue_batch(
            "read", [int(nb) for _, nb in requests], chunk_bytes, t0, mode=mode)
        return {name: done for (name, _), done in zip(requests, completions)}

    def stream_write(self, name: str, charge_bytes: int, chunk_bytes: int,
                     issue_at: float, mode: str) -> float:
        _s, end = self._least_loaded().issue_stream(
            "write", charge_bytes, chunk_bytes, issue_at, pipelined=mode)
        self.pending[name] = max(self.pending.get(name, 0.0), end)
        return end

    def fence_time(self) -> float:
        return max(self.pending.values(), default=0.0)


@dataclasses.dataclass
class _ReplayExtent:
    nbytes: int
    replicas: list[int]


class _PoolReplay(_StoreReplay):
    """Multi-node pool: striping + replica routing by projected QP cost,
    mirroring :class:`repro_torch.core.pool.MemoryPool`'s stream paths."""

    def __init__(self, fabric: FabricModel, n_nodes: int, *,
                 stripe_bytes: int = DEFAULT_STRIPE_BYTES, replication: int = 1,
                 qps_per_node: int = 1) -> None:
        self.fabric = fabric
        self.n_nodes = n_nodes
        self.stripe_bytes = stripe_bytes
        self.replication = min(max(replication, 1), n_nodes)
        self.node_resources = [
            [FabricResource(None, fabric) for _ in range(qps_per_node)]
            for _ in range(n_nodes)
        ]
        self.pending: dict[str, float] = {}
        self.extents: dict[str, list[_ReplayExtent]] = {}
        self.real_nbytes: dict[str, int] = {}

    def alloc(self, name: str, real_nbytes: int, home: int | None) -> None:
        h = home if home is not None else zlib.crc32(name.encode()) % self.n_nodes
        exts: list[_ReplayExtent] = []
        for idx, off in enumerate(
            range(0, max(real_nbytes, 1), self.stripe_bytes)
        ):
            nbytes = min(self.stripe_bytes, real_nbytes - off) or 1
            start = (h + idx) % self.n_nodes
            exts.append(_ReplayExtent(
                nbytes=nbytes,
                replicas=[(start + r) % self.n_nodes
                          for r in range(self.replication)],
            ))
            if real_nbytes == 0:
                break
        self.extents[name] = exts
        self.real_nbytes[name] = max(real_nbytes, 1)

    def _node_least_loaded(self, nid: int) -> FabricResource:
        return min(self.node_resources[nid], key=lambda r: (r.free_at, r.name))

    def _projected_cost(self) -> dict[int, float]:
        return {nid: self._node_least_loaded(nid).free_at
                for nid in range(self.n_nodes)}

    def _node_shares(self, name: str,
                     cost: dict[int, float] | None = None) -> dict[int, int]:
        line_bpus = (self.fabric.read_line_gbps or self.fabric.read_gbps) * 1e3
        if cost is None:
            cost = self._projected_cost()
        shares: dict[int, int] = {}
        for ext in self.extents[name]:
            nid = min(ext.replicas, key=lambda i: (cost[i], i))
            shares[nid] = shares.get(nid, 0) + ext.nbytes
            cost[nid] += ext.nbytes / line_bpus
        return shares

    def stream_read(self, name: str, nbytes: int, chunk_bytes: int,
                    issue_at: float, mode: str) -> float:
        if nbytes <= 0:
            return issue_at
        shares = self._node_shares(name)
        total = sum(shares.values()) or 1
        t0 = max(issue_at, self.pending.get(name, 0.0))
        end = t0
        for nid in sorted(shares):
            node_bytes = nbytes * shares[nid] // total
            if node_bytes <= 0:
                continue
            _s, node_end = self._node_least_loaded(nid).issue_stream(
                "read", node_bytes, chunk_bytes, t0, pipelined=mode)
            end = max(end, node_end)
        return end

    def stream_read_batch(self, requests: list[tuple[str, int]],
                          chunk_bytes: int, issue_at: float,
                          mode: str) -> dict[str, float]:
        if not requests:
            return {}
        cost = self._projected_cost()
        t0 = issue_at
        per_node: dict[int, list[tuple[int, int]]] = {}
        for i, (name, nbytes) in enumerate(requests):
            t0 = max(t0, self.pending.get(name, 0.0))
            if nbytes <= 0:
                continue
            shares = self._node_shares(name, cost)
            total_real = sum(shares.values()) or 1
            for nid in sorted(shares):
                node_bytes = int(nbytes) * shares[nid] // total_real
                if node_bytes > 0:
                    per_node.setdefault(nid, []).append((i, node_bytes))
        out = {name: t0 for name, _ in requests}
        for nid in sorted(per_node):
            entries = per_node[nid]
            _s, completions, _end = self._node_least_loaded(nid).issue_batch(
                "read", [nb for _, nb in entries], chunk_bytes, t0, mode=mode)
            for (i, _), done in zip(entries, completions):
                name = requests[i][0]
                out[name] = max(out[name], done)
        return out

    def stream_write(self, name: str, charge_bytes: int, chunk_bytes: int,
                     issue_at: float, mode: str) -> float:
        real = self.real_nbytes[name]
        per_node: dict[int, int] = {}
        for ext in self.extents[name]:
            for nid in ext.replicas:
                per_node[nid] = per_node.get(nid, 0) + ext.nbytes
        end = issue_at
        for nid in sorted(per_node):
            node_charge = max(charge_bytes * per_node[nid] // real, 1)
            _s, node_end = self._node_least_loaded(nid).issue_stream(
                "write", node_charge, chunk_bytes, issue_at, pipelined=mode)
            end = max(end, node_end)
        self.pending[name] = max(self.pending.get(name, 0.0), end)
        return end


# ---------------------------------------------------------------------------
# the cost model: replay the event stream against a candidate placement
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Prediction:
    """One cost-model evaluation of a candidate budget."""

    elapsed_us: float
    plan: PlacementPlan
    mode: str
    n_iters: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Runtime/fabric configuration a prediction is evaluated under."""

    fabric: FabricModel = INFINIBAND_100G
    n_nodes: int = 1
    window: int = 4
    mode: str = "pipeline"          # "pipeline" | "legacy" | "serial"
    n_iters: int = 10
    stripe_bytes: int = DEFAULT_STRIPE_BYTES
    replication: int = 1
    qps_per_node: int = 1
    # plan-level per-node capacity (sim-scaled units, replicas covered), as
    # DolmaRuntime.finalize derives it — keeps the priced plan identical to
    # the installed one on capacity-constrained pools. The physical
    # MemoryError fallback at alloc time stays unmodeled (finalize already
    # calls per-home accounting approximate).
    node_capacity_bytes: int | None = None


class CostModel:
    """Analytical elapsed-time model fitted from one instrumented run.

    ``predict`` replays the profile's event stream against a candidate
    placement using the same fabric occupancy math the simulator charges
    (:class:`FabricResource`), but touches no data and runs no workload —
    each prediction is O(n_iters x events) float operations.
    """

    def __init__(self, profile: WorkloadProfile, *,
                 policy: PlacementPolicy | None = None) -> None:
        self.profile = profile
        self.policy = policy or PlacementPolicy()
        self._catalog = profile.catalog()

    @property
    def catalog(self) -> ObjectCatalog:
        """The profile's object census used for candidate placements."""
        return self._catalog

    def predict_untiered(self, *, n_iters: int = 10) -> float:
        """The oracle: every object local — pure recorded compute time."""
        steps = self.profile.steps
        if not steps:
            return 0.0
        total = 0.0
        for it in range(n_iters):
            events = steps[min(it, len(steps) - 1)]
            total += sum(v for op, v in events if op == "compute")
        return total

    def predict(
        self,
        *,
        local_fraction: float | None = None,
        local_budget_bytes: int | None = None,
        config: ModelConfig | None = None,
        **config_kwargs: Any,
    ) -> Prediction:
        """Predicted elapsed_us for one candidate budget under ``config``."""
        cfg = config or ModelConfig(**config_kwargs)
        plan = self.policy.plan(
            self._catalog,
            local_fraction=local_fraction,
            local_budget_bytes=local_budget_bytes,
            n_nodes=cfg.n_nodes,
            node_capacity_bytes=cfg.node_capacity_bytes,
        )
        elapsed = _replay(self.profile, plan, cfg)
        return Prediction(elapsed_us=elapsed, plan=plan, mode=cfg.mode,
                          n_iters=cfg.n_iters)


def _replay(profile: WorkloadProfile, plan: PlacementPlan,
            cfg: ModelConfig) -> float:
    """Replay the recorded event stream against ``plan``; return elapsed_us.

    Mirrors :class:`repro_torch.core.dual_buffer.DolmaRuntime`'s control flow —
    demand fetch, legacy cross-iteration dual buffer, or the trace-driven
    pipeline (sliding window, Belady-from-trace eviction, batched reads,
    streaming-tail overlap absorbed by the next compute charge) — with all
    data movement elided.
    """
    objects = profile.objects
    remote = [n for n in plan.remote_names() if n in objects]
    remote_set = set(remote)
    size = {n: objects[n].size_bytes for n in remote}

    # regions, as DolmaRuntime.finalize() lays them out
    local_bytes = sum(o.size_bytes for n, o in objects.items()
                      if n not in remote_set)
    metadata_region = max(4096, 64 * len(objects))
    cache_region = max(plan.budget_bytes - local_bytes - metadata_region, 4096)

    pipeline = cfg.mode == "pipeline"
    dual_buffer = cfg.mode != "serial"
    if pipeline:
        chunk_region = cache_region
    elif dual_buffer:
        chunk_region = cache_region // 2
    else:
        chunk_region = cache_region
    chunk = max(min(chunk_region, cfg.fabric.max_op_bytes), 4096)
    pipe_chunk = max(chunk // 8, 4096)

    if cfg.n_nodes > 1:
        store: _StoreReplay = _PoolReplay(
            cfg.fabric, cfg.n_nodes, stripe_bytes=cfg.stripe_bytes,
            replication=cfg.replication, qps_per_node=cfg.qps_per_node)
        for n in remote:
            store.alloc(n, objects[n].real_nbytes, plan.node_of.get(n))
    else:
        store = _StoreReplay(cfg.fabric, n_resources=cfg.qps_per_node)

    resident = {n: 0 for n in remote}
    share: dict[str, int] = {}
    if not pipeline:
        total_remote = sum(size.values()) or 1
        usable = cache_region // 2 if dual_buffer else cache_region
        for n in remote:
            share[n] = min(usable * size[n] // total_remote, size[n])

    t = 0.0
    prefetched: dict[str, tuple[float, int]] = {}
    inflight: dict[str, tuple[float, int]] = {}
    prediction: list[str] = []
    pred_index: dict[str, int] = {}
    state = {"trace_pos": 0, "debt": 0.0, "fetches_done_at": 0.0}
    fetch_done: dict[str, float] = {}

    def next_use(name: str) -> int:
        n_pred = len(prediction)
        i = pred_index.get(name)
        if i is None or n_pred == 0:
            return n_pred + 1
        return (i - state["trace_pos"]) % n_pred

    def cache_used() -> int:
        return (sum(resident.values())
                + sum(cov for _d, cov in inflight.values()))

    def evict_for(need: int, *, nu: int, protect: set[str]) -> int:
        free = cache_region - cache_used()
        if free >= need:
            return need
        victims = sorted(
            (n for n, b in resident.items()
             if b > 0 and n not in protect and next_use(n) > nu),
            key=lambda n: (-next_use(n), n),
        )
        for victim in victims:
            if free >= need:
                break
            free += resident[victim]
            resident[victim] = 0
        return max(min(free, need), 0)

    def pump(at: float) -> None:
        n_pred = len(prediction)
        if n_pred == 0:
            return
        window: list[tuple[str, int]] = []
        for off in range(min(cfg.window, n_pred)):
            cand = prediction[(state["trace_pos"] + off) % n_pred]
            if cand not in inflight:
                window.append((cand, off))
        protect = set(inflight) | set(pred_index)
        requests: list[tuple[str, int]] = []
        for cand, off in window:
            need = size[cand] - resident.get(cand, 0)
            if need <= 0:
                continue
            grant = evict_for(need, nu=off, protect=protect)
            if grant <= 0:
                break
            requests.append((cand, grant))
            inflight[cand] = (at, grant)
        if not requests:
            return
        done = store.stream_read_batch(requests, pipe_chunk, at, "pipelined")
        for cand, covered in requests:
            inflight[cand] = (done[cand], covered)

    def fetch_pipelined(name: str) -> None:
        nonlocal t
        sz = size[name]
        predicted = name in pred_index
        if name in inflight:
            done, covered = inflight.pop(name)
            t = max(t, done)
            resident[name] = min(resident.get(name, 0) + covered, sz)
        if predicted:
            state["trace_pos"] = max(state["trace_pos"], pred_index[name] + 1)
            pump(t)
        remainder = sz - resident.get(name, 0)
        if remainder > 0:
            grant = evict_for(
                remainder, nu=next_use(name) if predicted else 0,
                protect={name} | set(inflight),
            )
            now = t
            if predicted:
                end = store.stream_read(name, remainder, pipe_chunk,
                                        now, "pipelined")
                t = max(t, now + cfg.fabric.read_base_us)
                state["debt"] = max(state["debt"], end)
            else:
                end = store.stream_read(name, remainder, chunk,
                                        now, "windowed")
                t = max(t, end)
            resident[name] = min(resident.get(name, 0) + grant, sz)
        state["fetches_done_at"] = t
        fetch_done[name] = t

    def fetch_legacy(name: str) -> None:
        nonlocal t
        sz = size[name] - resident.get(name, 0)
        covered = 0
        if name in prefetched:
            done, covered = prefetched.pop(name)
            t = max(t, done)
        remainder = max(sz - covered, 0)
        if remainder > 0:
            mode = "windowed" if dual_buffer else "serial"
            end = store.stream_read(name, remainder, chunk, t, mode)
            t = max(t, end)
        resident[name] = share.get(name, 0)
        state["fetches_done_at"] = t
        fetch_done[name] = t

    def issue_chunked_read(name: str, at: float) -> tuple[float, int]:
        sz = size[name] - resident.get(name, 0)
        covered = min(sz, chunk)
        if covered <= 0:
            return at, 0
        end = store.stream_read(name, covered, max(covered // 8, 4096),
                                at, "pipelined")
        return end, covered

    steps = profile.steps or [[]]
    for it in range(cfg.n_iters):
        events = steps[min(it, len(steps) - 1)]
        read_set: set[str] = set()
        fetch_done.clear()
        state["fetches_done_at"] = t
        fetched_remote: list[str] = []
        for op, val in events:
            if op == "compute":
                t += val
                if state["debt"] > 0.0:
                    t = max(t, state["debt"])
                    state["debt"] = 0.0
            elif op == "fetch":
                read_set.add(val)
                if val not in remote_set:
                    continue
                fetched_remote.append(val)
                if pipeline:
                    fetch_pipelined(val)
                else:
                    fetch_legacy(val)
            elif op == "commit":
                if val not in remote_set:
                    continue
                store.stream_write(val, size[val], chunk, t, "pipelined")
                if not pipeline:
                    resident[val] = share.get(val, 0)
        if pipeline:
            if state["debt"] > 0.0:
                t = max(t, state["debt"])
                state["debt"] = 0.0
            new_pred = list(dict.fromkeys(fetched_remote))
            if new_pred:
                prediction[:] = new_pred
                pred_index.clear()
                pred_index.update({n: i for i, n in enumerate(new_pred)})
                for stale in [n for n in inflight if n not in pred_index]:
                    del inflight[stale]
            state["trace_pos"] = 0
            pump(state["fetches_done_at"])
        elif dual_buffer:
            for name in sorted(read_set):
                if name in remote_set:
                    prefetched[name] = issue_chunked_read(
                        name, fetch_done.get(name, state["fetches_done_at"]))
    return max(t, store.fence_time())


def simulate_profile(
    profile: WorkloadProfile,
    *,
    local_budget_bytes: int | None = None,
    local_fraction: float | None = None,
    config: ModelConfig | None = None,
    **config_kwargs: Any,
) -> float:
    """Drive the recorded event stream through the *real* simulator.

    Unlike :meth:`CostModel.predict` — an analytic replay — this registers
    every profiled object with a :class:`DolmaRuntime` (backed by a
    :class:`MemoryPool` for ``n_nodes > 1``), replays the profile's
    fetch/compute/commit events for ``n_iters`` steps, and returns the
    simulated ``elapsed_us``. The serving autoscaler's re-advise points are
    *re-simulated* through this path, so the ≤16%-degradation gate is
    checked by machinery independent of the model that chose the budget.
    """
    from repro_torch.core.dual_buffer import DolmaRuntime, run_iterative
    from repro_torch.core.pool import MemoryPool

    cfg = config or ModelConfig(**config_kwargs)
    store = None
    if cfg.n_nodes > 1:
        store = MemoryPool(
            cfg.n_nodes,
            fabric=cfg.fabric,
            stripe_bytes=cfg.stripe_bytes,
            replication=cfg.replication,
            qps_per_node=cfg.qps_per_node,
        )
    peak = sum(o.size_bytes for o in profile.objects.values()) or 1
    if local_fraction is None:
        if local_budget_bytes is None:
            raise ValueError("pass local_fraction or local_budget_bytes")
        # +0.5 so finalize's int(peak * fraction) lands back on the budget
        local_fraction = min((local_budget_bytes + 0.5) / peak, 1.0)
    rt = DolmaRuntime(
        local_fraction=local_fraction,
        fabric=cfg.fabric,
        store=store,
        sim_scale=profile.sim_scale,
        pipeline=cfg.mode == "pipeline",
        dual_buffer=cfg.mode != "serial",
        prefetch_window=cfg.window,
    )
    payloads: dict[str, np.ndarray] = {}
    for o in profile.objects.values():
        # physical arrays at the profile's sim_scale reproduce the modeled
        # sizes placement ranks by (sim_bytes = real_nbytes * sim_scale)
        arr = np.zeros(max(o.real_nbytes, 1), dtype=np.uint8)
        payloads[o.name] = arr
        rt.alloc(
            o.name, arr,
            reads_per_iter=o.n_reads,
            writes_per_iter=o.n_writes,
            kind=ObjectKind(o.kind),
            lifetime_iters=o.lifetime_iters,
            pinned_local=o.pinned_local,
        )
    rt.finalize()
    steps = profile.steps or [[]]

    def body(runtime: "DolmaRuntime", it: int) -> None:
        """Replay one recorded step's fetch/commit/compute events."""
        for op, val in steps[min(it, len(steps) - 1)]:
            if op == "fetch":
                if val in payloads:
                    runtime.fetch(val)
            elif op == "commit":
                if val in payloads:
                    runtime.commit(val, payloads[val])
            else:
                runtime.charge_compute(us=val)

    return run_iterative(rt, cfg.n_iters, body)


# ---------------------------------------------------------------------------
# the solver: smallest local budget meeting the degradation target
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CurvePoint:
    """One priced candidate budget on the degradation curve."""

    budget_bytes: int
    local_fraction: float
    predicted_us: float
    degradation: float
    memory_saving: float
    n_remote: int


@dataclasses.dataclass
class MarginalCost:
    """Predicted degradation increase from demoting this object next."""

    name: str
    size_bytes: int
    degradation_cost: float


@dataclasses.dataclass
class SizingAdvice:
    """advise_local_size() result: the advised budget + full evidence."""

    advised_budget_bytes: int
    advised_fraction: float
    predicted_us: float
    oracle_us: float
    degradation: float
    memory_saving: float
    feasible: bool
    degradation_target: float
    curve: list[CurvePoint]
    marginal: list[MarginalCost]

    def summary(self) -> dict[str, Any]:
        """Compact dict of the advice (bytes, fractions, degradation)."""
        return {
            "advised_budget_bytes": self.advised_budget_bytes,
            "advised_fraction": round(self.advised_fraction, 4),
            "degradation": round(self.degradation, 4),
            "memory_saving": round(self.memory_saving, 4),
            "feasible": self.feasible,
            "degradation_target": self.degradation_target,
            "n_candidates": len(self.curve),
        }


# cache headroom sampled above each demotion threshold (fractions of peak):
# the budget sawtooth — same demoted set, growing cache region
_HEADROOM_FRACTIONS = (0.01, 0.025, 0.05, 0.1, 0.2)
_MARGINAL_HEADROOM = 0.05
# coarse fraction grid, for policies (all_large_remote) whose demoted set
# does not depend on the budget
_FRACTION_GRID = (0.01, 0.02, 0.05, 0.1, 0.15, 0.25, 0.4, 0.6, 0.8)


def advise_local_size(
    workload_profile: WorkloadProfile,
    degradation_target: float = DEFAULT_DEGRADATION_TARGET,
    *,
    policy: PlacementPolicy | None = None,
    config: ModelConfig | None = None,
    **config_kwargs: Any,
) -> SizingAdvice:
    """The smallest local budget whose predicted degradation meets the target.

    Walks the placement policy's demotion order: every candidate budget is a
    demotion prefix plus a cache-region headroom, priced by the cost model
    against the untiered oracle. Returns the cheapest feasible budget (the
    paper's knee: <=16% slowdown at up to 63% memory saving) with the full
    degradation curve and per-object marginal-cost attribution. When no
    candidate meets the target, ``feasible`` is False and the advice falls
    back to the least-degraded candidate.

    Monotone by construction: a tighter target selects from a smaller
    feasible subset of the same candidate curve, so the advised budget can
    only grow.
    """
    cfg = config or ModelConfig(**config_kwargs)
    model = CostModel(workload_profile, policy=policy)
    catalog = model.catalog
    peak = catalog.total_bytes
    oracle_us = model.predict_untiered(n_iters=cfg.n_iters)
    metadata_region = max(4096, 64 * len(catalog))

    order = demotion_order(catalog)
    local_after: list[int] = [peak]
    for obj in order:
        local_after.append(local_after[-1] - obj.size_bytes)

    budgets: set[int] = {peak}
    for k in range(1, len(order) + 1):
        for h in _HEADROOM_FRACTIONS:
            b = local_after[k] + metadata_region + max(int(h * peak), 4096)
            budgets.add(min(b, peak))
    for f in _FRACTION_GRID:
        budgets.add(max(int(f * peak), metadata_region + 4096))

    curve: list[CurvePoint] = []
    by_budget: dict[int, CurvePoint] = {}
    for b in sorted(budgets, reverse=True):
        if b == peak:
            pred_us = oracle_us
            plan = model.policy.plan(catalog, local_budget_bytes=b,
                                     n_nodes=cfg.n_nodes,
                                     node_capacity_bytes=cfg.node_capacity_bytes)
            if plan.remote_bytes:
                pred_us = model.predict(local_budget_bytes=b,
                                        config=cfg).elapsed_us
        else:
            plan = None
            pred_us = None
        if pred_us is None:
            p = model.predict(local_budget_bytes=b, config=cfg)
            pred_us, plan = p.elapsed_us, p.plan
        point = CurvePoint(
            budget_bytes=b,
            local_fraction=b / peak if peak else 1.0,
            predicted_us=pred_us,
            degradation=pred_us / oracle_us - 1.0 if oracle_us else 0.0,
            memory_saving=plan.memory_saving,
            n_remote=len(plan.remote_names()),
        )
        curve.append(point)
        by_budget[b] = point

    feasible = [p for p in curve
                if p.degradation <= degradation_target + 1e-12]
    if feasible:
        best = min(feasible, key=lambda p: p.budget_bytes)
        ok = True
    else:
        best = min(curve, key=lambda p: p.degradation)
        ok = False

    # marginal attribution at a fixed headroom: demoting order[k] next moves
    # the curve from the k-demotion point to the (k+1)-demotion point. The
    # budget must stay below the previous threshold or the policy would stop
    # before demoting object k (headroom > next object's size).
    marginal: list[MarginalCost] = []
    h = metadata_region + max(int(_MARGINAL_HEADROOM * peak), 4096)
    prev_deg = 0.0
    if not model.policy.all_large_remote:
        for k in range(1, len(order) + 1):
            b = min(local_after[k] + h, local_after[k - 1] - 1, peak)
            b = max(b, local_after[k])
            point = by_budget.get(b)
            if point is None:
                pred = model.predict(local_budget_bytes=b, config=cfg)
                point = CurvePoint(
                    budget_bytes=b,
                    local_fraction=b / peak if peak else 1.0,
                    predicted_us=pred.elapsed_us,
                    degradation=(pred.elapsed_us / oracle_us - 1.0
                                 if oracle_us else 0.0),
                    memory_saving=pred.plan.memory_saving,
                    n_remote=len(pred.plan.remote_names()),
                )
            marginal.append(MarginalCost(
                name=order[k - 1].name,
                size_bytes=order[k - 1].size_bytes,
                degradation_cost=point.degradation - prev_deg,
            ))
            prev_deg = point.degradation

    return SizingAdvice(
        advised_budget_bytes=best.budget_bytes,
        advised_fraction=best.local_fraction,
        predicted_us=best.predicted_us,
        oracle_us=oracle_us,
        degradation=best.degradation,
        memory_saving=best.memory_saving,
        feasible=ok,
        degradation_target=degradation_target,
        curve=curve,
        marginal=marginal,
    )


# ---------------------------------------------------------------------------
# multi-tenant advisories: per-tenant sizing + fleet-level feasibility
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TenantAdvice:
    """One tenant's sizing advisory, as the admission controller prices it.

    ``remote_kv_bytes`` is the KV working set (sim-scaled bytes) the advised
    budget would push to the shared pool — the quantity fleet capacity
    planning sums across tenants.
    """

    tenant: str
    advice: SizingAdvice
    remote_kv_bytes: int


@dataclasses.dataclass
class FleetFeasibility:
    """Result of :func:`combined_feasibility` over all candidate tenants.

    ``required_nodes`` is the unclamped node count the summed working sets
    need at effective (frag-adjusted) capacity; ``target_nodes`` is that
    clamped into ``[min_nodes, max_nodes]``. ``feasible`` is True iff the
    clamp did not bind — i.e. the pool *can* hold every candidate tenant's
    advised working set at once.
    """

    feasible: bool
    target_nodes: int
    required_nodes: int
    total_remote_bytes: int
    per_tenant_remote_bytes: dict[str, int]
    effective_node_capacity_bytes: int


def tenant_remote_kv_bytes(
    profile: WorkloadProfile,
    advice: SizingAdvice,
    *,
    n_nodes: int = 1,
    stripe_bytes: int = DEFAULT_STRIPE_BYTES,
    policy: PlacementPolicy | None = None,
) -> int:
    """KV-cache bytes the advised budget demotes to the remote pool.

    Re-plans the tenant's catalog at ``advice.advised_budget_bytes`` and sums
    the demoted objects of kind ``KV_CACHE`` (sim-scaled bytes) — the same
    budget→working-set mapping the single-tenant autoscaler installs, exposed
    per tenant so the fleet controller can sum it across arrivals.
    """
    catalog = profile.catalog()
    plan = (policy or PlacementPolicy()).plan(
        catalog,
        local_budget_bytes=advice.advised_budget_bytes,
        n_nodes=max(n_nodes, 1),
        stripe_bytes=stripe_bytes,
    )
    return sum(
        catalog[n].size_bytes
        for n in plan.remote_names()
        if catalog[n].kind is ObjectKind.KV_CACHE
    )


def advise_tenants(
    profiles: dict[str, WorkloadProfile],
    degradation_target: float = DEFAULT_DEGRADATION_TARGET,
    *,
    config: ModelConfig | None = None,
    stripe_bytes: int = DEFAULT_STRIPE_BYTES,
    **config_kwargs: Any,
) -> dict[str, TenantAdvice]:
    """Run :func:`advise_local_size` independently for every tenant.

    Each tenant is priced against the *same* SLO (per-tenant, not
    aggregate): the advisory answers "what local working set does this
    tenant need so *its own* re-simulated degradation stays under the
    target", and :class:`TenantAdvice.remote_kv_bytes` is its contribution
    to shared-pool demand. Tenants with empty profiles are skipped.
    """
    cfg = config or ModelConfig(**config_kwargs)
    out: dict[str, TenantAdvice] = {}
    for tenant, profile in profiles.items():
        if not profile.objects:
            continue
        advice = advise_local_size(profile, degradation_target, config=cfg)
        out[tenant] = TenantAdvice(
            tenant=tenant,
            advice=advice,
            remote_kv_bytes=tenant_remote_kv_bytes(
                profile, advice, n_nodes=cfg.n_nodes,
                stripe_bytes=stripe_bytes,
            ),
        )
    return out


def combined_feasibility(
    per_tenant_remote_bytes: dict[str, int],
    *,
    replication: int = 1,
    node_capacity_bytes: int,
    frag_bytes_per_node: float = 0.0,
    min_nodes: int = 1,
    max_nodes: int | None = None,
) -> FleetFeasibility:
    """Can one shared pool hold every candidate tenant's advised working set?

    Sums the per-tenant advised remote KV bytes (× replication), divides by
    *effective* per-node capacity (raw minus measured allocator
    fragmentation), and reports whether the resulting node count fits under
    ``max_nodes``. This is the fleet-level check the admission controller
    runs before committing: when it fails, some tenant must be shed or kept
    queued — Wahlgren et al.'s point that admission must come from the
    quantitative model, not static quotas.
    """
    eff = effective_node_capacity(node_capacity_bytes, frag_bytes_per_node)
    total = sum(per_tenant_remote_bytes.values())
    required = -(-total * max(replication, 1) // eff) if total else 0
    required = max(required, min_nodes)
    target = min(required, max_nodes) if max_nodes is not None else required
    return FleetFeasibility(
        feasible=required == target,
        target_nodes=target,
        required_nodes=required,
        total_remote_bytes=total,
        per_tenant_remote_bytes=dict(per_tenant_remote_bytes),
        effective_node_capacity_bytes=eff,
    )


def effective_node_capacity(
    node_capacity_bytes: int, frag_bytes_per_node: float = 0.0
) -> int:
    """Raw per-node capacity minus measured allocator fragmentation.

    Fragmentation held in partial slabs (``MemoryPool.fragmentation_stats()
    ["frag_bytes_per_node"]``) is space a node *charges* but cannot serve —
    capacity planning that prices raw bytes oscillates on that phantom
    space (scale down onto it, rediscover it's unusable, scale back up).
    """
    return max(int(node_capacity_bytes - frag_bytes_per_node), 1)


def pool_nodes_needed(
    remote_bytes: int,
    *,
    replication: int = 1,
    node_capacity_bytes: int,
    frag_bytes_per_node: float = 0.0,
    min_nodes: int = 1,
    max_nodes: int | None = None,
) -> int:
    """Nodes required to hold ``remote_bytes`` (× replication) of working
    set, priced on *effective* capacity — the advised-budget→node-count
    mapping the serving autoscaler installs (DESIGN.md §8/§10)."""
    eff = effective_node_capacity(node_capacity_bytes, frag_bytes_per_node)
    need = -(-remote_bytes * replication // eff) if remote_bytes else 0
    need = max(need, min_nodes)
    if max_nodes is not None:
        need = min(need, max_nodes)
    return need


# ---------------------------------------------------------------------------
# expert-residency sizing: hit-rate curves over router mass
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExpertCurvePoint:
    """One priced resident-set size on the expert hit-rate curve."""

    resident: int
    hit_rate: float
    resident_bytes: int
    predicted_degradation: float


@dataclasses.dataclass
class ExpertResidencyAdvice:
    """:func:`advise_expert_residency` result: advised resident-set size.

    ``hit_rate``/``predicted_degradation`` describe the advised point;
    ``curve`` carries every candidate so callers can plot the knee. The
    curve's hit-rate is non-decreasing in ``resident`` by construction
    (top-``r`` router mass), mirroring :func:`advise_local_size`'s
    monotone-budget contract.
    """

    advised_resident: int
    hit_rate: float
    resident_bytes: int
    predicted_degradation: float
    feasible: bool
    degradation_target: float
    curve: list[ExpertCurvePoint]

    def summary(self) -> dict[str, Any]:
        """Compact dict of the advice (resident count, hit rate, bytes)."""
        return {
            "advised_resident": self.advised_resident,
            "hit_rate": round(self.hit_rate, 4),
            "resident_bytes": self.resident_bytes,
            "predicted_degradation": round(self.predicted_degradation, 4),
            "feasible": self.feasible,
        }


def advise_expert_residency(
    mass: np.ndarray,
    *,
    bytes_per_expert: int,
    fetch_us_per_expert: float,
    compute_us_per_step: float,
    experts_per_step: float,
    degradation_target: float = DEFAULT_DEGRADATION_TARGET,
    hbm_budget_bytes: int | None = None,
    min_resident: int = 1,
) -> ExpertResidencyAdvice:
    """Smallest per-layer resident set whose predicted degradation fits.

    The serving analogue of :func:`advise_local_size` for paged expert
    weights: ``mass`` is the measured per-expert router mass — shape
    ``(E,)`` or ``(n_layers, E)``, e.g. the pager's decayed EMA — and the
    stationary working-set model prices each candidate resident-set size
    ``r``:

    * ``hit_rate(r)`` = the router-mass fraction covered by the top-``r``
      experts (averaged over layers) — the probability a routed expert is
      already resident under mass-ranked retention;
    * misses per step = ``experts_per_step × (1 − hit_rate(r))``, each
      stalling a blocking ``fetch_us_per_expert`` (sync fallback; prefetch
      hides predicted fetches, so this prices the *unpredicted* tail);
    * ``degradation(r)`` = miss stall per step over ``compute_us_per_step``.

    The advised ``r`` is the smallest candidate meeting the target whose
    resident bytes also fit ``hbm_budget_bytes`` (when given). If no
    candidate meets both, ``feasible`` is False and the advice falls back
    to the least-degraded affordable candidate.
    """
    m = np.asarray(mass, dtype=np.float64)
    if m.ndim == 1:
        m = m[None, :]
    if m.ndim != 2:
        raise ValueError(f"mass must be (E,) or (n_layers, E), got {m.shape}")
    n_layers, E = m.shape
    totals = m.sum(axis=1, keepdims=True)
    # uniform prior where a layer has no observed mass yet (cold start)
    p = np.where(totals > 0, m / np.where(totals > 0, totals, 1.0), 1.0 / E)
    ranked = np.sort(p, axis=1)[:, ::-1]          # per-layer mass, desc
    coverage = np.cumsum(ranked, axis=1)           # (n_layers, E): hit_rate(r)

    curve: list[ExpertCurvePoint] = []
    for r in range(max(min_resident, 1), E + 1):
        hr = float(np.mean(coverage[:, r - 1]))
        stall = experts_per_step * (1.0 - hr) * fetch_us_per_expert
        deg = stall / compute_us_per_step if compute_us_per_step else 0.0
        curve.append(ExpertCurvePoint(
            resident=r,
            hit_rate=hr,
            resident_bytes=r * bytes_per_expert * n_layers,
            predicted_degradation=deg,
        ))

    affordable = [
        pt for pt in curve
        if hbm_budget_bytes is None or pt.resident_bytes <= hbm_budget_bytes
    ] or curve[:1]
    feasible_pts = [pt for pt in affordable
                    if pt.predicted_degradation <= degradation_target + 1e-12]
    if feasible_pts:
        best = min(feasible_pts, key=lambda pt: pt.resident)
        ok = True
    else:
        best = min(affordable, key=lambda pt: pt.predicted_degradation)
        ok = False
    return ExpertResidencyAdvice(
        advised_resident=best.resident,
        hit_rate=best.hit_rate,
        resident_bytes=best.resident_bytes,
        predicted_degradation=best.predicted_degradation,
        feasible=ok,
        degradation_target=degradation_target,
        curve=curve,
    )


def decode_state_census(model_cfg, batch: int, max_len: int) -> ObjectCatalog:
    """Analytic census of a config's decode-state objects.

    Extends the tiered accounting beyond GQA KV pages to every persistent
    decode-state family the repo ships — MLA's latent KV (the compressed
    ``c``/``kr`` caches), Mamba SSD conv/state, the hybrid's shared
    attention KV — plus the per-expert weight slabs of MoE configs. Names
    mirror the serving engine's catalog convention (``cache['k']`` …) and
    :func:`repro_torch.core.placement.expert_slab_name`, and the cache rows are
    asserted byte-identical to ``init_decode_cache`` in tests, so sizing
    advice priced on this census prices the arrays the engine actually
    holds.
    """
    from repro_torch.core.placement import expert_slab_objects

    cfg = model_cfg
    nL = cfg.n_layers
    catalog = ObjectCatalog()

    def add(name: str, shape: tuple[int, ...], dtype) -> None:
        catalog.add(DataObject(
            name=f"cache['{name}']", shape=shape, dtype=dtype,
            kind=ObjectKind.KV_CACHE, n_reads=1, n_writes=1,
        ))

    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.attention == "mla":
            add("c", (nL, batch, max_len, cfg.kv_lora_rank), cfg.dtype)
            add("kr", (nL, batch, max_len, cfg.qk_rope_head_dim), cfg.dtype)
        else:
            S_c = (min(max_len, cfg.sliding_window) if cfg.sliding_window
                   else max_len)
            shape = (nL, batch, S_c, cfg.n_kv_heads, cfg.head_dim)
            add("k", shape, cfg.dtype)
            add("v", shape, cfg.dtype)
    elif cfg.family in ("ssm", "hybrid"):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        add("conv", (nL, batch, cfg.ssm_conv_width - 1, conv_ch), cfg.dtype)
        add("state",
            (nL, batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
            np.float32)
        if cfg.family == "hybrid":
            n_inv = cfg.n_layers // cfg.hybrid_attn_every
            shape = (n_inv, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            add("shared_k", shape, cfg.dtype)
            add("shared_v", shape, cfg.dtype)
    else:
        raise ValueError(f"decode census for family {cfg.family!r} "
                         "is not supported")

    for obj in expert_slab_objects(cfg):
        catalog.add(obj)
    return catalog


__all__ = [
    "CostModel",
    "CurvePoint",
    "DEFAULT_DEGRADATION_TARGET",
    "ExpertCurvePoint",
    "ExpertResidencyAdvice",
    "FleetFeasibility",
    "MODEL_TOLERANCE",
    "MarginalCost",
    "ModelConfig",
    "ObjectProfile",
    "Prediction",
    "RollingProfile",
    "SizingAdvice",
    "TenantAdvice",
    "WorkloadProfile",
    "advise_expert_residency",
    "advise_local_size",
    "advise_tenants",
    "combined_feasibility",
    "decode_state_census",
    "effective_node_capacity",
    "pool_nodes_needed",
    "simulate_profile",
    "synthetic_profile",
    "tenant_remote_kv_bytes",
]
