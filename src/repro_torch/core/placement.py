"""Remote data-object selection — the paper's §4.1 policy, verbatim.

Given an :class:`ObjectCatalog` and a local-memory budget (a fraction of peak
usage, matching the paper's 1/5/20/50/70/100 % evaluation axis), decide which
objects to demote to remote memory:

  rule 1: large objects first, by size descending;
  rule 2: ties broken by access count ascending (cold objects remote);
  rule 3: further ties broken by write ratio descending (remote prefers writes).

Small (<= 4 KiB) and short-lived objects stay local (they are served by the
local data-object region / remote atomics, §4.1). Pinned objects never move.

A copy of ``repro.core.placement``. In this package the plan is consumed by
the host runtime (:mod:`repro_torch.core.dual_buffer` over a remote store or
pool), :meth:`repro_torch.core.exec.StreamingExecutor.plan_tiers` and the
layer loop's host offload (:mod:`repro_torch.core.tiering`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from repro_torch.core.metadata import Tier
from repro_torch.core.objects import DataObject, ObjectCatalog, ObjectKind


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    tiers: Mapping[str, Tier]
    local_bytes: int
    remote_bytes: int
    peak_bytes: int
    budget_bytes: int
    # remote object -> home memory-node id (multi-node pools); empty for the
    # single-node remote tier
    node_of: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # memory-node id -> remote bytes homed there (stripe-period load balance)
    node_load: Mapping[int, int] = dataclasses.field(default_factory=dict)
    n_nodes: int = 1
    # where a train step's REMOTE leaves live: host memory ("host",
    # host_offload) or the peers' HBM over a mesh axis ("peer",
    # fsdp_stream; see repro_torch.core.tiering)
    remote_medium: str = "host"
    # the REMOTE leaves a "peer" plan's placement split, each with the mesh
    # axis it split it over: the layer loop gathers their layers
    peer_split: Mapping[str, str] = dataclasses.field(default_factory=dict)

    @property
    def local_fraction(self) -> float:
        return self.local_bytes / self.peak_bytes if self.peak_bytes else 1.0

    @property
    def memory_saving(self) -> float:
        """Fraction of peak memory moved off the local node (paper: up to 63%)."""
        return self.remote_bytes / self.peak_bytes if self.peak_bytes else 0.0

    def tier_of(self, name: str) -> Tier:
        return self.tiers[name]

    def remote_names(self) -> list[str]:
        return [n for n, t in self.tiers.items() if t is Tier.REMOTE]

    def local_names(self) -> list[str]:
        return [n for n, t in self.tiers.items() if t is not Tier.REMOTE]

    def node_bytes(self) -> dict[int, int]:
        """Remote bytes homed on each memory node (load-balance view)."""
        out = {i: 0 for i in range(self.n_nodes)}
        out.update(self.node_load)
        return out

    def summary(self) -> dict:
        return {
            "peak_bytes": self.peak_bytes,
            "budget_bytes": self.budget_bytes,
            "local_bytes": self.local_bytes,
            "remote_bytes": self.remote_bytes,
            "local_fraction": round(self.local_fraction, 4),
            "memory_saving": round(self.memory_saving, 4),
            "n_remote": len(self.remote_names()),
            "n_local": len(self.local_names()),
            "n_nodes": self.n_nodes,
        }


@dataclasses.dataclass(frozen=True)
class PlanDiff:
    """Object moves that turn one :class:`PlacementPlan` into another.

    The serving autoscaler re-plans every re-advise; applying the *diff*
    (promote the few objects whose tier improved, demote the few that got
    worse, leave the rest untouched) instead of a full re-offload keeps
    resize traffic proportional to the working-set drift, not the catalog.
    """

    promote: tuple[str, ...]    # REMOTE -> LOCAL: free the pool copy
    demote: tuple[str, ...]     # LOCAL -> REMOTE: allocate + write back
    rehome: tuple[str, ...]     # REMOTE in both, planned home node changed
    unchanged_remote: tuple[str, ...]

    @property
    def is_noop(self) -> bool:
        return not (self.promote or self.demote or self.rehome)

    def summary(self) -> dict:
        return {
            "n_promote": len(self.promote),
            "n_demote": len(self.demote),
            "n_rehome": len(self.rehome),
            "n_unchanged_remote": len(self.unchanged_remote),
        }


def diff_plans(old: PlacementPlan, new: PlacementPlan) -> PlanDiff:
    """Diff two plans into promote/demote/rehome move lists (sorted).

    Objects present in only one plan's catalog are handled by their remote
    membership alone: gone-and-was-remote means promote (free the copy),
    new-and-is-remote means demote. Home-node churn for objects that stay
    remote is reported separately — striped pools rebalance extents
    themselves, so a ``rehome`` is advisory, not a data move.

    The diff keys on tiers and homes only — never on slab geometry — so
    intra-node allocator activity (slab folding under ``MemoryPool.compact``)
    between two otherwise-identical slab-aware plans diffs to a no-op.
    """
    old_remote = set(old.remote_names())
    new_remote = set(new.remote_names())
    stay = old_remote & new_remote
    rehome = {n for n in stay if old.node_of.get(n) != new.node_of.get(n)}
    return PlanDiff(
        promote=tuple(sorted(old_remote - new_remote)),
        demote=tuple(sorted(new_remote - old_remote)),
        rehome=tuple(sorted(rehome)),
        unchanged_remote=tuple(sorted(stay - rehome)),
    )


def demotion_order(objects: Iterable[DataObject]) -> list[DataObject]:
    """Paper §4.1 ranking: size desc, then accesses asc, then write-ratio desc.

    ``pinned_remote`` objects are excluded: they are demoted unconditionally
    before the ranked walk (their authoritative copy lives in the pool by
    construction), so they never compete for the budget-driven prefix.
    """
    eligible = [
        o for o in objects
        if not o.is_small and not o.is_short_lived and not o.pinned_local
        and not o.pinned_remote
    ]
    return sorted(
        eligible,
        key=lambda o: (-o.size_bytes, o.n_accesses, -o.write_ratio, o.name),
    )


def expert_slab_objects(
    cfg,
    *,
    n_moe_layers: int | None = None,
) -> list[DataObject]:
    """Per-expert object census for a MoE config (ISSUE 10).

    One :class:`DataObject` per ``(moe_layer, expert)`` slab — the packed
    ``(w_gate, w_up, w_down)`` weights — named to match the serving pager's
    pool entries (``expert:L{l}:E{e}``). Each slab is ``pinned_remote``: the
    pool holds the authoritative copy and only the pager's resident set
    occupies HBM. Access stats encode the cold skew the §4.1 ranking keys
    on: an expert is read iff routed, expected ``top_k / n_experts`` of the
    per-token reads a dense FFN would take, and never written at serve time.
    """
    if not getattr(cfg, "is_moe", False):
        return []
    if n_moe_layers is None:
        n_moe_layers = cfg.n_layers - cfg.first_k_dense
    slab_elems = 3 * cfg.d_model * cfg.moe_d_ff
    out: list[DataObject] = []
    for layer in range(n_moe_layers):
        for e in range(cfg.n_experts):
            out.append(DataObject(
                name=expert_slab_name(layer, e),
                shape=(slab_elems,),
                dtype=cfg.dtype,
                kind=ObjectKind.EXPERT,
                n_reads=1,
                n_writes=0,
                pinned_remote=True,
            ))
    return out


def expert_slab_name(layer: int, expert: int) -> str:
    """Canonical pool/catalog name of one paged expert slab."""
    return f"expert:L{layer:02d}:E{expert:03d}"


class PlacementPolicy:
    """DOLMA's remote-object selection."""

    def __init__(self, *, small_object_local: bool = True,
                 all_large_remote: bool = False):
        self.small_object_local = small_object_local
        # Fig-7 evaluation mode (§6.1): the x-axis budget is the *registered*
        # region (remote-DO cache + metadata); every large object is remote
        # and the compute node keeps only small objects + the cache.
        self.all_large_remote = all_large_remote

    def plan(
        self,
        catalog: ObjectCatalog,
        *,
        local_fraction: float | str | None = None,
        local_budget_bytes: int | str | None = None,
        n_nodes: int = 1,
        node_capacity_bytes: int | None = None,
        profile: "object | None" = None,
        degradation_target: float = 0.16,
        sizing_config: "object | None" = None,
        stripe_bytes: int | None = None,
        node_frag_bytes: Mapping[int, float] | None = None,
    ) -> PlacementPlan:
        """Demote ranked objects until local usage fits the budget.

        With ``n_nodes > 1`` the plan also assigns each remote object a home
        memory node, greedily least-loaded-first; ``node_capacity_bytes`` is
        a hard per-node constraint — an object that fits on no node is kept
        LOCAL (remote capacity, like local capacity, is finite at rack scale).

        Passing ``"auto"`` for either budget knob invokes the quantitative
        sizing solver (:func:`repro_torch.core.sizing.advise_local_size`) on the
        supplied ``profile`` (a ``WorkloadProfile``): the budget becomes the
        smallest one whose predicted degradation meets
        ``degradation_target``; ``sizing_config`` (a ``ModelConfig``) sets
        the fabric/topology the cost model prices against.

        **Slab-aware planning** (``stripe_bytes`` given): each object's
        per-node load is its slab footprint — full stripes plus the
        class-rounded tail (:func:`repro_torch.core.alloc.object_footprint_bytes`)
        — so ``node_load`` prices the bytes the pool's allocator will
        actually hold, and ``node_frag_bytes`` (measured per-node
        fragmentation, e.g. ``MemoryPool.fragmentation_stats()``) shrinks
        each node's effective capacity. Footprints are deterministic in the
        catalog alone, so replanning around a compaction — which changes
        fragmentation but neither sizes nor membership — yields an
        identical plan (and an empty :func:`diff_plans` diff) unless the
        freed fragmentation newly unblocks a capacity-bound demotion:
        steady-state compaction moves nothing.
        """
        if local_fraction == "auto" or local_budget_bytes == "auto":
            if profile is None:
                raise ValueError(
                    "budget 'auto' needs a WorkloadProfile (profile=...): "
                    "record one with DolmaRuntime(record_profile=True)"
                )
            from repro_torch.core.sizing import advise_local_size

            advice = advise_local_size(
                profile, degradation_target, policy=self,
                **({"config": sizing_config} if sizing_config is not None
                   else {"n_nodes": n_nodes,
                         "node_capacity_bytes": node_capacity_bytes}),
            )
            local_budget_bytes = advice.advised_budget_bytes
            local_fraction = None
        peak = catalog.total_bytes
        if local_budget_bytes is None:
            if local_fraction is None:
                raise ValueError("pass local_fraction or local_budget_bytes")
            local_budget_bytes = int(peak * local_fraction)

        if stripe_bytes is not None:
            from repro_torch.core.alloc import object_footprint_bytes

            def footprint(nbytes: int) -> int:
                return object_footprint_bytes(nbytes,
                                              stripe_bytes=stripe_bytes)
        else:
            def footprint(nbytes: int) -> int:
                return nbytes
        frag = dict(node_frag_bytes or {})

        tiers: dict[str, Tier] = {o.name: Tier.LOCAL for o in catalog}
        node_of: dict[str, int] = {}
        node_load: dict[int, int] = {i: 0 for i in range(n_nodes)}
        local_bytes = peak
        # pinned_remote objects (paged expert slabs) demote unconditionally:
        # the pool is their authoritative home, independent of the budget.
        # They still charge node_load (capacity planning sees them) but skip
        # the per-node capacity gate — they have no local fallback.
        for obj in catalog:
            if not obj.pinned_remote:
                continue
            home = min(node_load, key=lambda i: (node_load[i], i))
            tiers[obj.name] = Tier.REMOTE
            node_of[obj.name] = home
            node_load[home] += footprint(obj.size_bytes)
            local_bytes -= obj.size_bytes
        for obj in demotion_order(catalog):
            if not self.all_large_remote and local_bytes <= local_budget_bytes:
                break
            # home = least-loaded node with room (striping spreads the extents
            # from here; the home-node load is the stripe-period anchor)
            home = min(node_load, key=lambda i: (node_load[i], i))
            if (
                node_capacity_bytes is not None
                and node_load[home] + footprint(obj.size_bytes)
                > node_capacity_bytes - frag.get(home, 0)
            ):
                continue  # no node can take it: stays local
            tiers[obj.name] = Tier.REMOTE
            node_of[obj.name] = home
            node_load[home] += footprint(obj.size_bytes)
            local_bytes -= obj.size_bytes

        remote_bytes = peak - local_bytes
        return PlacementPlan(
            tiers=tiers,
            local_bytes=local_bytes,
            remote_bytes=remote_bytes,
            peak_bytes=peak,
            budget_bytes=local_budget_bytes,
            node_of=node_of,
            node_load=node_load,
            n_nodes=n_nodes,
        )
