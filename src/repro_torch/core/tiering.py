"""DOLMA placement applied to a model's parameters and optimizer state, and
the layer loop's dual buffer with sqrt-L checkpointing.

The port of ``repro.core.tiering``. Two backends realize a plan:

* ``host_offload`` — REMOTE leaves live in host memory (pinned when the
  model runs on a card): HBM is the local tier, host DRAM the remote tier.
  :func:`place_params` and :func:`place_state` put every leaf where its
  tier says; :func:`tiered_scan` streams each layer's REMOTE slices to the
  device through a :class:`~repro_torch.core.exec.HostFetchEngine` (a copy
  stream and CUDA events). Under a device mesh the leaves are DTensors and
  each rank keeps its own local shard of a REMOTE leaf on the host.
* ``fsdp_stream`` (the default, as in the reference) — under a mesh, REMOTE
  leaves are split over the ``fsdp_axis`` (``data``): a stacked leaf on its
  layer dim where the axis divides it, otherwise on a weight dim its spec
  left whole (:func:`leaf_sharding`). Peer HBM is the remote tier:
  :func:`tiered_scan` gathers layer i+1 with an asynchronous collective
  posted before layer i computes, and waits on its work handle at first
  use. Without a mesh there is no peer, and every leaf stays on the device.

``mode="none"`` keeps every leaf on the device.

:func:`tiered_scan` is the single engine of the layer loop. It composes
the dual buffer with activation checkpointing:

* **remat off** — a loop that, with ``prefetch``, posts layer i+1's fetch
  before layer i computes; the access barrier is deferred to the first use
  of those weights (:meth:`HostFetchEngine.acquire`).
* **remat on** — depth ``L`` splits into ``n_outer`` checkpointed blocks of
  ``n_inner`` checkpointed layers (:func:`_block_split`), through
  ``torch.utils.checkpoint`` (non-reentrant, so the checkpoints nest). Each
  fetch sits inside a boundary: a recompute re-issues it and nothing
  fetched is saved across the forward. With ``prefetch`` the dual buffer
  runs inside each block. Depths below ``min_layers`` checkpoint each
  layer on its own.

Prefetch and placement change only *when* and *from where* bytes move:
every placement and both prefetch settings run the same kernels on the
same values, so losses, gradients and updates are bit-identical.

**Gradients of REMOTE leaves.** A REMOTE slice reaches the device by a copy
in the engine's worker thread, outside autograd. Left to autograd, the
index into the host leaf would build a full-size zero host tensor for every
layer in the backward and scatter into it on the CPU. Instead each fetched
tensor passes through :class:`RemoteGrads` (when the caller trains): an
identity on the forward whose backward adds the slice's gradient into row
i of a gradient buffer of the whole leaf *on the device*. Gradients are
transient (one step), as in the reference, whose step keeps them as
device intermediates and places only the persistent objects (parameters
and moments); adding into zeros is exact, so a REMOTE leaf's gradient is
bit-equal to the one autograd gives the same leaf kept local. The train
step (:func:`repro_torch.train.step.make_train_step`) then streams each
REMOTE parameter and its moments through the engine, updates them on the
device and writes them back.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import re
from typing import Any, Callable, Literal, Mapping

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.exec import HostFetchEngine, host_tensor, resolve_device
from repro_torch.core.fabric import TPU_V5E_HBM_GBPS
from repro_torch.core.metadata import Tier
from repro_torch.core.objects import (
    DataObject,
    ObjectCatalog,
    ObjectKind,
    _leaves_with_keys,
)
from repro_torch.core.placement import PlacementPlan, PlacementPolicy
from repro_torch.core.sizing import synthetic_profile
from repro_torch.kernels.traced import is_traced

TieringMode = Literal["none", "host_offload", "fsdp_stream"]


@dataclasses.dataclass(frozen=True)
class TieringConfig:
    """How params and optimizer state tier out of HBM during the step.

    ``local_fraction`` is the share of (param + opt state) bytes kept
    resident on the device, or ``"auto"`` to let the sizing solver pick it
    for ``degradation_target`` (0.16 = the paper's knee). ``prefetch``
    turns on the layer loop's dual buffer, and ``prefetch_under_remat``
    keeps it on inside the checkpointed blocks (the fetches recomputed,
    not saved); :meth:`TrainStepConfig.from_tiering
    <repro_torch.train.step.TrainStepConfig.from_tiering>` carries both
    into the train step.
    """

    mode: TieringMode = "fsdp_stream"
    local_fraction: float | str = 1.0
    degradation_target: float = 0.16
    prefetch: bool = True
    prefetch_under_remat: bool = True
    # the mesh axis fsdp_stream splits the REMOTE leaves over (the plan
    # names the leaves it split, and this axis, in ``peer_split``)
    fsdp_axis: str = "data"

    def __post_init__(self):
        if self.mode not in ("none", "host_offload", "fsdp_stream"):
            raise ValueError(f"TieringConfig: unknown mode {self.mode!r}")


def plan_for_params(params: Any, *, config: TieringConfig,
                    opt_state: Any = None,
                    access_counts: dict[str, int] | None = None,
                    profile: Any = None, telemetry: Any = None,
                    ) -> PlacementPlan:
    """A placement plan over the persistent objects of a train step.

    Parameters are named ``"params" + keystr`` and read twice and written
    once a step (forward + backward, update); optimizer leaves
    ``"opt" + keystr`` (an int8 moment's ``.codes`` and ``.scale`` each)
    are read and written once. These are the reference's defaults;
    ``access_counts`` overrides a parameter's reads.

    With ``config.local_fraction == "auto"`` the budget comes from the sizing
    solver: pass a recorded ``WorkloadProfile``, or omit ``profile`` to have
    one synthesized from this catalog (each leaf fetched once a step, the
    step's compute estimated from the leaves' bytes at the reference's HBM
    rate), as the reference does.
    """
    catalog = ObjectCatalog()
    for key, leaf in _leaves_with_keys(params):
        name = "params" + key
        catalog.add(DataObject(
            name=name, shape=tuple(leaf.shape), dtype=leaf.dtype,
            kind=ObjectKind.PARAM,
            n_reads=(access_counts or {}).get(name, 2), n_writes=1))
    if opt_state is not None:
        for key, leaf in _leaves_with_keys(opt_state):
            catalog.add(DataObject(
                name="opt" + key, shape=tuple(leaf.shape), dtype=leaf.dtype,
                kind=ObjectKind.OPT_STATE, n_reads=1, n_writes=1))
    if config.local_fraction == "auto" and profile is None:
        # one read of every leaf a step at the HBM rate approximates the
        # step's compute floor; the rate is the reference's TPU figure, kept
        # so that the port's "auto" plans equal the reference's
        compute_us = catalog.total_bytes / (TPU_V5E_HBM_GBPS * 1e3)
        profile = synthetic_profile(catalog, compute_us_per_step=compute_us,
                                    source="plan_for_params")
    plan = PlacementPolicy().plan(
        catalog, local_fraction=config.local_fraction, profile=profile,
        degradation_target=config.degradation_target)
    if telemetry is not None and telemetry.enabled:
        telemetry.instant("tiering.plan", track="tiering", t_us=0.0,
                          **plan.summary())
        telemetry.gauge("tiering.local_bytes", plan.local_bytes)
        telemetry.gauge("tiering.remote_bytes", plan.remote_bytes)
    return plan


def map_leaves(fn: Callable[[str, torch.Tensor], torch.Tensor], tree: Any,
               key: str = "") -> Any:
    """Nested dicts ``tree`` with each leaf replaced by ``fn(keystr, leaf)``;
    a dataclass node (an int8 moment) keeps its type, its fields mapped."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{key}[{k!r}]") for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name), f"{key}.{f.name}")
            for f in dataclasses.fields(tree)})
    return fn(key, tree)


def _is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def local_part(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiably); a plain tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def like_global(local: torch.Tensor, like: torch.Tensor, placements=None):
    """``local`` as the local shard of a DTensor on ``like``'s mesh (with
    ``like``'s placements unless given); ``local`` itself when ``like`` is
    a plain tensor. A host shard on a card's mesh (a REMOTE leaf's) stays
    in host memory (:func:`_on_host`)."""
    if not _is_dtensor(like):
        return local
    placements = like.placements if placements is None else placements
    if local.device.type == "cpu" != like.device_mesh.device_type:
        return _on_host(local, like, placements)
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False)


def _on_host(local: torch.Tensor, like: DTensor, placements) -> DTensor:
    """``local`` (a host tensor) as the local shard of a DTensor on
    ``like``'s mesh and global shape. ``DTensor.from_local`` would move it
    to the mesh's device type: a REMOTE leaf's shard stays in host memory,
    and only the fetch engine moves it."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    spec = DTensorSpec(like.device_mesh, tuple(placements),
                       tensor_meta=TensorMeta(like.shape, like.stride(),
                                              local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _mesh_of(tree: Any):
    for _, t in _leaves_with_keys(tree):
        if _is_dtensor(t):
            return t.device_mesh
    return None


#: The stacked layer groups: their leaves' leading dim is the layer.
STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers")


def _path(name: str) -> list[str]:
    """The dict keys of a plan name (``"opt['m']['layers']['wq']"`` ->
    ``['layers', 'wq']``: a moment's keys are its parameter's)."""
    keys = re.findall(r"\['([^']*)'\]", name)
    if name.startswith("opt") and keys[:1] in (["m"], ["v"]):
        keys = keys[1:]
    return keys


def leaf_sharding(mesh, placements: tuple, *, tier: Tier,
                  config: TieringConfig, shape: tuple[int, ...],
                  stacked: bool) -> tuple[tuple, str]:
    """A leaf's placements and memory under ``config`` given its DOLMA
    tier: ``(placements, "device" | "host")``.

    ``host_offload`` keeps a REMOTE leaf's placements and puts each rank's
    local shard in host memory (pinned where
    :func:`supports_host_offload_spmd`). ``fsdp_stream`` splits a REMOTE
    leaf over ``config.fsdp_axis`` where it is whole on that axis: a
    stacked leaf on its layer dim when the axis divides it (and nothing
    else splits that dim), otherwise the first weight dim (past the layer
    dim; a matrix or larger) that nothing splits and the axis divides, as
    the reference's ``fsdp`` names pick one. A LOCAL leaf keeps its
    placements on the device."""
    placements = tuple(placements)
    if tier is not Tier.REMOTE:
        return placements, "device"
    if config.mode == "host_offload":
        return placements, "host"
    names = tuple(mesh.mesh_dim_names)
    if config.mode != "fsdp_stream" or config.fsdp_axis not in names:
        return placements, "device"
    m = names.index(config.fsdp_axis)
    n = mesh.shape[m]
    if n == 1 or placements[m] != Replicate():  # an axis of one splits nothing
        return placements, "device"
    split = {pl.dim for pl in placements if pl.is_shard()}
    lead = 1 if stacked else 0
    dims = [0] if stacked else []
    if len(shape) - lead >= 2:
        dims += list(range(lead, len(shape)))
    for d in dims:
        if d not in split and shape[d] % n == 0:
            return placements[:m] + (Shard(d),) + placements[m + 1:], "device"
    return placements, "device"


def supports_host_offload_spmd(mesh) -> bool:
    """Whether each rank's local shard of a REMOTE leaf can live in pinned
    host memory behind the copy stream: True on a CUDA mesh with a card,
    False on the CPU (whose shards stay ordinary host tensors) and on an
    abstract mesh (no devices), as the reference's probe answers on
    XLA-CPU."""
    return (getattr(mesh, "device_type", None) == "cuda"
            and torch.cuda.is_available())


def _placer(plan: PlacementPlan, prefix: str, dev: torch.device,
            config: TieringConfig, split: dict[str, str]):
    """The placement of each leaf of ``plan`` under ``prefix``; a leaf
    split over ``config.fsdp_axis`` is recorded in ``split``."""
    pin = dev.type == "cuda"

    def place(key: str, t: torch.Tensor) -> torch.Tensor:
        tier = plan.tier_of(prefix + key)
        if _is_dtensor(t):
            mesh = t.device_mesh
            pl, memory = leaf_sharding(
                mesh, t.placements, tier=tier, config=config,
                shape=tuple(t.shape),
                stacked=_path(prefix + key)[:1] in [[g] for g in STACKS])
            t = t.detach()
            if memory == "host":
                return like_global(host_tensor(t.to_local().to(
                    "cpu", copy=True), pin=supports_host_offload_spmd(mesh)),
                    t)
            if tuple(t.placements) == pl:
                return t
            split[prefix + key] = config.fsdp_axis
            return t.redistribute(mesh, pl)
        if tier is Tier.REMOTE and config.mode == "host_offload":
            # a copy: the train step writes REMOTE leaves back in place
            return _host_copy(t.detach(), pin)
        return t.detach().to(dev)

    return place


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A contiguous host copy of ``t``, pinned if ``pin``. A card's tensor
    is copied straight into pinned memory: a pageable copy on the way
    would hold the leaf twice in host memory (a full-width stacked expert
    weight is 7.5 GB)."""
    if pin and t.device.type == "cuda" and not is_traced(t):
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return host_tensor(t.to("cpu", copy=True), pin=pin)


def _unplanned(config: TieringConfig, tree: Any) -> bool:
    """Whether ``config`` places nothing: ``none``, or ``fsdp_stream``
    without a mesh (no peer to stream from)."""
    return config.mode == "none" or (
        config.mode == "fsdp_stream" and _mesh_of(tree) is None)


def _placed(plan: PlacementPlan, config: TieringConfig, dev: torch.device,
            **trees: Any) -> tuple[list, PlacementPlan]:
    """Each of ``trees`` (a plan prefix -> its tree) placed by ``plan``,
    and the plan with where its REMOTE leaves went: under ``fsdp_stream``
    the peers' HBM, and the leaves split there (``peer_split``)."""
    split: dict[str, str] = {}
    out = [map_leaves(_placer(plan, prefix, dev, config, split), tree)
           for prefix, tree in trees.items()]
    if config.mode == "fsdp_stream":
        plan = dataclasses.replace(plan, remote_medium="peer",
                                   peer_split=split)
    return out, plan


def _to(dev: torch.device):
    return lambda _k, t: t if _is_dtensor(t) else t.to(dev)


def place_params(params: Any, config: TieringConfig, *,
                 device: str | torch.device = "cuda",
                 ) -> tuple[Any, PlacementPlan | None]:
    """Put every leaf where ``config`` says; returns (params, plan).

    ``mode="none"`` (and ``fsdp_stream`` on plain tensors): every leaf on
    ``device``, no plan. Otherwise :func:`plan_for_params` decides and
    :func:`leaf_sharding` says where each leaf goes: under
    ``host_offload`` a REMOTE leaf (a DTensor's local shard) moves to host
    memory, pinned when ``device`` is a card; under ``fsdp_stream`` it is
    split over the mesh's ``fsdp_axis``; a LOCAL leaf goes to ``device``.
    """
    dev = resolve_device(device)
    if _unplanned(config, params):
        return map_leaves(_to(dev), params), None
    (params,), plan = _placed(plan_for_params(params, config=config), config,
                              dev, params=params)
    return params, plan


def place_state(params: Any, opt_state: Any, config: TieringConfig, *,
                device: str | torch.device = "cuda",
                ) -> tuple[Any, Any, PlacementPlan | None]:
    """:func:`place_params` over a train step's parameters *and* optimizer
    state, one plan for both: returns (params, opt_state, plan)."""
    dev = resolve_device(device)
    if _unplanned(config, params):
        return map_leaves(_to(dev), params), map_leaves(_to(dev),
                                                        opt_state), None
    (params, opt_state), plan = _placed(
        plan_for_params(params, config=config, opt_state=opt_state), config,
        dev, params=params, opt=opt_state)
    return params, opt_state, plan


def supports_host_offload(device: str | torch.device = "cuda") -> bool:
    """Whether a REMOTE tier on ``device`` is pinned host memory behind the
    copy stream of :class:`~repro_torch.core.exec.HostFetchEngine`: True on
    a card, False on the CPU (torch pins no memory without a card there, so
    a REMOTE leaf stays an ordinary host tensor).

    The reference probes JAX's default device for the ``pinned_host``
    memory kind; XLA's CPU backend accepts that kind, so the reference
    answers True on the CPU where the port answers False.
    """
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def host_names(plan: PlacementPlan | None) -> list[str]:
    """The plan's REMOTE leaves that live in host memory: all of them under
    ``host_offload``, none under ``fsdp_stream`` (peer HBM)."""
    if plan is None or plan.remote_medium != "host":
        return []
    return plan.remote_names()


def remote_keys(plan: PlacementPlan | None, prefix: str) -> frozenset[str]:
    """The keys, relative to ``prefix`` (``"params['layers']"``), of the
    plan's REMOTE leaves under it that live in host memory."""
    return frozenset(n[len(prefix):] for n in host_names(plan)
                     if n.startswith(prefix))


def peer_keys(plan: PlacementPlan | None, prefix: str) -> dict[str, str]:
    """The keys, relative to ``prefix``, of the leaves under it that
    :func:`place_state` split over a mesh axis into the peers' HBM
    (``fsdp_stream``'s REMOTE leaves), each with that axis: what
    :func:`tiered_scan` gathers layer by layer."""
    if plan is None:
        return {}
    return {n[len(prefix):]: a for n, a in plan.peer_split.items()
            if n.startswith(prefix)}


# ---------------------------------------------------------------------------
# autograd plumbing: the barrier and the gradients of REMOTE leaves
# ---------------------------------------------------------------------------

class _Barrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def grad_safe_barrier(x: Any) -> Any:
    """Identity on every tensor of ``x``, with an identity gradient.

    The reference's is a custom-VJP ``optimization_barrier`` between the
    saved carry and the layer body, which stops XLA hoisting a convert of
    the whole saved-carry stack out of the backward loop. Eager PyTorch
    runs ops in program order and has no scheduler to fence, so here it is
    a plain identity node; it is kept so that the layer loop has the
    reference's structure.
    """
    if isinstance(x, torch.Tensor):
        return _Barrier.apply(x) if x.requires_grad else x
    if isinstance(x, (tuple, list)):
        return type(x)(grad_safe_barrier(t) for t in x)
    if isinstance(x, dict):
        return {k: grad_safe_barrier(v) for k, v in x.items()}
    return x


class _RemoteLeaf(torch.autograd.Function):
    """Identity on a fetched tensor; its backward hands the gradient to a
    :class:`RemoteGrads`. ``anchor`` (a 0-d tensor that requires grad) is
    the input that puts the node on the backward's path."""

    @staticmethod
    def forward(ctx, t, anchor, sink, name, index, shape):
        ctx.sink, ctx.name, ctx.index, ctx.shape = sink, name, index, shape
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.sink.add(ctx.name, ctx.index, ctx.shape, g)
        return (None, torch.zeros((), dtype=torch.float32, device=g.device),
                None, None, None, None)


class RemoteGrads:
    """The gradients of a step's REMOTE leaves, accumulated on the device.

    :meth:`attach` wraps a fetched device tensor (a layer slice ``index``
    of the leaf ``name``, or the whole leaf with ``index=None``); in the
    backward its gradient is added into :attr:`grads` ``[name]``, a buffer
    of the leaf's full ``shape`` on the device, zeros where nothing arrived.
    Include :attr:`anchor` among the inputs of ``torch.autograd.grad`` so
    that the backward runs those nodes.
    """

    def __init__(self, device: str | torch.device):
        self.anchor = torch.zeros((), dtype=torch.float32,
                                  device=resolve_device(device),
                                  requires_grad=True)
        self.grads: dict[str, torch.Tensor] = {}

    def attach(self, name: str, index: int | None, t: torch.Tensor,
               shape: tuple[int, ...]) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return t
        return _RemoteLeaf.apply(t, self.anchor, self, name, index,
                                 tuple(shape))

    def add(self, name: str, index: int | None, shape: tuple[int, ...],
            g: torch.Tensor) -> None:
        buf = self.grads.get(name)
        if buf is None:
            buf = self.grads[name] = torch.zeros(shape, dtype=g.dtype,
                                                 device=g.device)
        if index is None:
            buf += g
        else:
            buf[index] += g

    def reset(self) -> None:
        self.grads = {}


class _Gathered(torch.autograd.Function):
    """Layer i of a stacked leaf split over a mesh axis, as a collective
    gathered it (``full``), attached to the rank's local shard ``local``:
    the backward puts this rank's part of the layer's gradient (which
    arrives whole: the DTensor around ``full`` is replicated on that axis)
    into a zero gradient of the shard, as indexing a local leaf does."""

    @staticmethod
    def forward(ctx, local, full, scatter):
        ctx.scatter = scatter
        ctx.like = (local.shape, local.dtype, local.device)
        return full.view_as(full)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        grad = torch.zeros(shape, dtype=dtype, device=device)
        ctx.scatter(grad, g)
        return grad, None, None


def split_on(t: torch.Tensor, axis: str) -> bool:
    """Whether ``t`` is a DTensor split over the mesh axis ``axis``."""
    return (_is_dtensor(t) and axis in (t.device_mesh.mesh_dim_names or ())
            and t.placements[t.device_mesh.mesh_dim_names.index(axis)]
            .is_shard())


def _slice_placements(placements, m: int) -> tuple:
    """A stacked leaf's placements for one layer of it: mesh dim ``m``
    gathered, every other split one dim lower."""
    out = []
    for j, pl in enumerate(placements):
        if j == m or not pl.is_shard():
            out.append(Replicate() if j == m else pl)
        elif pl.dim == 0:
            raise ValueError("tiered_scan: a stacked leaf's layer dim is split "
                             "over a mesh axis other than the gathered one")
        else:
            out.append(Shard(pl.dim - 1))
    return tuple(out)


#: Collectives posted by :func:`_post_gather`, by kind (``"broadcast"``:
#: a layer of a leaf split on its layer dim; ``"all_gather"``: a layer of
#: a leaf split on a weight dim). On an axis of one nothing is split, so
#: nothing is posted.
GATHERS: collections.Counter = collections.Counter()


def _scatter_row(grad: torch.Tensor, g: torch.Tensor, j: int,
                 owns: bool) -> None:
    """A broadcast layer's gradient ``g`` into row ``j`` of the owner's
    shard gradient ``grad`` (the other ranks' shards hold no part of it)."""
    if owns:
        grad[j] = g


def _scatter_part(grad: torch.Tensor, g: torch.Tensor, i: int, d: int,
                  r: int, c: int) -> None:
    """Rank ``r``'s part (``c`` wide on dim ``d``) of an all-gathered
    layer's gradient ``g`` into row ``i`` of its shard gradient ``grad``."""
    grad[i] = g.narrow(d, r * c, c)


def _post_gather(t: torch.Tensor, i: int, axis: str):
    """Post the collective that gathers layer ``i`` of the stacked DTensor
    ``t`` over the mesh axis ``axis``: a broadcast from the rank holding
    that layer where the axis splits the layer dim, an all-gather of every
    rank's part otherwise. Returns ``acquire() -> DTensor``: it waits on
    the collective's work handle and gives the layer, replicated on
    ``axis``."""
    import torch.distributed as dist

    mesh = t.device_mesh
    m = mesh.mesh_dim_names.index(axis)
    group, r, n = mesh.get_group(m), mesh.get_local_rank(m), mesh.shape[m]
    d = t.placements[m].dim
    local = t.to_local()
    data = local.detach()
    if d == 0:
        GATHERS["broadcast"] += 1
        per = data.shape[0]
        owner, j = divmod(i, per)
        buf = (data[j].contiguous() if r == owner else
               torch.empty(data.shape[1:], dtype=data.dtype,
                           device=data.device))
        work = dist.broadcast(buf, src=dist.get_global_rank(group, owner),
                              group=group, async_op=True)

        def scatter(grad, g):
            _scatter_row(grad, g, j, r == owner)

        def full():
            return buf
    else:
        GATHERS["all_gather"] += 1
        part = data[i].contiguous()
        out = torch.empty((n, *part.shape), dtype=data.dtype,
                          device=data.device)
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        work = gather(out.flatten(0, 1), part, group=group, async_op=True)
        c = part.shape[d - 1]

        def scatter(grad, g):
            _scatter_part(grad, g, i, d - 1, r, c)

        def full():
            return out.movedim(0, d - 1).reshape(
                *part.shape[:d - 1], n * c, *part.shape[d:])

    pl = _slice_placements(t.placements, m)

    def acquire():
        work.wait()
        return like_global(_Gathered.apply(local, full(), scatter), t, pl)

    return acquire


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------

def _block_split(n_layers: int) -> tuple[int, int]:
    """Factor ``n_layers = n_outer * n_inner`` minimizing ``n_outer + n_inner``.

    ``n_outer`` is the number of checkpointed blocks (the carries saved
    across the forward), ``n_inner`` the layers per block (the transient
    recompute depth of one block's backward). Only exact factorizations:
    a prime depth degenerates to ``(1, n_layers)``, one block.
    ``n_outer <= n_inner`` by construction.
    """
    if n_layers < 1:
        raise ValueError(f"_block_split: n_layers must be >= 1, got {n_layers}")
    best = (1, n_layers)
    for n_outer in range(1, int(n_layers ** 0.5) + 1):
        if n_layers % n_outer == 0:
            n_inner = n_layers // n_outer
            if n_outer + n_inner < best[0] + best[1]:
                best = (n_outer, n_inner)
    assert best[0] * best[1] == n_layers, (
        f"_block_split produced ragged blocking {best} for depth {n_layers}")
    return best


def _check_stack_depth(stacked: Any, n_layers: int) -> None:
    leads = {t.shape[0] for _, t in _leaves_with_keys(stacked) if t.ndim >= 1}
    if leads and leads != {n_layers}:
        raise ValueError(
            f"tiered_scan: stacked_params leading dims {sorted(leads)} do not "
            f"all equal n_layers={n_layers}; the scan would silently "
            "mis-block. Slice or restack the params to the depth you scan.")


def _unflatten(flat: dict[str, torch.Tensor], tree: Any, key: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(flat, v, f"{key}[{k!r}]") for k, v in tree.items()}
    return flat[key]


def _skeleton(x: Any, flat: list[torch.Tensor]) -> Any:
    """``x`` with each tensor appended to ``flat`` and replaced by its
    index there."""
    if isinstance(x, torch.Tensor):
        flat.append(x)
        return len(flat) - 1
    if isinstance(x, (tuple, list)):
        return type(x)(_skeleton(s, flat) for s in x)
    if isinstance(x, dict):
        return {k: _skeleton(v, flat) for k, v in x.items()}
    raise TypeError(f"tiered_scan: carry leaf of type {type(x)}")


def _rebuild(skel: Any, ts) -> Any:
    if isinstance(skel, int):
        return ts[skel]
    if isinstance(skel, (tuple, list)):
        return type(skel)(_rebuild(s, ts) for s in skel)
    return {k: _rebuild(v, ts) for k, v in skel.items()}


def _checkpointed(fn: Callable, policy: Callable | None, *args) -> Any:
    """``fn(*args)`` under a non-reentrant checkpoint, every tensor of
    ``args`` passed as a top-level argument: a checkpoint saves (through the
    saved-tensor hooks of an enclosing checkpoint, which drop them) only
    its top-level tensor arguments. ``policy`` is a checkpoint
    ``context_fn`` (None saves nothing inside)."""
    # module-level helpers: a recursive closure would hold the tensors in a
    # reference cycle, alive past the forward until the garbage collector
    flat: list[torch.Tensor] = []
    skel = _skeleton(list(args), flat)
    kw = {} if policy is None else {"context_fn": policy}
    return checkpoint(lambda *ts: fn(*_rebuild(skel, ts)), *flat,
                      use_reentrant=False, **kw)


def tiered_scan(
    layer_fn: Callable[..., Any],
    carry: Any,
    stacked_params: Any,
    *,
    n_layers: int,
    remat: bool = False,
    policy: Callable | None = None,
    prefetch: bool = True,
    remote: frozenset[str] = frozenset(),
    engine: HostFetchEngine | None = None,
    min_layers: int = 12,
    remote_carry_fn: Callable[[Any], Any] | None = None,
    with_index: bool = False,
    grads: RemoteGrads | None = None,
    prefix: str = "",
    peer: Mapping[str, str] | None = None,
):
    """Run ``layer_fn(carry, layer_params)`` over ``n_layers`` stacked layers
    (``layer_fn(carry, layer_params, i)`` with ``with_index``, so that a
    recompute of any layer sees its own index).

    ``stacked_params``: nested dicts whose leaves have leading dim
    ``n_layers``. The leaves named in ``remote`` (keys as ``keystr`` gives
    them) are REMOTE: layer i's slice of each is copied to the device
    through ``engine``; the others are indexed where they lie. With
    ``grads``, each fetched slice is attached to it under the name
    ``prefix + key`` (see :class:`RemoteGrads`).

    ``prefetch=True`` is the dual buffer: layer i+1's fetch is posted before
    layer i computes, so the copy runs on the copy stream while the layer's
    kernels run on the compute stream; :meth:`HostFetchEngine.acquire`
    makes the compute stream wait for the copy just before first use.
    ``prefetch=False`` fetches each layer just before it computes. Both move
    the same bytes and compute the same values.

    ``remat=True`` composes that with two-level (sqrt-L) checkpointing:
    ``n_outer`` blocks of ``n_inner`` layers (:func:`_block_split`), each
    block checkpointed and each layer checkpointed inside it, ``policy``
    the checkpoints' ``context_fn`` (None: nothing saved inside). The
    fetches sit inside the boundaries: a recompute re-issues them and no
    fetched tensor is saved across the forward; under ``prefetch`` the dual
    buffer runs inside each block (a block's first fetch is not overlapped).
    Depths below ``min_layers`` checkpoint each layer alone (``n_outer =
    n_layers``). ``remote_carry_fn`` is applied to each saved block carry
    (:func:`remote_carry_placer`).

    Under a device mesh the leaves are DTensors. A REMOTE leaf's slice is
    this rank's local shard, copied as above and made a DTensor again. The
    leaves named in ``peer`` (key -> mesh axis, :func:`peer_keys` of an
    ``fsdp_stream`` plan) live split over that axis in the peers' HBM:
    each is gathered layer by layer with an asynchronous collective
    (:func:`_post_gather`), posted where a host copy is posted and waited
    on where a host copy is acquired; prefetch on and off run the same
    collectives on the same data.
    """
    _check_stack_depth(stacked_params, n_layers)
    leaves = dict(_leaves_with_keys(stacked_params))
    peer = dict(peer or {})
    unknown = (remote | peer.keys()) - leaves.keys()
    if unknown:
        raise ValueError(f"tiered_scan: remote leaves {sorted(unknown)} are "
                         f"not in stacked_params")
    if remote and engine is None:
        raise ValueError("tiered_scan: remote leaves need a HostFetchEngine")

    whole = sorted(k for k, a in peer.items() if not split_on(leaves[k], a))
    if whole:
        raise ValueError(f"tiered_scan: peer leaves {whole} are not split "
                         f"over their mesh axes")

    def post(i: int):
        fut = None
        if remote:
            fut = engine.fetch(f"layer{i}", {
                k: local_part(leaves[k]).detach()[i] for k in remote},
                pace=False)
        return fut, {k: _post_gather(leaves[k], i, peer[k])
                     for k in sorted(peer)}

    def layer(i: int, posted) -> Any:
        fut, pending = posted
        flat = {k: t[i] for k, t in leaves.items()
                if k not in remote and k not in peer}
        if fut is not None:
            got = engine.acquire(fut)
            for k, t in got.items():
                like = leaves[k]
                if grads is not None:
                    t = grads.attach(prefix + k, i, t,
                                     local_part(like).shape)
                if _is_dtensor(like):
                    t = like_global(t, like,
                                    _slice_placements(like.placements, -1))
                flat[k] = t
        flat.update({k: acquire() for k, acquire in pending.items()})
        return _unflatten(flat, stacked_params)

    def call(c, p, i: int):
        return layer_fn(c, p, i) if with_index else layer_fn(c, p)

    if not remat:
        nxt = post(0) if prefetch else None
        for i in range(n_layers):
            if prefetch:
                cur, nxt = nxt, (post(i + 1) if i + 1 < n_layers else None)
            else:
                cur = post(i)
            carry = call(carry, layer(i, cur), i)
        return carry

    n_outer, n_inner = ((n_layers, 1) if n_layers < min_layers
                        else _block_split(n_layers))

    def layer_at(c, i: int):
        """One checkpointed layer that fetches its own weights: the fetch
        is re-issued when its backward recomputes it."""
        return call(grad_safe_barrier(c), layer(i, post(i)), i)

    def layer_with(c, p, i: int):
        """One checkpointed layer, its weights fetched by the block."""
        return call(grad_safe_barrier(c), p, i)

    def block(c, start: int):
        """Layers [start, start + n_inner), inside one block boundary."""
        if not prefetch or n_inner == 1:
            for j in range(n_inner):
                c = _checkpointed(functools.partial(layer_at, i=start + j),
                                  policy, c)
            return c
        # the dual buffer inside the boundary: every fetch is recomputed in
        # the block's backward, none saved across the forward
        nxt = post(start)
        for j in range(n_inner):
            i = start + j
            cur, nxt = nxt, (post(i + 1) if j + 1 < n_inner else None)
            c = _checkpointed(functools.partial(layer_with, i=i), policy, c,
                              layer(i, cur))
        return c

    if remote_carry_fn is not None:
        carry = remote_carry_fn(carry)  # the first carry is saved too
    for g in range(n_outer):
        if n_inner > 1:
            carry = _checkpointed(
                functools.partial(block, start=g * n_inner), policy, carry)
        else:  # flat: one checkpoint level, the layer's own
            carry = block(carry, g * n_inner)
        if remote_carry_fn is not None:
            carry = remote_carry_fn(carry)
    return carry


def remote_carry_placer(mesh: Any, config: TieringConfig | None = None, *,
                        spec_fn: Callable | None = None,
                        ) -> Callable[[Any], Any] | None:
    """A ``remote_carry_fn`` that places saved block carries on the remote
    tier; ``None`` without a mesh, as the reference's single-host case.

    Under a mesh each saved carry leaf of two or more dims (a DTensor) is
    redistributed to the placements of its logical spec, ``spec_fn(leaf)``
    (a :class:`~repro_torch.models.sharding.P`; replicated by default):
    split over the batch and sequence axes, each rank keeps only its share
    of the saved activations, the peers' HBM as the remote tier (the
    reference's ``fsdp_stream`` realization). The reference moves them to
    pinned host memory where XLA's partitioner accepts that memory kind;
    the port keeps them on the devices."""
    if mesh is None:
        return None
    from repro_torch.models.sharding import P, to_placements

    def place_leaf(leaf):
        if not _is_dtensor(leaf) or leaf.ndim < 2:  # scalars, small aux
            return leaf
        spec = spec_fn(leaf) if spec_fn is not None else P(
            *([None] * leaf.ndim))
        placements = to_placements(spec, mesh)
        if tuple(leaf.placements) == placements:
            return leaf
        return leaf.redistribute(mesh, placements)

    def place(c):
        if isinstance(c, (tuple, list)):
            return type(c)(place(x) for x in c)
        if isinstance(c, dict):
            return {k: place(v) for k, v in c.items()}
        return place_leaf(c)

    return place


# ---------------------------------------------------------------------------
# deprecated shims, as in the reference: both scans are tiered_scan
# ---------------------------------------------------------------------------

def prefetch_scan(layer_fn, carry, stacked_params, *, n_layers: int,
                  prefetch: bool = True):
    """Deprecated: use :func:`tiered_scan` (``remat=False``)."""
    return tiered_scan(layer_fn, carry, stacked_params, n_layers=n_layers,
                       remat=False, prefetch=prefetch)


def blocked_remat_scan(layer_fn, carry, stacked_params, *, n_layers: int,
                       policy=None, min_layers: int = 12):
    """Deprecated: use :func:`tiered_scan` (``remat=True``)."""
    return tiered_scan(layer_fn, carry, stacked_params, n_layers=n_layers,
                       remat=True, policy=policy, prefetch=False,
                       min_layers=min_layers)
