"""Logical-axis sharding rules over a torch ``DeviceMesh``.

A port of ``repro.models.sharding``, with the same names. Model code
annotates tensors with *logical* axis names; this module resolves them to
physical mesh axes through a mutable rule table (:data:`DEFAULT_RULES`,
:func:`use_rules`), dropping any physical axis that does not divide the
dimension and using each axis at most once per spec, as the reference does.

JAX's ``NamedSharding`` becomes a DTensor's placements:

* a spec (:class:`P`, a tuple of entries as in JAX's ``PartitionSpec``)
  maps *tensor* dims to mesh axes; :func:`to_placements` turns it into one
  placement per *mesh* dim, ``Shard(d)`` or ``Replicate()``. A spec entry
  that lists two axes for one dim becomes two mesh dims that both shard
  ``d``. DTensor splits such a dim in mesh-dim order, where JAX splits it in
  the entry's order: the two agree whenever the entry lists the axes in the
  mesh's order (``batch``'s ``("pod", "data")``); they differ only in which
  rank holds which block, never in the values of the whole tensor;
* :func:`constrain` (``with_sharding_constraint``) is the identity without a
  mesh and ``redistribute`` on a DTensor under one. A plain tensor under a
  mesh raises: a tensor that left the mesh is a bug, not a replica;
* :func:`distribute_tree` is the reference dry-run's ``device_put`` of a
  tree onto its spec tree.

:func:`abstract_mesh` is a mesh with only a ``shape`` (no process group),
so that specs resolve at production sizes on one process.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Sequence

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

# Logical axis -> physical mesh axis (or tuple of axes). None = replicated.
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),     # global batch
    "seq": None,                  # sequence inside attention blocks
    "seq_sp": "model",            # sequence-parallel activation storage
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ff": None,
    "d_model": None,
    "layers": None,               # stacked-layer dim; "data" => FSDP streaming
    # decode KV-cache length: takes whatever batch left free ('model' when
    # KV heads don't divide it; both axes at batch=1 long-context)
    "kv_len": ("model", "data"),
    "state": None,                # SSM state dim
    "fsdp": None,                 # weight non-model dim; "data" => FSDP (ZeRO-3)
}


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated), a
    mesh axis name, or a tuple of axis names, as JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class _Rules:
    """The rules and mesh in force, process-wide. The reference keeps them
    per thread; here the autograd engine recomputes checkpointed layers in
    a thread of its own on a card, and that recompute must resolve the
    same specs as the forward did."""

    def __init__(self):
        self.rules = dict(DEFAULT_RULES)
        self.mesh = None


_ctx = _Rules()


def get_rules() -> dict:
    return dict(_ctx.rules)


@contextlib.contextmanager
def use_rules(**overrides):
    old = dict(_ctx.rules)
    _ctx.rules.update(overrides)
    try:
        yield
    finally:
        _ctx.rules = old


@contextlib.contextmanager
def use_mesh(mesh):
    old = _ctx.mesh
    _ctx.mesh = mesh
    try:
        yield
    finally:
        _ctx.mesh = old


def current_mesh():
    return _ctx.mesh


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only: enough to resolve specs, no devices."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of an :class:`AbstractMesh` or a DeviceMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _physical(axes, shape: dict[str, int]) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in shape)


def resolve_spec(shape: Sequence[int], names: Sequence[str | None],
                 mesh=None) -> P:
    """Logical names -> :class:`P`, dropping non-dividing axes."""
    mesh = mesh or _ctx.mesh
    if mesh is None:
        return P(*([None] * len(names)))
    if len(shape) != len(names):
        raise ValueError(f"shape rank {len(shape)} != names {names}")
    sizes = mesh_shape(mesh)
    entries = []
    used: set[str] = set()  # a mesh axis may appear at most once per spec
    for dim, name in zip(shape, names):
        if name is None:
            entries.append(None)
            continue
        group = 1
        kept = []
        for a in _physical(_ctx.rules.get(name), sizes):
            if a not in used and dim % (group * sizes[a]) == 0:
                kept.append(a)
                group *= sizes[a]
        used.update(kept)
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    return P(*entries)


def to_placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` for the tensor dim
    ``d`` whose spec entry names that axis, ``Replicate()`` otherwise. An
    axis of size one splits nothing, and its placement is ``Replicate()``:
    the same layout, which every DTensor op takes without redistributing."""
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of and n > 1 else Replicate()
                 for a, n in zip(mesh.mesh_dim_names, mesh.shape))


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local_shape_and_offset(shape: Sequence[int], mesh,
                           placements: Sequence) -> tuple[tuple, tuple]:
    """This rank's shard of a tensor of ``shape`` laid out by
    ``placements``: (its shape, its offset in the whole). Host arithmetic
    on the rank's mesh coordinate, kept out of a trace's fake mode (which
    would take its integers for data)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(shape, mesh, placements)


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """``x`` redistributed to its logical spec under the current mesh and
    rules; the identity with no mesh."""
    mesh = _ctx.mesh
    if mesh is None:
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"constrain{names}: a plain {tuple(x.shape)} tensor under a "
            f"device mesh; every activation under a mesh is a DTensor")
    placements = to_placements(resolve_spec(x.shape, names, mesh), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


class NamedSharding:
    """A mesh and one placement per mesh dim: where a DTensor lies (JAX's
    ``NamedSharding``, with placements for its spec)."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh, placements: Sequence):
        self.mesh, self.placements = mesh, tuple(placements)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.placements})"


def named_sharding(shape: Sequence[int], names: Sequence[str | None],
                   mesh=None) -> NamedSharding | None:
    """The :class:`NamedSharding` of a tensor of ``shape`` with logical
    ``names``; None without a mesh."""
    mesh = mesh or _ctx.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, to_placements(resolve_spec(shape, names, mesh),
                                             mesh))


def sharding_tree(pspec_tree: Any, mesh) -> Any:
    """A spec tree as a tree of :class:`NamedSharding` on ``mesh`` (what
    ``CheckpointManager.restore(shardings=)`` takes)."""
    return _map_with_path(
        lambda _p, spec: NamedSharding(mesh, to_placements(spec, mesh)),
        pspec_tree)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor every rank computed alike: positions, masks, scale
    factors) as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor; ``t`` itself otherwise."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


#: Calls through :func:`local_call` by name (``"flash"``, ``"ssd"``,
#: ``"moe_ep"``): on a card each such call launches its kernel on the local
#: shards, so a kernel's launches under a mesh equal its name's count.
LOCAL_MAP_CALLS: collections.Counter = collections.Counter()


def local_call(name: str, fn, args: Sequence[torch.Tensor],
               in_placements: Sequence[Sequence], out_placements, mesh, *,
               in_grad_placements: Sequence[Sequence] | None = None):
    """``fn`` on each rank's local shards of the DTensors ``args`` (the
    counterpart of ``shard_map``): each argument is first redistributed
    to its ``in_placements`` (explicitly, so that no op falls back to
    gathering a whole operand); the outputs are DTensors with
    ``out_placements`` (one output's placements, or a tuple of them).

    An argument replicated on a mesh dim that splits an output feeds every
    rank's share of that output, so each rank's gradient of it is only its
    share of the sum: by default its gradient's placement there is
    ``Partial()``, and the argument's own placement elsewhere.
    ``in_grad_placements`` overrides that, for a ``fn`` that reduces such
    gradients itself."""
    from torch.distributed.tensor.experimental import local_map

    LOCAL_MAP_CALLS[name] += 1
    args = [a if tuple(a.placements) == tuple(p) else a.redistribute(mesh, p)
            for a, p in zip(args, in_placements)]
    in_p = tuple(tuple(p) for p in in_placements)
    single = bool(out_placements) and isinstance(out_placements[0], Placement)
    outs = [tuple(out_placements)] if single else [
        tuple(p) for p in out_placements if p is not None]
    if in_grad_placements is None:
        split = [any(o[i].is_shard() for o in outs) for i in range(mesh.ndim)]
        in_grad_placements = tuple(
            tuple(Partial() if split[i] and pl == Replicate() else pl
                  for i, pl in enumerate(p)) for p in in_p)
    # local_map takes one output's placements as a list, several as a tuple
    out_p = list(outs[0]) if single else tuple(
        None if p is None else list(p) for p in out_placements)
    return local_map(fn, out_placements=out_p, in_placements=in_p,
                     in_grad_placements=tuple(map(tuple, in_grad_placements)),
                     device_mesh=mesh)(*args)


# ---------------------------------------------------------------------------
# parameter / batch / cache logical-name assignment
# ---------------------------------------------------------------------------

# last path key -> logical names of the *core* (unstacked) rank
_PARAM_CORE_NAMES: dict[str, tuple] = {
    "wq": (None, "heads"),
    "wk": (None, "kv_heads"),
    "wv": (None, "kv_heads"),
    "wo": ("heads", None),
    "w_down": ("ff", None),
    "embedding": ("vocab", None),
    "router": (None, None),
    "wq_a": (None, None),
    "wq_b": (None, "heads"),
    "wkv_a": (None, None),
    "wkv_b": (None, "heads"),
    "in_proj": (None, None),
    "out_proj": (None, None),
    "conv_w": (None, None),
    "proj": (None, None),
}


def param_logical_names(path: Sequence[str], leaf_ndim: int, *,
                        expert_sharding: str = "expert", fsdp: bool = False):
    """Logical names for one parameter leaf, given its dict keys from the
    root (``("layers", "attn", "wq")``).

    With ``fsdp=True`` every replicated core dim of a matrix weight is named
    'fsdp' (rule-mapped to the data axis): the weight is ZeRO-3 sharded and
    gathered layer by layer, the distributed form of DOLMA's remote-object
    streaming.
    """
    keys = list(path)
    last = keys[-1] if keys else ""
    in_moe = "moe" in keys and last in ("w_gate", "w_up", "w_down")

    if in_moe:
        if last == "w_down":
            core = (("expert", None, None) if expert_sharding == "expert"
                    else (None, "ff", None))
        else:
            core = (("expert", None, None) if expert_sharding == "expert"
                    else (None, None, "ff"))
    elif last in ("w_gate", "w_up"):
        core = (None, "ff")
    elif last in _PARAM_CORE_NAMES:
        core = _PARAM_CORE_NAMES[last]
    else:
        core = tuple([None] * min(leaf_ndim, 2))

    extra = leaf_ndim - len(core)
    if extra < 0:  # scalar / vector leaf (norm scales etc.)
        return tuple([None] * leaf_ndim)
    if fsdp and len(core) >= 2:
        # every replicated core dim is an fsdp candidate; resolve_spec's
        # divisibility and one-axis-per-spec rules pick the dims that work
        core = tuple("fsdp" if c is None else c for c in core)
    lead = (["layers"] + [None] * (extra - 1)) if extra >= 1 else []
    return tuple(lead) + core


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """Nested dicts ``tree`` with each leaf ``x`` replaced by ``fn(path,
    x)``, ``path`` the dict keys from the root; a dataclass node (an int8
    moment) keeps its type, each field's name appended to the path."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name),
                                   path + (_Attr(f.name),))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


class _Attr(str):
    """A dataclass field's name in a path (JAX's ``GetAttrKey``), apart
    from the dict keys."""


def _dict_keys(path: tuple) -> list[str]:
    return [k for k in path if not isinstance(k, _Attr)]


# decode-cache leaf name -> logical names (rank-matched at resolution)
_CACHE_CORE_NAMES: dict[str, tuple] = {
    "k": ("layers", "batch", "kv_len", "kv_heads", None),
    "v": ("layers", "batch", "kv_len", "kv_heads", None),
    "shared_k": ("layers", "batch", "kv_len", "kv_heads", None),
    "shared_v": ("layers", "batch", "kv_len", "kv_heads", None),
    "ck": ("layers", "batch", None, "kv_heads", None),
    "cv": ("layers", "batch", None, "kv_heads", None),
    "c": ("layers", "batch", "kv_len", None),
    "kr": ("layers", "batch", "kv_len", None),
    "conv": ("layers", "batch", None, None),
    "state": ("layers", "batch", "heads", None, None),
    "pos": (),
}


def cache_pspec_tree(cache: Any, mesh=None) -> Any:
    """Spec tree for a decode cache."""
    def spec_of(path, leaf):
        keys = _dict_keys(path)
        last = keys[-1] if keys else ""
        names = _CACHE_CORE_NAMES.get(last, tuple([None] * len(leaf.shape)))
        if len(names) != len(leaf.shape):
            names = tuple([None] * len(leaf.shape))
        return resolve_spec(leaf.shape, names, mesh)

    return _map_with_path(spec_of, cache)


def batch_pspec_tree(batch: Any, mesh=None) -> Any:
    """Spec tree for a train/prefill batch."""
    def spec_of(_path, leaf):
        names = ("batch",) + tuple([None] * (len(leaf.shape) - 1))
        return resolve_spec(leaf.shape, names, mesh)

    return _map_with_path(spec_of, batch)


def opt_pspec_tree(opt: Any, params_pspecs: Any, mesh=None) -> Any:
    """Specs for an optimizer state tree (moments mirror their params).

    An int8 moment (``QTensor``): ``codes`` shares the parameter's spec
    (same shape); ``scale`` (last dim = blocks) keeps the leading entries
    and replicates its last dim. Every leaf outside ``m`` and ``v`` (the
    step count, the error-feedback buffer) gets the empty spec, as in the
    reference.
    """
    by_path: dict[tuple, P] = {}
    _map_with_path(lambda path, spec: by_path.__setitem__(path, spec),
                   params_pspecs)

    def spec_of(path, leaf):
        if not path or path[0] not in ("m", "v"):
            return P()
        sub, attr = path[1:], None
        if sub and isinstance(sub[-1], _Attr):
            sub, attr = sub[:-1], str(sub[-1])
        base = by_path.get(tuple(sub))
        if base is None:
            return P(*([None] * len(leaf.shape)))
        if attr == "scale":
            entries = tuple(base)[: len(leaf.shape) - 1]
            return P(*(entries + (None,) * (len(leaf.shape) - len(entries))))
        return base

    return _map_with_path(spec_of, opt)


def shard_factor(spec: Sequence, mesh) -> int:
    sizes = mesh_shape(mesh)
    f = 1
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            f *= sizes[a]
    return f


def params_pspec_tree(params: Any, *, expert_sharding: str = "expert",
                      fsdp: bool = False, mesh=None) -> Any:
    """Spec tree for a params tree (of tensors, meta tensors included)."""
    def spec_of(path, leaf):
        names = param_logical_names(_dict_keys(path), len(leaf.shape),
                                    expert_sharding=expert_sharding,
                                    fsdp=fsdp)
        return resolve_spec(leaf.shape, names, mesh)

    return _map_with_path(spec_of, params)


def distribute_tree(tree: Any, pspec_tree: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` with the placements
    of its spec in ``pspec_tree`` (the same structure). Each rank keeps its
    own block of the tensor it holds, with no communication: every rank
    must hold the same values, as a seeded init or a restore gives them."""
    specs: dict[tuple, P] = {}
    _map_with_path(lambda path, s: specs.__setitem__(path, s), pspec_tree)

    def put(path, leaf):
        placements = to_placements(specs[path], mesh)
        if is_dtensor(leaf):
            return leaf.redistribute(mesh, placements)
        return distribute_tensor(leaf, mesh, placements, src_data_rank=None)

    return _map_with_path(put, tree)
