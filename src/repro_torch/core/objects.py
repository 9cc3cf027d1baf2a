"""Data objects and the object catalog.

DOLMA (§3.2, §4.1) reasons about memory at *data object* granularity: a
named tensor of the program — a parameter, an optimizer moment, a saved
activation, a KV-cache page, an input. The :class:`ObjectCatalog` holds, for
every object, the statistics the paper's allocator interposition would
observe at runtime: size in bytes, read and write counts, and lifetime in
iterations. It is the quantitative basis on which
:mod:`repro_torch.core.placement` applies the paper's three ranking rules.

A copy of ``repro.core.objects`` for this package. ``from_pytree`` walks
nested dicts (and lists/tuples) of torch tensors or numpy arrays and names
the leaves as ``jax.tree_util.keystr`` does (``['a']['b']``);
``from_step_fn`` takes the access census of one eager run of a step
function (see there for how its read counts relate to the reference's).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class ObjectKind(enum.Enum):
    PARAM = "param"
    OPT_STATE = "opt_state"
    ACTIVATION = "activation"
    KV_CACHE = "kv_cache"
    INPUT = "input"
    OUTPUT = "output"
    SCRATCH = "scratch"
    # one routed expert's (w_gate, w_up, w_down) slab: a PARAM by lifetime
    # but cold-skewed by access (top-k of E per token)
    EXPERT = "expert"


# The paper's small/large boundary (§3.2, §4.1): one OS page.
SMALL_OBJECT_BYTES = 4 * 1024


def itemsize(dtype: Any) -> int:
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


@dataclasses.dataclass
class DataObject:
    """One named data object and its observed access statistics."""

    name: str
    shape: tuple[int, ...]
    dtype: Any                  # a torch.dtype or anything np.dtype accepts
    kind: ObjectKind = ObjectKind.PARAM
    n_reads: int = 0
    n_writes: int = 0
    # Lifetime in iterations (paper Fig 5): 0 = dies within one iteration,
    # math.inf = lives for the whole program (params, persistent state).
    lifetime_iters: float = math.inf
    pinned_local: bool = False  # hard pin (e.g. metadata region, RNG keys)
    # the mirror pin: the object's authoritative copy lives in the remote
    # pool by construction; the placement policy demotes it unconditionally
    pinned_remote: bool = False
    # simulated logical size (paper-scale modeling); 0 => real array size
    sim_bytes: int = 0

    @property
    def size_bytes(self) -> int:
        if self.sim_bytes:
            return self.sim_bytes
        return int(np.prod(self.shape, dtype=np.int64)) * itemsize(self.dtype)

    @property
    def n_accesses(self) -> int:
        return self.n_reads + self.n_writes

    @property
    def write_ratio(self) -> float:
        total = self.n_accesses
        return self.n_writes / total if total else 0.0

    @property
    def is_small(self) -> bool:
        return self.size_bytes <= SMALL_OBJECT_BYTES

    @property
    def is_short_lived(self) -> bool:
        return self.lifetime_iters < 1


def _leaves_with_keys(tree: Any, key: str = "") -> Iterator[tuple[str, Any]]:
    """Depth-first leaves of nested dicts/lists/tuples, keyed like
    ``jax.tree_util.keystr``: ``['name']`` for a dict key, ``[i]`` for a
    sequence index. Dict keys are visited in sorted order, as JAX does."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], f"{key}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_keys(sub, f"{key}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        # a registered dataclass node (the optimizer's QTensor): its fields
        # in declaration order, keyed ``.name`` as keystr keys attributes
        for f in dataclasses.fields(tree):
            yield from _leaves_with_keys(getattr(tree, f.name),
                                         f"{key}.{f.name}")
    elif tree is not None:
        yield key, tree


class ObjectCatalog:
    """A census of data objects, as DOLMA's interposed allocator would build."""

    def __init__(self, objects: Iterable[DataObject] = ()):  # noqa: D107
        self._objects: dict[str, DataObject] = {}
        for obj in objects:
            self.add(obj)

    # -- construction -----------------------------------------------------
    def add(self, obj: DataObject) -> None:
        if obj.name in self._objects:
            raise ValueError(f"duplicate data object {obj.name!r}")
        self._objects[obj.name] = obj

    @classmethod
    def from_pytree(
        cls,
        tree: Any,
        *,
        prefix: str = "",
        kind: ObjectKind = ObjectKind.PARAM,
    ) -> "ObjectCatalog":
        """Catalog the leaves of nested containers (sizes only)."""
        catalog = cls()
        for key, leaf in _leaves_with_keys(tree):
            catalog.add(
                DataObject(
                    name=prefix + key,
                    shape=tuple(getattr(leaf, "shape", ())),
                    dtype=getattr(leaf, "dtype", torch.float32),
                    kind=kind,
                )
            )
        return catalog

    @classmethod
    def from_step_fn(
        cls,
        step_fn: Callable[..., Any],
        *args: Any,
        kinds: Sequence[ObjectKind] | None = None,
        donate_argnums: Sequence[int] = (),
    ) -> "ObjectCatalog":
        """Run ``step_fn(*args)`` once and recover per-leaf access statistics.

        ``kinds[i]`` labels every leaf of ``args[i]``; leaves are named
        ``arg{i}`` plus their keystr. Donated arguments are read+written
        (in-place update across iterations), as a training step's params
        and optimizer state are; optimizer state is written too. Params,
        optimizer state and KV caches live for the whole program, the
        rest for one iteration. These are the reference's rules.

        ``n_reads`` is a census of the run, with no tracer: a
        :class:`TorchDispatchMode` counts, for each leaf, the ATen ops
        whose tensor arguments share its storage (a view of it included),
        one per occurrence, as the reference counts one per jaxpr
        equation input; view and alias ops themselves (``view``,
        ``t``, ``select``, ``detach``, ...) are not reads. It runs eagerly
        on the arguments' own device, the CPU at a reduced size as the
        reference's census does: a meta-device run would need every
        kernel wrapper to accept meta tensors, and they take the CPU or a
        card by design. Leaves that are the same tensor under two names
        (a batch whose labels are its tokens) are each credited every
        read of it.

        **The two censuses differ by construction.** The reference counts
        the equations of a ``jax.make_jaxpr`` trace, a ``scan`` body once:
        a stacked layer leaf read by every layer counts the body's reads
        once (plus the scan's own). This census counts what runs, so a
        stacked leaf's reads are counted once per layer that reads it.
        Where no layer loop is traced (a function without ``scan``) the
        two counts are equal.
        """
        if kinds is None:
            kinds = [ObjectKind.INPUT] * len(args)
        records: list[tuple[str, ObjectKind, bool, torch.Tensor]] = []
        for i, arg in enumerate(args):
            for key, leaf in _leaves_with_keys(arg):
                records.append((f"arg{i}{key}", kinds[i],
                                i in donate_argnums, leaf))
        census = _ReadCensus([leaf for *_, leaf in records])
        with census:
            step_fn(*args)

        catalog = cls()
        for (name, kind, donated, leaf), n_reads in zip(records,
                                                        census.counts):
            lifetime = math.inf if kind in (
                ObjectKind.PARAM,
                ObjectKind.OPT_STATE,
                ObjectKind.KV_CACHE,
            ) else 0
            catalog.add(
                DataObject(
                    name=name,
                    shape=tuple(leaf.shape),
                    dtype=leaf.dtype,
                    kind=kind,
                    n_reads=n_reads,
                    n_writes=int(donated or kind is ObjectKind.OPT_STATE),
                    lifetime_iters=lifetime,
                )
            )
        return catalog

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._objects)

    def __iter__(self):
        return iter(self._objects.values())

    def __getitem__(self, name: str) -> DataObject:
        return self._objects[name]

    def __contains__(self, name: str) -> bool:
        return name in self._objects

    def names(self) -> list[str]:
        return list(self._objects)

    @property
    def total_bytes(self) -> int:
        return sum(o.size_bytes for o in self)

    def large_objects(self) -> list[DataObject]:
        return [o for o in self if not o.is_small]

    def small_objects(self) -> list[DataObject]:
        return [o for o in self if o.is_small]

    def census(self) -> Mapping[str, Any]:
        """Summary statistics mirroring the paper's Fig 5 analysis."""
        large = self.large_objects()
        small = self.small_objects()
        total = self.total_bytes or 1
        return {
            "n_objects": len(self),
            "n_large": len(large),
            "n_small": len(small),
            "bytes_total": self.total_bytes,
            "bytes_large": sum(o.size_bytes for o in large),
            "bytes_small": sum(o.size_bytes for o in small),
            "large_fraction_of_peak": sum(o.size_bytes for o in large) / total,
            "n_short_lived": sum(1 for o in self if o.is_short_lived),
        }


def _is_view(func) -> bool:
    """Whether an ATen op only aliases its input (a view, ``detach``,
    ``alias``): every result carries a read-only alias annotation."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


class _ReadCensus(TorchDispatchMode):
    """Counts, per leaf tensor, the ops that take it (or a view of it) as
    an argument: ``counts[i]`` for ``leaves[i]``."""

    def __init__(self, leaves: Sequence[torch.Tensor]):
        super().__init__()
        self.owners: dict[StorageWeakRef, list[int]] = {}
        for i, t in enumerate(leaves):
            self.owners.setdefault(StorageWeakRef(t.untyped_storage()),
                                   []).append(i)
        self.counts = [0] * len(leaves)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _is_view(func):
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    for i in self.owners.get(
                            StorageWeakRef(t.untyped_storage()), ()):
                        self.counts[i] += 1
        return func(*args, **kwargs)
