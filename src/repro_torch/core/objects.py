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
the leaves as ``jax.tree_util.keystr`` does (``['a']['b']``). The access
census from a traced step function (``from_step_fn``) waits for the
training slice.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Iterable, Iterator, Mapping

import numpy as np
import torch


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
