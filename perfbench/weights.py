"""The parameters of a cell, drawn on the device from ``--seed``.

A reference family (``reference/<family>.py``) lists its parameters with
``param_specs(model)``: each a :class:`Spec` with its path in the program's
parameter tree, shape, type and initial distribution. Each leaf is drawn
whole in one call from a generator of its own, in the type it is trained
in, so that any leaf can be drawn again alone (the update's check reads
the parameters' change against their first values). Both the program and
the reference are handed the same tensors.

A stacked leaf (``stacked``: its first dim is the layer) is one tensor in
the program's tree and one unit a layer in the comparison; a unit is named
by its path joined with dots, and a stacked leaf's layer by the index
after it (``layers.mlp.w_gate.3``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from perfbench.seeds import generator


@dataclasses.dataclass(frozen=True)
class Spec:
    path: tuple[str, ...]
    shape: tuple[int, ...]
    dtype: torch.dtype
    #: ("normal", std) | ("const", value)
    init: tuple
    stacked: bool = False

    @property
    def name(self) -> str:
        return ".".join(self.path)


def draw_leaf(spec: Spec, seed: int, device) -> torch.Tensor:
    """The leaf ``spec`` of run ``seed``, on ``device``."""
    kind, *args = spec.init
    if kind == "const":
        return torch.full(spec.shape, args[0], dtype=spec.dtype, device=device)
    gen = generator(seed, "param." + spec.name, device)
    if kind == "normal":
        t = torch.randn(spec.shape, dtype=spec.dtype, device=device,
                        generator=gen)
        return t.mul_(args[0])
    raise ValueError(f"unknown initialisation {spec.init!r} of {spec.name}")


def draw(specs: list[Spec], seed: int, device) -> dict:
    """The parameter tree (nested dicts by path) of run ``seed``."""
    tree: dict = {}
    for s in specs:
        node = tree
        for k in s.path[:-1]:
            node = node.setdefault(k, {})
        node[s.path[-1]] = draw_leaf(s, seed, device)
    return tree


def leaf(tree: dict, spec: Spec):
    """The leaf of ``tree`` at ``spec``'s path."""
    for k in spec.path:
        tree = tree[k]
    return tree


def units(spec: Spec) -> Iterator[tuple[str, int | None]]:
    """The comparison's units of ``spec``: (name, layer index or None)."""
    if spec.stacked:
        for i in range(spec.shape[0]):
            yield f"{spec.name}.{i}", i
    else:
        yield spec.name, None


def unit_norms(t: torch.Tensor, spec: Spec, device,
               minus: torch.Tensor | None = None) -> dict[str, float]:
    """The L2 norm of each unit of leaf ``t`` (of ``t - minus`` when given),
    in float64, read on ``device`` one unit at a time (a leaf in host
    memory is copied there a unit at a time)."""
    out = {}
    for name, i in units(spec):
        x = (t if i is None else t[i]).to(device, non_blocking=False)
        x = x.double()
        if minus is not None:
            m = minus if i is None else minus[i]
            x = x - m.to(device).double()
        out[name] = float(torch.linalg.vector_norm(x))
    return out
