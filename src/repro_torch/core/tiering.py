"""DOLMA placement applied to a model's parameters, and the layer loop's
dual buffer.

The port of the forward part of ``repro.core.tiering``. One backend so far:

* ``host_offload`` — REMOTE leaves live in host memory (pinned when the
  model runs on a card): HBM is the local tier, host DRAM the remote tier.
  :func:`place_params` puts every leaf where its tier says;
  :func:`tiered_scan` streams each layer's REMOTE slices to the device
  through a :class:`~repro_torch.core.exec.HostFetchEngine` (a copy stream
  and CUDA events).

``mode="none"`` keeps every leaf on the device. The reference's
``fsdp_stream`` (peer HBM as the remote tier) waits for the sharding slice
(ROADMAP A11); the ``"auto"`` budget waits for the sizing port (A4), and
optimizer state and the remat branch for the training slice (A9).

:func:`tiered_scan` is the paper's dual buffer over layers: with
``prefetch`` it posts layer i+1's fetch before layer i computes, and the
access barrier is deferred to the first use of those weights
(:meth:`HostFetchEngine.acquire`). Prefetch changes only *when* bytes
move: every placement and both prefetch settings run the same kernels on
the same values, so their outputs are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Literal

import torch

from repro_torch.core.exec import HostFetchEngine, host_tensor, resolve_device
from repro_torch.core.metadata import Tier
from repro_torch.core.objects import (
    DataObject,
    ObjectCatalog,
    ObjectKind,
    _leaves_with_keys,
)
from repro_torch.core.placement import PlacementPlan, PlacementPolicy

TieringMode = Literal["none", "host_offload", "fsdp_stream"]


@dataclasses.dataclass(frozen=True)
class TieringConfig:
    """How params tier out of HBM during the layer loop.

    ``local_fraction`` is the share of param bytes kept resident on the
    device. Whether the layer loop prefetches is the caller's argument
    (``forward(..., prefetch=)``), as in the reference's model API.
    """

    mode: TieringMode = "none"
    local_fraction: float | str = 1.0

    def __post_init__(self):
        if self.mode == "fsdp_stream":
            raise NotImplementedError(
                "TieringConfig: mode 'fsdp_stream' waits for the sharding "
                "slice (ROADMAP A11); use 'host_offload' or 'none'")
        if self.mode not in ("none", "host_offload"):
            raise ValueError(f"TieringConfig: unknown mode {self.mode!r}")


def plan_for_params(params: Any, *, config: TieringConfig,
                    opt_state: Any = None) -> PlacementPlan:
    """A placement plan over the parameters, named ``"params" + keystr`` as
    the reference names them. Each parameter is read twice and written once
    a step (forward + backward, update), the reference's defaults."""
    if opt_state is not None:
        raise NotImplementedError(
            "plan_for_params: optimizer state waits for the training slice "
            "(ROADMAP A9)")
    if not isinstance(config.local_fraction, (int, float)):
        raise NotImplementedError(
            f"plan_for_params: local_fraction={config.local_fraction!r}; the "
            f"'auto' budget waits for the sizing port (ROADMAP A4)")
    catalog = ObjectCatalog()
    for key, leaf in _leaves_with_keys(params):
        catalog.add(DataObject(name="params" + key, shape=tuple(leaf.shape),
                               dtype=leaf.dtype, kind=ObjectKind.PARAM,
                               n_reads=2, n_writes=1))
    return PlacementPolicy().plan(catalog,
                                  local_fraction=float(config.local_fraction))


def map_leaves(fn: Callable[[str, torch.Tensor], torch.Tensor], tree: Any,
               key: str = "") -> Any:
    """Nested dicts ``tree`` with each leaf replaced by ``fn(keystr, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{key}[{k!r}]") for k, v in tree.items()}
    return fn(key, tree)


def place_params(params: Any, config: TieringConfig, *,
                 device: str | torch.device = "cuda",
                 ) -> tuple[Any, PlacementPlan | None]:
    """Put every leaf where ``config`` says; returns (params, plan).

    ``mode="none"``: every leaf on ``device``, no plan. ``host_offload``:
    :func:`plan_for_params` decides; a REMOTE leaf moves to host memory
    (pinned when ``device`` is a card), a LOCAL one to ``device``.
    """
    dev = resolve_device(device)
    if config.mode == "none":
        return map_leaves(lambda _k, t: t.to(dev), params), None
    plan = plan_for_params(params, config=config)
    pin = dev.type == "cuda"

    def place(key: str, t: torch.Tensor) -> torch.Tensor:
        if plan.tier_of("params" + key) is Tier.REMOTE:
            return host_tensor(t.to("cpu"), pin=pin)
        return t.to(dev)

    return map_leaves(place, params), plan


def remote_keys(plan: PlacementPlan | None, prefix: str) -> frozenset[str]:
    """The keys, relative to ``prefix`` (``"params['layers']"``), of the
    plan's REMOTE leaves under it."""
    if plan is None:
        return frozenset()
    return frozenset(n[len(prefix):] for n in plan.remote_names()
                     if n.startswith(prefix))


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


def tiered_scan(
    layer_fn: Callable[[Any, Any], Any],
    carry: Any,
    stacked_params: Any,
    *,
    n_layers: int,
    prefetch: bool = True,
    remote: frozenset[str] = frozenset(),
    engine: HostFetchEngine | None = None,
):
    """Run ``layer_fn(carry, layer_params)`` over ``n_layers`` stacked layers.

    ``stacked_params``: nested dicts whose leaves have leading dim
    ``n_layers``. The leaves named in ``remote`` (keys as ``keystr`` gives
    them) are REMOTE: layer i's slice of each is copied to the device
    through ``engine``; the others are indexed where they lie.

    ``prefetch=True`` is the dual buffer: layer i+1's fetch is posted before
    layer i computes, so the copy runs on the copy stream while the layer's
    kernels run on the compute stream; :meth:`HostFetchEngine.acquire`
    makes the compute stream wait for the copy just before first use.
    ``prefetch=False`` fetches each layer just before it computes. Both move
    the same bytes and compute the same values.
    """
    _check_stack_depth(stacked_params, n_layers)
    leaves = dict(_leaves_with_keys(stacked_params))
    unknown = remote - leaves.keys()
    if unknown:
        raise ValueError(f"tiered_scan: remote leaves {sorted(unknown)} are "
                         f"not in stacked_params")
    if remote and engine is None:
        raise ValueError("tiered_scan: remote leaves need a HostFetchEngine")

    def post(i: int):
        if not remote:
            return None
        return engine.fetch(f"layer{i}", {k: leaves[k][i] for k in remote},
                            pace=False)

    def layer(i: int, fut) -> Any:
        flat = {k: t[i] for k, t in leaves.items() if k not in remote}
        if fut is not None:
            flat.update(engine.acquire(fut))
        return _unflatten(flat, stacked_params)

    nxt = post(0) if prefetch else None
    for i in range(n_layers):
        if prefetch:
            cur, nxt = nxt, (post(i + 1) if i + 1 < n_layers else None)
        else:
            cur = post(i)
        carry = layer_fn(carry, layer(i, cur))
    return carry
