"""Mixture-of-Experts FFN with capacity-based grouped dispatch.

A port of ``repro.models.moe``'s dense dispatch. Dispatch is *per group*
(a group = one batch row in prefill, the whole batch in the serving
engine's decode): the slots are sorted by expert inside each group, each
expert takes at most ``capacity`` of them, and the rest drop.

From the DOLMA perspective expert weights are the canonical remote object:
large, cold (top-k of E per token), never written at serve time — the
placement policy demotes them first, and the serving engine can page them
(:mod:`repro_torch.serving.expert_paging`).

Every step is deterministic on a card, as the pager's fixpoint needs (it
re-runs a decode step and expects the same bits):

* ``top_k`` is a stable descending sort, so a tie takes the lower expert
  id, as ``jax.lax.top_k`` does;
* the dispatch scatter accumulates into zeros with ``index_add_``: each
  capacity slot receives one token's row and, from dropped slots (whose
  destination aliases their expert's first slot), exact zeros, so any
  order of the adds gives the same bits;
* the combine sums each token's k expert outputs in the reference's order
  (its scatter-add walks the slots sorted by expert id), rounding to x's
  type after each add, with no atomics.

Under a device mesh (:mod:`repro_torch.models.sharding`) the tokens are
DTensors split over the batch axes. With experts split over ``model``
(``expert_sharding="expert"`` and ``n_experts`` divisible by the axis) the
layer is expert-parallel, :func:`_moe_ffn_ep` (``shard_map`` in the
reference): the router runs on the DTensors, each rank dispatches its
tokens among its own experts in a ``local_map`` body
(:func:`_dispatch_local`), and one all-reduce over ``model`` sums the
ranks' shares. Otherwise the same body runs with every expert on every
rank (the weights gathered), which on one rank is the dense path bit for
bit.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import map_leaves
from repro_torch.models.layers import _init, mlp_init
from repro_torch.models.sharding import (
    current_mesh,
    is_dtensor,
    local_call,
    mesh_shape,
    resolve_spec,
    to_placements,
)

Params = dict[str, Any]


def moe_init(gen: torch.Generator, cfg: ModelConfig, *,
             stack: int | None = None) -> Params:
    """The router (float32), the routed experts' stacked weights and the
    shared expert, or ``stack`` of them stacked."""
    d, E, ffe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": _init(gen, (d, E), torch.float32, stack=stack),
        "w_gate": _init(gen, (E, d, ffe), cfg.dtype, stack=stack),
        "w_up": _init(gen, (E, d, ffe), cfg.dtype, stack=stack),
        "w_down": _init(gen, (E, ffe, d), cfg.dtype,
                        scale=1.0 / math.sqrt(ffe), stack=stack),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=cfg.n_shared_experts * ffe,
                               stack=stack)
    return p


def expert_tensors(p: Params) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Single read point for the routed-expert weights.

    ``p`` is either the plain param dict ``moe_init`` builds or the
    assembled view of :class:`repro_torch.serving.expert_paging.
    ExpertParamStore`, in which non-resident experts' rows are zeros. A
    capacity slot that received no valid token carries an exact-zero input,
    and zero rows keep it exactly zero through silu and the products, so
    the output is bit-identical to untiered whenever every *routed* expert
    is resident.
    """
    return p["w_gate"], p["w_up"], p["w_down"]


class _Silu(torch.autograd.Function):
    """``x * sigmoid(x)`` rounded as the reference computes it: the
    sigmoid as ``1 / (1 + exp(-x))``, each operation rounded to x's type
    (XLA lowers ``jax.nn.silu`` so; torch's fused silu rounds once). The
    backward is JAX's for ``jax.nn.silu``, ``g s + (x g) s (1 - s)`` (the
    derivative of ``lax.logistic`` is ``s (1 - s)``), not autograd of the
    formula: where ``exp(-x)`` overflows (x below about -88, which a
    full-width expert's gate reaches), that multiplies 0 by inf."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1.0 - s))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """The reference's silu (:class:`_Silu`)."""
    return _Silu.apply(x)


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared expert: ``layers.mlp`` with the reference's silu."""
    return (_silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    groups: int | None = None,
    return_routing: bool = False,
):
    """Returns (output, load_balance_aux_loss[, (top_i, top_p)]). x: (B, S, d).

    ``groups`` dispatch groups of ``B*S/groups`` tokens each (one a batch
    row by default) set each expert's capacity. With ``return_routing`` the
    per-token router decision is appended: ``top_i`` (int32) and ``top_p``
    of shape (B, S, k), the signal the serving engine's expert pager feeds
    its router-mass EMA.
    """
    mesh = current_mesh()
    if mesh is None:
        return _moe_ffn_dense(p, x, cfg, groups=groups,
                              return_routing=return_routing)
    model = mesh_shape(mesh).get("model", 1)
    split = None
    if model > 1 and cfg.expert_sharding == "expert":
        split = "expert" if cfg.n_experts % model == 0 else None
    elif model > 1:
        split = "ff" if cfg.moe_d_ff % model == 0 else None
    return _moe_ffn_sharded(p, x, cfg, mesh, groups=groups,
                            return_routing=return_routing, split=split)


def _moe_ffn_dense(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    groups: int | None = None,
    return_routing: bool = False,
):
    B, S, d = x.shape
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    G = _check_groups(groups, B, S)
    T = (B * S) // G  # tokens per dispatch group
    xt = x.reshape(G, T, d)

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)  # (G,T,E)
    top_p, top_i = _top_k(probs, k)  # (G,T,k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch/Mixtral style); integer counts, so the
    # sum is exact in any order
    me = probs.mean(dim=(0, 1))  # (E,)
    n_tok = G * T
    ce = expert_counts(top_i.reshape(-1), E).float() / n_tok
    aux = E * torch.sum(me * ce) / k

    cap = max(math.ceil(T * k / E * cf), 1)
    wg, wu, wd = expert_tensors(p)
    out = _dispatch_local(xt, top_i, top_p, E, cap, wg, wu, wd).reshape(
        B, S, d)

    if cfg.n_shared_experts:
        out = out + _mlp(p["shared"], x)
    if return_routing:
        routing = (top_i.to(torch.int32).reshape(B, S, k),
                   top_p.reshape(B, S, k))
        return out, aux, routing
    return out, aux


def _check_groups(groups: int | None, B: int, S: int) -> int:
    G = groups if groups is not None else B
    if G <= 0 or (B * S) % G:
        raise ValueError(f"moe groups={G} does not evenly partition "
                         f"{B}x{S} tokens")
    return G


def _dispatch_local(xt, li, lw, E_loc: int, cap: int, w_gate, w_up,
                    w_down) -> torch.Tensor:
    """Capacity dispatch among ``E_loc`` experts, per group, with no
    collectives. xt: (G,T,d); li: (G,T,k) expert ids, ``E_loc`` for a slot
    whose expert is elsewhere; lw: (G,T,k) combine weights (0 for such a
    slot). Returns the (G,T,d) sum over each token's slots that reached
    these experts.

    The slots are sorted by expert inside each group and each expert takes
    at most ``cap`` of them. The dispatch adds into zeros with
    ``index_add_``: each capacity slot receives one token's row and, from
    dropped slots (whose destination aliases slot 0), exact zeros, so any
    order of the adds gives the same bits. The combine adds each token's
    slots by ascending expert id (the reference's scatter-add order),
    rounding to x's type after each add; a slot that went elsewhere adds an
    exact zero. With every expert here (no ``E_loc`` in ``li``) this is
    the dense path's dispatch, bit for bit."""
    G, T, d = xt.shape
    k = li.shape[-1]
    dev, dtype = xt.device, xt.dtype
    flat_e = li.reshape(G, T * k)
    slot = torch.arange(T * k, device=dev)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = (order // k)  # the token of each sorted slot
    here = torch.clamp(se, max=E_loc - 1)
    # position of each slot within its expert's contiguous run
    starts = torch.searchsorted(
        se, torch.arange(E_loc, device=dev).expand(G, E_loc).contiguous())
    pos = slot[None, :] - torch.gather(starts, 1, here)
    valid = (se < E_loc) & (pos >= 0) & (pos < cap)
    dest = here * cap + torch.where(valid, pos, 0)  # (G,T*k) in [0,E_loc*cap)

    # gather tokens into (G, E_loc, cap, d)
    src = torch.gather(xt, 1, stok[..., None].expand(G, T * k, d))
    src = torch.where(valid[..., None], src, 0)
    rows = dest + torch.arange(G, device=dev)[:, None] * (E_loc * cap)
    xg = torch.zeros((G * E_loc * cap, d), dtype=dtype, device=dev)
    xg.index_add_(0, rows.reshape(-1), src.reshape(-1, d))
    xg = xg.reshape(G, E_loc, cap, d)

    # expert computation
    h = _silu(torch.einsum("gecd,edf->gecf", xg, w_gate))
    h = h * torch.einsum("gecd,edf->gecf", xg, w_up)
    yg = torch.einsum("gecf,efd->gecd", h, w_down).reshape(G, E_loc * cap, d)

    # combine back to tokens: slot j of token t (top-k order) sits at
    # sorted position inv[t*k + j]; a token's slots are added in sorted
    # order, i.e. by ascending expert id
    inv = torch.empty_like(order).scatter_(1, order, slot.expand(G, T * k))
    by_id = torch.argsort(li, dim=-1, stable=True)  # (G,T,k)
    at = torch.gather(inv.reshape(G, T, k), 2, by_id).reshape(G, T * k)
    w = torch.gather(lw, 2, by_id).reshape(G, T * k)
    got = torch.gather(yg, 1, torch.gather(dest, 1, at)[..., None].expand(
        G, T * k, d))
    got = torch.where(torch.gather(valid, 1, at)[..., None], got, 0)
    got = (got * w[..., None].to(dtype)).reshape(G, T, k, d)
    out = torch.zeros((G, T, d), dtype=dtype, device=dev)
    for j in range(k):
        out = out + got[:, :, j]
    return out


# ---------------------------------------------------------------------------
# under a mesh: expert-parallel dispatch (shard_map over 'model')
# ---------------------------------------------------------------------------

class _SumOverGroup(torch.autograd.Function):
    """The reference's ``psum`` of the ranks' shares: an all-reduce (sum)
    forward. The loss is one replicated term, so the gradient of each
    rank's share is the output's gradient as it is: identity backward."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward whose backward sums the gradient over ``group``:
    a tensor that enters every rank alike but feeds only each rank's own
    experts gets a share of its gradient from each rank (the reference
    ``pvary``s it, whose transpose is this sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _grad_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _SumGradOverGroup.apply(t, group)


def _replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _route(x: torch.Tensor, router: torch.Tensor, *, k: int):
    """(probs, top_p, top_i) of each token: the dense path's router."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_p, top_i = _top_k(probs, k)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def expert_counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """How often each of ``E`` experts appears in ``idx`` (int64):
    ``torch.bincount(idx, minlength=E)`` with its length fixed by ``E``
    and not by the data, so that a trace on fake tensors can take it."""
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx.long(), torch.ones_like(idx, dtype=torch.int64))


def _count(top_i: torch.Tensor, E: int) -> torch.Tensor:
    """How many slots each expert was picked for, over every rank's tokens
    (the dense path's ``bincount``): each rank counts its own, summed."""
    out = [Partial() if pl.is_shard() else pl for pl in top_i.placements]
    return local_call("moe_count", lambda t: expert_counts(
        t.reshape(-1), E), (top_i,), (top_i.placements,), out,
        top_i.device_mesh)


def _moe_ffn_ep(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh, *,
                groups: int | None = None, return_routing: bool = False):
    """The expert-parallel MoE over ``mesh``'s ``model`` axis (experts split
    over it); plain tensors in give plain tensors out, as ``shard_map`` of
    global arrays does."""
    return _moe_ffn_sharded(p, x, cfg, mesh, groups=groups,
                            return_routing=return_routing, split="expert")


def _moe_ffn_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh, *,
                     groups: int | None, return_routing: bool,
                     split: str | None):
    """The MoE on DTensors: the router on the global tokens, then each
    rank's dispatch groups (which must lie within its batch shard) through
    :func:`_dispatch_local`. ``split`` says what ``model`` splits: the
    experts (``"expert"``, the reference's ``expert_sharding="expert"``),
    each expert's hidden dim (``"ff"``, its ``"tensor"``), or nothing
    (None: every weight gathered onto every rank). A split gives each rank
    a share of the output, and one all-reduce over ``model`` sums them."""
    plain = not is_dtensor(x)
    if plain:
        x = _replicated(x, mesh)
        p = map_leaves(lambda _k, t: _replicated(t, mesh), p)
    B, S, d = x.shape
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    n_shards = mesh_shape(mesh)["model"] if split == "expert" else 1
    E_loc = E // n_shards
    G = _check_groups(groups, B, S)
    x = x.redistribute(mesh, to_placements(
        resolve_spec(x.shape, ("batch", None, None), mesh), mesh))
    n_data = math.prod(n for pl, n in zip(x.placements, mesh.shape)
                       if pl.is_shard())
    if G % n_data:
        raise ValueError(
            f"moe groups={G} must be divisible by the data-shard count "
            f"{n_data} so each dispatch group stays within one shard")
    T = (B * S) // G
    G_loc = G // n_data

    # the routing, token by token on each rank's rows; the aux loss from
    # it over every rank's
    x_p = tuple(x.placements)
    probs, top_p, top_i = local_call(
        "moe_route", functools.partial(_route, k=k), (x, p["router"]),
        (x_p, [Replicate()] * mesh.ndim), (x_p, x_p, x_p), mesh)
    me = probs.mean(dim=(0, 1))
    ce = _count(top_i, E).float() / (B * S)
    aux = E * torch.sum(me * ce) / k
    cap = max(math.ceil(T * k / E * cf), 1)

    group = mesh.get_group("model") if split else None
    lo = mesh.get_local_rank("model") * E_loc if split == "expert" else 0

    def body(x_l, ti_l, tp_l, wg_l, wu_l, wd_l):
        if split:
            x_l, tp_l = _grad_sum(x_l, group), _grad_sum(tp_l, group)
        local = (ti_l >= lo) & (ti_l < lo + E_loc)
        li = torch.where(local, ti_l - lo, E_loc)
        lw = torch.where(local, tp_l, 0.0)
        Bl, Sl, _ = x_l.shape
        part = _dispatch_local(x_l.reshape(G_loc, T, d),
                               li.reshape(G_loc, T, k),
                               lw.reshape(G_loc, T, k), E_loc, cap,
                               wg_l, wu_l, wd_l)
        if split:
            part = _SumOverGroup.apply(part, group)
        return part.reshape(Bl, Sl, d)

    # (w_gate, w_up) and w_down's dims that 'model' splits
    dims = {"expert": (0, 0), "ff": (2, 1)}.get(split)
    w1_p, w2_p = ([Shard(dims[j]) if dims and name == "model" else Replicate()
                   for name in mesh.mesh_dim_names] for j in (0, 1))
    out = local_call("moe_ep" if split == "expert" else "moe", body,
                     (x, top_i, top_p, *expert_tensors(p)),
                     (x_p, x_p, x_p, w1_p, w1_p, w2_p), x_p, mesh)
    if cfg.n_shared_experts:
        out = out + _mlp(p["shared"], x)
    routing = (top_i.to(torch.int32), top_p)
    if plain:
        out, aux = out.full_tensor(), aux.full_tensor()
        routing = tuple(t.full_tensor() for t in routing)
    if return_routing:
        return out, aux, routing
    return out, aux
