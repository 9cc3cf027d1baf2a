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

The expert-parallel path (``_moe_ffn_ep``, ``shard_map`` in the reference)
waits for ROADMAP A11; without a mesh the reference takes this dense path
too.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _init, mlp_init

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


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded as the reference computes it: the
    sigmoid as ``1 / (1 + exp(-x))``, each operation rounded to x's type
    (XLA lowers ``jax.nn.silu`` so; torch's fused silu rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


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
    return _moe_ffn_dense(p, x, cfg, groups=groups,
                          return_routing=return_routing)


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
    G = groups if groups is not None else B
    if G <= 0 or (B * S) % G:
        raise ValueError(f"moe groups={G} does not evenly partition "
                         f"{B}x{S} tokens")
    T = (B * S) // G  # tokens per dispatch group
    dev = x.device
    xt = x.reshape(G, T, d)

    probs = torch.softmax(xt.float() @ p["router"], dim=-1)  # (G,T,E)
    top_p, top_i = _top_k(probs, k)  # (G,T,k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch/Mixtral style); integer counts, so the
    # sum is exact in any order
    me = probs.mean(dim=(0, 1))  # (E,)
    n_tok = G * T
    ce = torch.bincount(top_i.reshape(-1), minlength=E).float() / n_tok
    aux = E * torch.sum(me * ce) / k

    cap = max(math.ceil(T * k / E * cf), 1)

    # --- per-group sorted dispatch ---
    flat_e = top_i.reshape(G, T * k)
    slot = torch.arange(T * k, device=dev)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = (order // k)  # the token of each sorted slot
    # position of each slot within its expert's contiguous run
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, E).contiguous())  # (G,E)
    pos = slot[None, :] - torch.gather(starts, 1, se)
    valid = (pos >= 0) & (pos < cap)
    dest = se * cap + torch.where(valid, pos, 0)  # (G, T*k) in [0, E*cap)

    # gather tokens into (G, E, cap, d)
    src = torch.gather(xt, 1, stok[..., None].expand(G, T * k, d))
    src = torch.where(valid[..., None], src, 0)
    rows = dest + torch.arange(G, device=dev)[:, None] * (E * cap)
    xg = torch.zeros((G * E * cap, d), dtype=x.dtype, device=dev)
    xg.index_add_(0, rows.reshape(-1), src.reshape(-1, d))
    xg = xg.reshape(G, E, cap, d)

    # expert computation
    wg, wu, wd = expert_tensors(p)
    h = _silu(torch.einsum("gecd,edf->gecf", xg, wg))
    h = h * torch.einsum("gecd,edf->gecf", xg, wu)
    yg = torch.einsum("gecf,efd->gecd", h, wd).reshape(G, E * cap, d)

    # combine back to tokens: slot j of token t (top-k order) sits at
    # sorted position inv[t*k + j]; the reference adds a token's slots in
    # sorted order, i.e. by ascending expert id
    inv = torch.empty_like(order).scatter_(1, order, slot.expand(G, T * k))
    by_id = torch.argsort(top_i, dim=-1, stable=True)  # (G,T,k)
    at = torch.gather(inv.reshape(G, T, k), 2, by_id).reshape(G, T * k)
    w = torch.gather(top_p, 2, by_id).reshape(G, T * k)
    got = torch.gather(yg, 1, torch.gather(dest, 1, at)[..., None].expand(
        G, T * k, d))
    got = torch.where(torch.gather(valid, 1, at)[..., None], got, 0)
    got = (got * w[..., None].to(x.dtype)).reshape(G, T, k, d)
    out = torch.zeros((G, T, d), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + got[:, :, j]
    out = out.reshape(B, S, d)

    if cfg.n_shared_experts:
        out = out + _mlp(p["shared"], x)
    if return_routing:
        routing = (top_i.to(torch.int32).reshape(B, S, k),
                   top_p.reshape(B, S, k))
        return out, aux, routing
    return out, aux
