"""Core layers: RMSNorm, RoPE, GQA attention (full, sliding window, decode,
cross), the SwiGLU MLP, the tied embedding and head.

A port of ``repro.models.layers``, ``cross_entropy`` included. Parameters are nested dicts of tensors, as in the
reference. The projections are plain ``x @ w``, as there; full-sequence
attention goes through :func:`repro_torch.models.flash.flash_attention`
(kernel B2 on a card), decode and masked attention through :func:`_sdpa`.
Where the reference computes in bf16, the port rounds at the same points:
einsum outputs in the input type, RoPE's sin and cos cast to x's type.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.flash import flash_attention
from repro_torch.models.sharding import (
    constrain,
    is_dtensor,
    local_call,
    local_shape_and_offset,
    replicate_like,
)

Params = dict[str, Any]


def _init(gen: torch.Generator, shape, dtype, scale=None, *,
          stack: int | None = None) -> torch.Tensor:
    """A normal draw in float32 times ``scale`` (``1/sqrt(shape[0])`` by
    default), cast to ``dtype``; with ``stack`` the draw is ``stack``
    independent copies along a new leading dim. Drawn on the generator's
    device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (stack, *shape) if stack is not None else tuple(shape)
    return torch.randn(full, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(scale).to(dtype)


# -- RMSNorm ---------------------------------------------------------------

def rmsnorm_init(d: int, dtype, *, stack: int | None = None,
                 device: torch.device | str) -> Params:
    shape = (stack, d) if stack is not None else (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def whole_seq(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, ...) with its sequence laid out by the ``seq`` rule (not
    split, by default) under a mesh: what a block computes on, where the
    carry between blocks keeps it split (``seq_sp``), as the reference's
    partitioner gathers it before a block's projections."""
    return constrain(x, "batch", "seq", *([None] * (x.ndim - 2)))


def as_carry(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, d), a block's output, laid out as the residual carry
    (``batch``, ``seq_sp``) under a mesh before it is added to it: the add
    then passes each operand a gradient laid out as that operand, where a
    redistribution DTensor would make inside the add would not."""
    return constrain(x, "batch", "seq_sp", None)


# -- rotary ------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S). The angles are float32;
    sin and cos are cast to x's type before they multiply."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    freqs = replicate_like(freqs, x)
    angles = positions.float()[..., None, None] * freqs  # (...,S,1,half)
    sin, cos = torch.sin(angles).to(x.dtype), torch.cos(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# -- GQA attention ----------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ModelConfig, *,
                   stack: int | None = None) -> Params:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": _init(gen, (d, H * Dh), cfg.dtype, stack=stack),
        "wk": _init(gen, (d, KV * Dh), cfg.dtype, stack=stack),
        "wv": _init(gen, (d, KV * Dh), cfg.dtype, stack=stack),
        "wo": _init(gen, (H * Dh, d), cfg.dtype, stack=stack),
    }


def _whole_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor whose last dim (n heads, flattened) is split finer than
    its heads, gathered along it; anything else as it is."""
    if is_dtensor(x):
        last = [i for i, pl in enumerate(x.placements)
                if pl.is_shard(x.ndim - 1)]
        if n % math.prod(x.device_mesh.shape[i] for i in last):
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in last else pl
                for i, pl in enumerate(x.placements)])
    return x


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    # a projection split finer than its n heads is gathered first
    x = _whole_heads(x, n)
    return x.reshape(*x.shape[:-1], n, d)


class _GradHeads(torch.autograd.Function):
    """The identity; its backward gathers a gradient split along its last
    dim finer than ``n`` heads (:func:`_whole_heads`), which the view back
    to heads could not take (36 heads over 16 ranks)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.n), None


def _merge_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n, d) -> (..., n·d), the inverse of :func:`_split_heads`."""
    x = x.reshape(*x.shape[:-2], n * d)
    return _GradHeads.apply(x, n) if is_dtensor(x) else x


def _sdpa(q, k, v, mask, cfg: ModelConfig, groups=()) -> torch.Tensor:
    """q: (B,Sq,H,Dh)  k,v: (B,Sk,KV,Dh)  mask: broadcastable (B,1,Sq,Sk).

    Dense attention as the reference computes it: the raw scores rounded
    to q's type (the einsum's output type) before they are scaled, softmax
    in float32, the probabilities cast to q's type.

    With ``groups`` (process groups) each rank of them holds its own slice
    of the keys: the softmax's row max and sum of exponentials, then the
    probabilities' products with v, are all-reduced over them."""
    if is_dtensor(q):
        return _local_sdpa(q, k, v, mask, cfg)
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())
    scores = scores.to(q.dtype).float() / math.sqrt(Dh)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         scores, NEG_INF)
    if groups:
        top = scores.amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(scores - top)
        total = e.sum(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(total, group=g)
        probs = (e / total).to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    for g in groups:
        dist.all_reduce(out, group=g)
    return out.to(q.dtype).reshape(B, Sq, H, Dh)


def _local_sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_sdpa` of DTensors on each rank's local shards (the decode
    steps'). A mesh dim that splits q and k alike on the batch or on the
    heads stays split (each rank's query heads then read its own KV
    heads). A mesh dim that splits the keys (a cache's length) keeps them
    split, the softmax reduced over that dim's ranks. Any other split is
    gathered."""
    keep = (Shard(0), Shard(2))
    qp = tuple(a if a == b and a in keep else Replicate()
               for a, b in zip(q.placements, k.placements))
    kp = tuple(Shard(1) if b == Shard(1) else a
               for a, b in zip(qp, k.placements))
    mask = replicate_like(mask, q)
    per_row = mask.shape[0] == q.shape[0] > 1
    mp = tuple(Shard(3) if b == Shard(1) else
               a if a == Shard(0) and per_row else Replicate()
               for a, b in zip(qp, kp))
    mesh = q.device_mesh
    groups = [mesh.get_group(i) for i, b in enumerate(kp) if b == Shard(1)]
    return local_call("sdpa", lambda *ts: _sdpa(*ts, cfg, groups),
                      (q, k, v, mask), (qp, kp, kp, mp), qp, mesh)


def causal_mask(Sq: int, Sk: int, *, window: int | None = None,
                offset: int = 0, device: torch.device | str = "cpu",
                ) -> torch.Tensor:
    """(1,1,Sq,Sk) causal (optionally banded) mask. ``offset`` = Sk - Sq."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m[None, None]


def gqa_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    kv: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    causal: bool = True,
) -> torch.Tensor:
    """Self- (kv=None) or cross- (kv = encoder output) attention."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rope(_split_heads(x @ p["wq"], H, Dh), positions, cfg.rope_theta)
    if kv is None:
        k = rope(_split_heads(x @ p["wk"], KV, Dh), positions, cfg.rope_theta)
        v = _split_heads(x @ p["wv"], KV, Dh)
    else:
        k = _split_heads(kv @ p["wk"], KV, Dh)
        v = _split_heads(kv @ p["wv"], KV, Dh)
        if kv_positions is not None:
            k = rope(k, kv_positions, cfg.rope_theta)
        causal = False
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    if mask is None:
        out = flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window if kv is None else None)
    else:
        out = _sdpa(q, k, v, mask, cfg)
    out = constrain(out, "batch", None, "heads", None)
    return _merge_heads(out, H, Dh) @ p["wo"]


def write_slot(cache: torch.Tensor, new: torch.Tensor,
               slot: torch.Tensor) -> None:
    """``new`` (B,1,...) into ``cache`` (B,S,...) at ``slot`` in place, as
    the reference writes a decode step's K/V or latent: at a 0-d ``slot``
    for every lane, clamped to the last slot (``dynamic_update_slice``
    clamps a write past the end); at a per-lane ``(B,)`` slot, a lane past
    the cache keeps what it has, as the reference's scatter drops an
    out-of-range write (it rewrites the value already in its clamped slot:
    a mask, not boolean indexing, so the host never waits)."""
    if is_dtensor(cache):
        _write_slot_sharded(cache, new, slot)
        return
    S = cache.shape[1]
    row = slot.clamp(max=S - 1)
    if slot.ndim == 0:
        cache.index_copy_(1, row.reshape(1), new)
        return
    lanes = torch.arange(cache.shape[0], device=cache.device)
    keep = (slot >= S).reshape(-1, *([1] * (new.ndim - 2)))
    cache[lanes, row] = torch.where(keep, cache[lanes, row], new[:, 0])


def _write_slot_sharded(cache, new, slot) -> None:
    """:func:`write_slot` on a DTensor cache, in place on each rank's local
    shard: the rank whose shard of the slot dim holds the (clamped) slot
    writes ``new`` there, every other rank rewrites the value it has (a
    mask, so no rank waits on the slot's value). A 0-d slot only: a
    per-lane write under a mesh has no caller."""
    if slot.ndim != 0:
        raise NotImplementedError(
            "write_slot: a per-lane slot into a cache under a device mesh")
    mesh = cache.device_mesh
    whole = [Replicate() if pl.is_shard(1) else pl for pl in cache.placements]
    if not is_dtensor(new):
        new = replicate_like(new, cache)
    if tuple(new.placements) != tuple(whole):
        new = new.redistribute(mesh, whole)
    local, offset = local_shape_and_offset(cache.shape, mesh,
                                           cache.placements)
    c = cache.to_local()
    row = (slot.to_local() if is_dtensor(slot) else slot).clamp(
        max=cache.shape[1] - 1) - offset[1]
    owned = (row >= 0) & (row < local[1])
    r = row.clamp(0, local[1] - 1).reshape(1)
    c.index_copy_(1, r, torch.where(owned, new.to_local(),
                                    c.index_select(1, r)))


def gqa_decode_step(
    p: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,d); cache: (B,S_cache,KV,Dh); pos: a 0-d
    tensor or a per-lane ``(B,)`` vector, on x's device.

    For SWA the cache is a ring buffer of width ``sliding_window`` indexed
    by ``pos % window``; otherwise it holds the full context and the new
    K/V land at ``pos``. A per-lane ``pos`` decodes every lane at its own
    position: lane b's K/V land at ``pos[b]`` and its mask covers only its
    own slots, so each lane's arithmetic is independent of the others and
    bit-identical to running that lane alone at the same batch shape.

    At a position at or past a full cache's length the write follows the
    reference: a scalar position writes the last slot, and a lane past the
    cache writes nothing. The mask is the reference's either way.

    Unlike the reference, the new K/V are written into ``cache_k`` and
    ``cache_v`` in place (no copy of the cache per step); the returned
    caches are those same tensors.
    """
    B = x.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_cache = cache_k.shape[1]
    per_lane = pos.ndim > 0
    positions = pos.reshape(B, 1) if per_lane else pos.reshape(1, 1).expand(
        B, 1)
    q = rope(_split_heads(x @ p["wq"], H, Dh), positions, cfg.rope_theta)
    k_new = rope(_split_heads(x @ p["wk"], KV, Dh), positions, cfg.rope_theta)
    v_new = _split_heads(x @ p["wv"], KV, Dh)

    idx = replicate_like(torch.arange(S_cache, device=x.device), x)
    lane_pos = positions[:, 0].long() if per_lane else pos.long()
    slot = lane_pos % S_cache if cfg.sliding_window else lane_pos
    write_slot(cache_k, k_new, slot)
    write_slot(cache_v, v_new, slot)
    cache_k = constrain(cache_k, "batch", "kv_len", "kv_heads", None)
    cache_v = constrain(cache_v, "batch", "kv_len", "kv_heads", None)
    if per_lane:
        if cfg.sliding_window:
            valid = (idx[None, :] <= slot[:, None]) | (
                lane_pos[:, None] >= S_cache)
        else:
            valid = idx[None, :] <= lane_pos[:, None]
        mask = valid[:, None, None, :]
    else:
        if cfg.sliding_window:  # ring: all valid once wrapped
            valid = (idx <= slot) | (lane_pos >= S_cache)
        else:
            valid = idx <= lane_pos
        mask = valid[None, None, None, :]
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    return _merge_heads(out, H, Dh) @ p["wo"], cache_k, cache_v


# -- SwiGLU MLP -----------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             *, stack: int | None = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": _init(gen, (d, ff), cfg.dtype, stack=stack),
        "w_up": _init(gen, (d, ff), cfg.dtype, stack=stack),
        "w_down": _init(gen, (ff, d), cfg.dtype, stack=stack),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = constrain(h, "batch", None, "ff")
    return h @ p["w_down"]


# -- embedding / head ------------------------------------------------------

def padded_vocab(cfg: ModelConfig, multiple: int = 2048) -> int:
    return -(-cfg.vocab_size // multiple) * multiple


def embed_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    V = padded_vocab(cfg)
    return {"embedding": _init(gen, (V, cfg.d_model), cfg.dtype, scale=1.0)}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    e = constrain(p["embedding"], "vocab", None)
    if is_dtensor(e):
        return constrain(_local_embed(e, tokens), "batch", None, None)
    return constrain(e[tokens.long()], "batch", None, None)


def _local_embed(e: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup on each rank's shards (a vocabulary-parallel embedding):
    each rank looks the tokens up in its rows of the vocabulary and gives
    zeros for the others, so the output is ``Partial()`` (one rank's row,
    zeros elsewhere: an exact sum) on the mesh dims that split the
    vocabulary. DTensor's own strategy for the lookup's backward (an
    index_put) is refused by the card's torch 2.11 once the vocabulary is
    split."""
    from torch.distributed.tensor import Partial

    mesh = e.device_mesh
    tokens = replicate_like(tokens, e)
    local, offset = local_shape_and_offset(e.shape, mesh, e.placements)
    tp = tuple(Shard(0) if t == Shard(0) else Replicate()
               for t in tokens.placements)
    ep = tuple(Shard(0) if a == Shard(0) else Replicate()
               for a in e.placements)
    out = tuple(Partial() if a == Shard(0) else t for a, t in zip(ep, tp))

    def lookup(e_loc, tok):
        idx = tok.long() - offset[0]
        inside = (idx >= 0) & (idx < local[0])
        rows = e_loc[idx.clamp(0, local[0] - 1)]
        return torch.where(inside[..., None], rows, rows.new_zeros(()))

    return local_call("embed", lookup, (e, tokens), (ep, tp), out, mesh)


def logits(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,V_padded) float32, the tied embedding as the head;
    the padded vocabulary columns hold the finite ``NEG_INF``."""
    x = whole_seq(x)
    e = p["embedding"]
    out = constrain((x @ e.t().to(x.dtype)).float(), "batch", None, "vocab")
    V = padded_vocab(cfg)
    if V != cfg.vocab_size and is_dtensor(out):
        # DTensor refuses the in-place write into a view of the vocabulary
        pad = torch.arange(V, device=out.device) >= cfg.vocab_size
        out.masked_fill_(replicate_like(pad, out), NEG_INF)
    elif V != cfg.vocab_size:
        out[..., cfg.vocab_size:] = NEG_INF
    return out


class _VocabNLL(torch.autograd.Function):
    """The rows' NLL summed and divided by ``denom``, from each rank's
    slice of the vocabulary; ``groups`` are the process groups of the mesh
    dims that split the vocabulary, ``batch_groups`` those that split the
    rows.

    Per row: the slice's max, MAX over ``groups``; the sum of
    ``exp(logit - max)``, SUM; the picked logit (0 where the label lies
    outside the slice), SUM; ``nll = max + log(sum) - picked``. The rows'
    sum is then a SUM over ``batch_groups``, so every rank holds the whole
    scalar. The backward is ``(softmax - onehot) / denom`` on the local
    slice and posts no collective. With no groups it is the same
    arithmetic with no collective, so a one-rank mesh gives the same bits
    as no mesh."""

    @staticmethod
    def forward(ctx, logit, labels, denom: int, offset: int, groups,
                batch_groups):
        V = logit.shape[-1]
        idx = labels.long() - offset
        inside = (idx >= 0) & (idx < V)
        idx = idx.clamp(0, V - 1)
        top = logit.amax(dim=-1)
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        total = torch.exp(logit - top[..., None]).sum(dim=-1)
        picked = torch.where(inside, logit.gather(-1, idx[..., None])[..., 0],
                             0.0)
        for g in groups:
            dist.all_reduce(total, group=g)
            dist.all_reduce(picked, group=g)
        lse = top + torch.log(total)
        loss = (lse - picked).sum()
        for g in batch_groups:
            dist.all_reduce(loss, group=g)
        ctx.save_for_backward(logit, lse, idx, inside)
        ctx.denom = denom
        return loss / denom

    @staticmethod
    def backward(ctx, g):
        logit, lse, idx, inside = ctx.saved_tensors
        w = g / ctx.denom
        grad = torch.exp(logit - lse[..., None]).mul_(w)
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(inside, -w, 0.0)[..., None])
        return grad, None, None, None, None, None


def cross_entropy(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logit (B,S,V) float32, labels (B,S) int.

    Under a mesh the logits stay split by vocabulary as :func:`logits`
    leaves them: each rank reduces its own slice (:class:`_VocabNLL`, in
    :func:`~repro_torch.models.sharding.local_call`) and all-reduces three
    numbers a row over the mesh dims that split the vocabulary, so no rank
    holds a row's whole vocabulary. The result is a replicated scalar."""
    denom = max(labels.shape[0] * labels.shape[1], 1)
    if not is_dtensor(logit):
        return _VocabNLL.apply(logit, labels, denom, 0, (), ())
    mesh = logit.device_mesh
    lp = tuple(a if a in (Shard(0), Shard(2)) else Replicate()
               for a in logit.placements)
    rows = tuple(Shard(0) if a == Shard(0) else Replicate() for a in lp)
    vocab = [mesh.get_group(i) for i, a in enumerate(lp) if a == Shard(2)]
    batch = [mesh.get_group(i) for i, a in enumerate(lp) if a == Shard(0)]
    offset = local_shape_and_offset(logit.shape, mesh, lp)[1][2]

    def local(lg, y):
        return _VocabNLL.apply(lg, y, denom, offset, vocab, batch)

    return local_call("xent", local, (logit, replicate_like(labels, logit)),
                      (lp, rows), (Replicate(),) * mesh.ndim, mesh)
