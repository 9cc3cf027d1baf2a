"""Model assembly: the dense, vlm, moe, ssm and hybrid families.

A port of ``repro.models.transformer``, with the same public API:

  init_params(gen, cfg, device=)           -> params (nested dicts)
  forward(params, batch, cfg, ...)         -> (logits, aux)
  init_decode_cache(cfg, batch, max_len)   -> cache
  decode_step(params, cache, tokens, cfg)  -> (logits, cache[, routing])

Layers are *stacked* (leading dim = n_layers) and driven by
:func:`repro_torch.core.tiering.tiered_scan`, DOLMA's dual buffer over
layers: with a host-offload plan (``plan=``, from
:func:`~repro_torch.core.tiering.place_params`) layer i+1's REMOTE weights
are copied from pinned host memory while layer i computes. REMOTE leaves
outside the stack are fetched where they are used: the embedding at each
use, the hybrid's shared block once a forward or decode step. Every
placement computes the same values: its logits are bit-identical to the
all-local run's.

The attention block is GQA (:mod:`repro_torch.models.layers`) or MLA
(:mod:`repro_torch.models.mla`, ``cfg.attention == "mla"``). The moe family
(deepseek-v3, mixtral) runs two layer loops, each its own dual buffer: the
``first_k_dense`` attention + MLP blocks (``dense_layers``), then the
attention + MoE blocks (``layers``, :mod:`repro_torch.models.moe`), whose
load-balance losses sum into ``aux``. Its ``mtp`` block is made by
``init_params`` for the MTP loss, which waits for the training slice with
``loss_fn`` and the remat options (ROADMAP A9); no forward or decode step
runs it.

The hybrid family (zamba2) runs its Mamba2 stack in one layer loop and
applies the shared attention block after every ``hybrid_attn_every``-th
layer: the reference's groups, each followed by the shared block, then the
tail, computed in the same order, while the dual buffer also fetches
across the shared block.

The enc-dec family waits for ROADMAP A9.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import HostFetchEngine, resolve_device
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.tiering import map_leaves, remote_keys, tiered_scan
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = dict[str, Any]

_WAITS_FOR = {
    "encdec": "ROADMAP A9 (models/encdec.py)",
    "audio": "ROADMAP A9 (models/encdec.py)",
}


def _require_served(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{what}: the {cfg.family} family waits for "
            f"{_WAITS_FOR.get(cfg.family, 'its slice')}")


# ---------------------------------------------------------------------------
# layers and init
# ---------------------------------------------------------------------------

def _attn_block_init(gen: torch.Generator, cfg: ModelConfig,
                     n: int | None = None) -> Params:
    """The norms and the attention (GQA or MLA) of a block, or of ``n``
    stacked blocks."""
    d, dev = cfg.d_model, gen.device
    attn_init = MLA.mla_init if cfg.attention == "mla" else L.attention_init
    return {
        "ln1": L.rmsnorm_init(d, cfg.dtype, stack=n, device=dev),
        "ln2": L.rmsnorm_init(d, cfg.dtype, stack=n, device=dev),
        "attn": attn_init(gen, cfg, stack=n),
    }


def _dense_layer_init(gen: torch.Generator, cfg: ModelConfig,
                      n: int | None = None) -> Params:
    """One attention + MLP block, or ``n`` of them stacked."""
    p = _attn_block_init(gen, cfg, n)
    p["mlp"] = L.mlp_init(gen, cfg, stack=n)
    return p


def _moe_layer_init(gen: torch.Generator, cfg: ModelConfig,
                    n: int) -> Params:
    """``n`` stacked attention + MoE blocks."""
    p = _attn_block_init(gen, cfg, n)
    p["moe"] = MOE.moe_init(gen, cfg, stack=n)
    return p


def _ssm_layer_init(gen: torch.Generator, cfg: ModelConfig,
                    n: int) -> Params:
    return {
        "ln": L.rmsnorm_init(cfg.d_model, cfg.dtype, stack=n, device=gen.device),
        "ssm": SSM.ssm_init(gen, cfg, stack=n),
    }


def _attention_part(p, x, cfg, positions):
    h = L.rmsnorm(p["ln1"], x)
    if cfg.attention == "mla":
        return x + MLA.mla_attention(p["attn"], h, cfg, positions=positions)
    return x + L.gqa_attention(p["attn"], h, cfg, positions=positions)


def _dense_layer(p, x, cfg, positions):
    x = _attention_part(p, x, cfg, positions)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x))


def _moe_layer(p, x, cfg, positions, groups=None):
    x = _attention_part(p, x, cfg, positions)
    out, aux = MOE.moe_ffn(p["moe"], L.rmsnorm(p["ln2"], x), cfg,
                           groups=groups)
    return x + out, aux


def _block_decode(p, x, caches: dict, pos, cfg, *, groups=None,
                  routing: list | None = None):
    """One block's decode step; writes its new K/V (``caches["k"]``,
    ``["v"]``) or MLA latent (``["c"]``, ``["kr"]``) into the caches. A
    MoE block appends its router decision to ``routing`` when one is
    given."""
    h = L.rmsnorm(p["ln1"], x)
    if cfg.attention == "mla":
        o, _, _ = MLA.mla_decode_step(p["attn"], h, caches["c"], caches["kr"],
                                      pos, cfg)
    else:
        o, _, _ = L.gqa_decode_step(p["attn"], h, caches["k"], caches["v"],
                                    pos, cfg)
    x = x + o
    h = L.rmsnorm(p["ln2"], x)
    if "moe" not in p:
        return x + L.mlp(p["mlp"], h)
    if routing is None:
        out, _ = MOE.moe_ffn(p["moe"], h, cfg, groups=groups)
    else:
        out, _, rt = MOE.moe_ffn(p["moe"], h, cfg, groups=groups,
                                 return_routing=True)
        routing.append(rt)
    return x + out


def _ssm_layer(p, x, cfg):
    return x + SSM.ssm_block(p["ssm"], L.rmsnorm(p["ln"], x), cfg)


def _with_shared_block(layer_fn: Callable, shared_fn: Callable,
                       every: int) -> Callable:
    """``layer_fn`` for a layer loop that runs in order, followed after
    every ``every``-th layer by ``shared_fn(carry, g)``, g the invocation
    (0, 1, ...)."""
    done = 0

    def body(carry, p):
        nonlocal done
        carry = layer_fn(carry, p)
        done += 1
        if done % every == 0:
            carry = shared_fn(carry, done // every - 1)
        return carry

    return body


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``gen`` (on its device) with the
    reference's shapes and scales, then moved to ``device``."""
    _require_served(cfg, "init_params")
    dev = resolve_device(device)
    p: Params = {
        "embed": L.embed_init(gen, cfg),
        "ln_f": L.rmsnorm_init(cfg.d_model, cfg.dtype, device=gen.device),
    }
    if cfg.family in ("dense", "vlm"):
        p["layers"] = _dense_layer_init(gen, cfg, cfg.n_layers)
    elif cfg.family == "moe":
        if cfg.first_k_dense:
            p["dense_layers"] = _dense_layer_init(gen, cfg, cfg.first_k_dense)
        p["layers"] = _moe_layer_init(gen, cfg,
                                      cfg.n_layers - cfg.first_k_dense)
    else:
        p["layers"] = _ssm_layer_init(gen, cfg, cfg.n_layers)
    if cfg.family == "hybrid":
        p["shared_attn"] = _dense_layer_init(gen, cfg)
    if cfg.mtp_depth:
        d = cfg.d_model
        p["mtp"] = {
            "proj": L._init(gen, (2 * d, d), cfg.dtype),
            "layer": _dense_layer_init(gen, cfg),
            "ln": L.rmsnorm_init(d, cfg.dtype, device=gen.device),
        }
    return map_leaves(lambda _k, t: t.to(dev), p)


def _engine(plan: PlacementPlan | None,
            dev: torch.device) -> HostFetchEngine | None:
    """The copy engine of a host-offload plan with REMOTE leaves: unpaced,
    so a transfer costs only its real copy."""
    if plan is None or not plan.remote_names():
        return None
    return HostFetchEngine(throttle=0.0, device=dev)


def _fetched(params: Params, key: str, engine: HostFetchEngine | None,
             remote: frozenset[str]) -> Params:
    """``params[key]``, a subtree used whole outside the layer loop, with
    the leaves the plan made REMOTE fetched through ``engine`` in one read
    at this use."""
    sub = params[key]
    prefix = f"[{key!r}]"
    names = {k[len(prefix):] for k in remote if k.startswith(prefix)}
    if not names:
        return sub
    leaves = dict(_leaves_with_keys(sub))
    got = engine.acquire(engine.fetch(
        key, {k: leaves[k] for k in names}, pace=False))
    return map_leaves(lambda k, t: got.get(k, t), sub)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_trunk(params, x, positions, cfg: ModelConfig, *, prefetch: bool,
               engine, remote, plan, moe_groups: int | None = None):
    """The layer loops; returns (hidden, aux_loss). The hybrid's shared
    block is fetched once here."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def scan(fn, carry, key: str, n: int):
        return tiered_scan(fn, carry, params[key], n_layers=n,
                           prefetch=prefetch, engine=engine,
                           remote=remote_keys(plan, f"params[{key!r}]"))

    if cfg.family == "moe":
        nd = cfg.first_k_dense
        if nd:
            x = scan(lambda c, p: _dense_layer(p, c, cfg, positions), x,
                     "dense_layers", nd)

        def moe_body(carry, p):
            xx, a = carry
            xx, a_l = _moe_layer(p, xx, cfg, positions, groups=moe_groups)
            return xx, a + a_l

        return scan(moe_body, (x, aux), "layers", cfg.n_layers - nd)
    if cfg.family in ("dense", "vlm"):
        fn = lambda c, p: _dense_layer(p, c, cfg, positions)  # noqa: E731
    else:
        fn = lambda c, p: _ssm_layer(p, c, cfg)  # noqa: E731
    if cfg.family == "hybrid":
        shared = _fetched(params, "shared_attn", engine, remote)
        fn = _with_shared_block(
            fn, lambda c, _g: _dense_layer(shared, c, cfg, positions),
            cfg.hybrid_attn_every)
    return scan(fn, x, "layers", cfg.n_layers), aux


def forward(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    prefetch: bool = True,
    plan: PlacementPlan | None = None,
    moe_groups: int | None = None,
):
    """Full-sequence forward on the device of ``batch["tokens"]``.

    Returns (logits[B,S_tokens,V_padded] float32, aux_loss): for the vlm
    family the patch embeddings (``batch["patches"]``, (B, F, d)) are
    prepended and only text positions give logits; ``aux_loss`` is the moe
    family's load-balance loss summed over the MoE layers (0 for the
    others), ``moe_groups`` its dispatch groups (a batch row each by
    default). ``plan`` names the REMOTE leaves of params placed by
    :func:`~repro_torch.core.tiering.place_params`; ``prefetch`` turns the
    layer loops' dual buffer on.
    """
    _require_served(cfg, "forward")
    tokens = batch["tokens"]
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    try:
        x = L.embed(_fetched(params, "embed", engine, remote), tokens, cfg)
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, aux = _run_trunk(params, x, positions, cfg, prefetch=prefetch,
                            engine=engine, remote=remote, plan=plan,
                            moe_groups=moe_groups)
        x = L.rmsnorm(_fetched(params, "ln_f", engine, remote), x)
        if cfg.family == "vlm":
            x = x[:, batch["patches"].shape[1]:]
        logits = L.logits(_fetched(params, "embed", engine, remote), x, cfg)
    finally:
        if engine is not None:
            engine.close()
    return logits, aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """KV caches sized for ``max_len`` context (a ``sliding_window`` ring
    for SWA; MLA's compressed latent ``c`` and ``kr``), the SSM layers'
    recurrent state (O(1) in ``max_len``), and the decode position ``pos``
    (a 0-d tensor; a ``(batch,)`` vector decodes every lane at its own
    position)."""
    _require_served(cfg, "init_decode_cache")
    dev = resolve_device(device)
    nL = cfg.n_layers
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    kv = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ("dense", "vlm", "moe") and cfg.attention == "mla":
        cache["c"] = zeros(nL, batch, max_len, cfg.kv_lora_rank)
        cache["kr"] = zeros(nL, batch, max_len, cfg.qk_rope_head_dim)
        return cache
    if cfg.family in ("dense", "vlm", "moe"):
        S_c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        cache["k"] = zeros(nL, batch, S_c, *kv)
        cache["v"] = zeros(nL, batch, S_c, *kv)
        return cache
    st = SSM.ssm_decode_init(cfg, batch, device=dev)
    cache["conv"] = zeros(nL, *st["conv"].shape, dtype=st["conv"].dtype)
    cache["state"] = zeros(nL, *st["state"].shape, dtype=st["state"].dtype)
    if cfg.family == "hybrid":
        n_inv = nL // cfg.hybrid_attn_every
        cache["shared_k"] = zeros(n_inv, batch, max_len, *kv)
        cache["shared_v"] = zeros(n_inv, batch, max_len, *kv)
    return cache


def decode_step(
    params: Params, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
    *, prefetch: bool = True, plan: PlacementPlan | None = None,
    moe_groups: int | None = None, return_routing: bool = False,
):
    """One-token decode. tokens: (B, 1). Returns (logits[B,1,V], new cache).

    The layer loops are :func:`tiered_scan` over the stacked params and the
    stacked per-layer caches, so a host-offload ``plan`` streams the
    weights here too. The KV caches (``k``, ``v``, ``shared_k``,
    ``shared_v``) and MLA's latent caches (``c``, ``kr``) are written in
    place: the returned cache holds the same tensors as ``cache``, and a
    re-run of the step on ``cache`` rewrites the same slots with the same
    values. The SSM layers' ``conv`` and ``state`` are new tensors, as in
    the reference.

    ``moe_groups`` are the MoE layers' dispatch groups. With
    ``return_routing`` a third element is appended: for the moe family
    ``{"top_i": (nL_moe, B, 1, k), "top_p": (nL_moe, B, 1, k)}``, the
    router decision of each MoE layer stacked in order (the serving
    engine's expert pager validates residency against it and feeds its
    router-mass EMA from it); None for the other families.
    """
    _require_served(cfg, "decode_step")
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    pos = cache["pos"]
    new: dict = {}
    routing = [] if return_routing and cfg.family == "moe" else None

    def scan(body, x, key: str, caches: dict, n: int):
        layer_remote = frozenset(
            "['p']" + k for k in remote_keys(plan, f"params[{key!r}]"))
        return tiered_scan(body, x, {"p": params[key], **caches}, n_layers=n,
                           prefetch=prefetch, engine=engine,
                           remote=layer_remote)

    try:
        x = L.embed(_fetched(params, "embed", engine, remote), tokens, cfg)
        if cfg.family in ("dense", "vlm", "moe"):
            names = ("c", "kr") if cfg.attention == "mla" else ("k", "v")
            body = lambda xx, sl: _block_decode(  # noqa: E731
                sl["p"], xx, sl, pos, cfg, groups=moe_groups,
                routing=routing)
            nd = cfg.first_k_dense if "dense_layers" in params else 0
            if nd:
                x = scan(body, x, "dense_layers",
                         {n: cache[n][:nd] for n in names}, nd)
            x = scan(body, x, "layers", {n: cache[n][nd:] for n in names},
                     cfg.n_layers - nd)
        else:
            new_conv, new_state = [], []

            def body(xx, sl):
                h = L.rmsnorm(sl["p"]["ln"], xx)
                o, st = SSM.ssm_decode_step(
                    sl["p"]["ssm"], h, {"conv": sl["conv"],
                                        "state": sl["state"]}, cfg)
                new_conv.append(st["conv"])
                new_state.append(st["state"])
                return xx + o

            if cfg.family == "hybrid":
                shared = _fetched(params, "shared_attn", engine, remote)
                body = _with_shared_block(
                    body, lambda xx, g: _block_decode(
                        shared, xx, {"k": cache["shared_k"][g],
                                     "v": cache["shared_v"][g]}, pos, cfg),
                    cfg.hybrid_attn_every)
            x = scan(body, x, "layers", {"conv": cache["conv"],
                                         "state": cache["state"]},
                     cfg.n_layers)
            new = {"conv": torch.stack(new_conv),
                   "state": torch.stack(new_state)}
        x = L.rmsnorm(_fetched(params, "ln_f", engine, remote), x)
        logits = L.logits(_fetched(params, "embed", engine, remote), x, cfg)
    finally:
        if engine is not None:
            engine.close()
    cache = {**cache, **new, "pos": pos + 1}
    if not return_routing:
        return logits, cache
    if routing is not None:
        routing = {"top_i": torch.stack([rt[0] for rt in routing]),
                   "top_p": torch.stack([rt[1] for rt in routing])}
    return logits, cache, routing
