"""Model assembly: the dense, vlm, ssm and hybrid families.

A port of ``repro.models.transformer``, with the same public API:

  init_params(gen, cfg, device=)           -> params (nested dicts)
  forward(params, batch, cfg, ...)         -> (logits, aux)
  init_decode_cache(cfg, batch, max_len)   -> cache
  decode_step(params, cache, tokens, cfg)  -> (logits, cache)

Layers are *stacked* (leading dim = n_layers) and driven by
:func:`repro_torch.core.tiering.tiered_scan`, DOLMA's dual buffer over
layers: with a host-offload plan (``plan=``, from
:func:`~repro_torch.core.tiering.place_params`) layer i+1's REMOTE weights
are copied from pinned host memory while layer i computes. REMOTE leaves
outside the stack are fetched where they are used: the embedding at each
use, the hybrid's shared block once a forward or decode step. Every
placement computes the same values: its logits are bit-identical to the
all-local run's.

The hybrid family (zamba2) runs its Mamba2 stack in one layer loop and
applies the shared attention block after every ``hybrid_attn_every``-th
layer: the reference's groups, each followed by the shared block, then the
tail, computed in the same order, while the dual buffer also fetches
across the shared block.

The moe family waits for ROADMAP A7, the enc-dec family for A9, and so do
``loss_fn`` and the remat options (A9).
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
from repro_torch.models import ssm as SSM

Params = dict[str, Any]

_WAITS_FOR = {
    "moe": "ROADMAP A7 (MoE and MLA)",
    "encdec": "ROADMAP A9 (models/encdec.py)",
    "audio": "ROADMAP A9 (models/encdec.py)",
}


def _require_served(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "vlm", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{what}: the {cfg.family} family waits for "
            f"{_WAITS_FOR.get(cfg.family, 'its slice')}")


# ---------------------------------------------------------------------------
# layers and init
# ---------------------------------------------------------------------------

def _dense_layer_init(gen: torch.Generator, cfg: ModelConfig,
                      n: int | None = None) -> Params:
    """One attention + MLP block, or ``n`` of them stacked."""
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": L.rmsnorm_init(d, cfg.dtype, stack=n, device=dev),
        "ln2": L.rmsnorm_init(d, cfg.dtype, stack=n, device=dev),
        "attn": L.attention_init(gen, cfg, stack=n),
        "mlp": L.mlp_init(gen, cfg, stack=n),
    }


def _ssm_layer_init(gen: torch.Generator, cfg: ModelConfig,
                    n: int) -> Params:
    return {
        "ln": L.rmsnorm_init(cfg.d_model, cfg.dtype, stack=n, device=gen.device),
        "ssm": SSM.ssm_init(gen, cfg, stack=n),
    }


def _dense_layer(p, x, cfg, positions):
    x = x + L.gqa_attention(p["attn"], L.rmsnorm(p["ln1"], x), cfg,
                            positions=positions)
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x))


def _dense_decode(p, x, cache_k, cache_v, pos, cfg):
    """One block's decode step; writes its new K/V into the caches."""
    o, _, _ = L.gqa_decode_step(p["attn"], L.rmsnorm(p["ln1"], x), cache_k,
                                cache_v, pos, cfg)
    x = x + o
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x))


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
    else:
        p["layers"] = _ssm_layer_init(gen, cfg, cfg.n_layers)
    if cfg.family == "hybrid":
        p["shared_attn"] = _dense_layer_init(gen, cfg)
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
               engine, remote, plan):
    """The layer loop; the hybrid's shared block is fetched once here."""
    if cfg.family in ("dense", "vlm"):
        fn = lambda c, p: _dense_layer(p, c, cfg, positions)  # noqa: E731
    else:
        fn = lambda c, p: _ssm_layer(p, c, cfg)  # noqa: E731
    if cfg.family == "hybrid":
        shared = _fetched(params, "shared_attn", engine, remote)
        fn = _with_shared_block(
            fn, lambda c, _g: _dense_layer(shared, c, cfg, positions),
            cfg.hybrid_attn_every)
    return tiered_scan(fn, x, params["layers"], n_layers=cfg.n_layers,
                       prefetch=prefetch, engine=engine,
                       remote=remote_keys(plan, "params['layers']"))


def forward(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    prefetch: bool = True,
    plan: PlacementPlan | None = None,
):
    """Full-sequence forward on the device of ``batch["tokens"]``.

    Returns (logits[B,S_tokens,V_padded] float32, aux_loss): for the vlm
    family the patch embeddings (``batch["patches"]``, (B, F, d)) are
    prepended and only text positions give logits. ``plan`` names the
    REMOTE leaves of params placed by
    :func:`~repro_torch.core.tiering.place_params`; ``prefetch`` turns the
    layer loop's dual buffer on.
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
        x = _run_trunk(params, x, positions, cfg, prefetch=prefetch,
                       engine=engine, remote=remote, plan=plan)
        x = L.rmsnorm(_fetched(params, "ln_f", engine, remote), x)
        if cfg.family == "vlm":
            x = x[:, batch["patches"].shape[1]:]
        logits = L.logits(_fetched(params, "embed", engine, remote), x, cfg)
    finally:
        if engine is not None:
            engine.close()
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """KV caches sized for ``max_len`` context (a ``sliding_window`` ring
    for SWA), the SSM layers' recurrent state (O(1) in ``max_len``), and
    the decode position ``pos`` (a 0-d tensor; a ``(batch,)`` vector
    decodes every lane at its own position)."""
    _require_served(cfg, "init_decode_cache")
    dev = resolve_device(device)
    nL = cfg.n_layers
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    kv = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ("dense", "vlm"):
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
):
    """One-token decode. tokens: (B, 1). Returns (logits[B,1,V], new cache).

    The layer loop is :func:`tiered_scan` over the stacked params and the
    stacked per-layer caches, so a host-offload ``plan`` streams the
    weights here too. The KV caches (``k``, ``v``, ``shared_k``,
    ``shared_v``) are written in place: the returned cache holds the same
    tensors as ``cache``. The SSM layers' ``conv`` and ``state`` are new
    tensors, as in the reference.
    """
    _require_served(cfg, "decode_step")
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    layer_remote = frozenset(
        "['p']" + k for k in remote_keys(plan, "params['layers']"))
    pos = cache["pos"]
    new: dict = {}
    try:
        x = L.embed(_fetched(params, "embed", engine, remote), tokens, cfg)
        if cfg.family in ("dense", "vlm"):
            stacked = {"p": params["layers"], "k": cache["k"],
                       "v": cache["v"]}
            body = lambda xx, sl: _dense_decode(  # noqa: E731
                sl["p"], xx, sl["k"], sl["v"], pos, cfg)
        else:
            stacked = {"p": params["layers"], "conv": cache["conv"],
                       "state": cache["state"]}
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
                    body, lambda xx, g: _dense_decode(
                        shared, xx, cache["shared_k"][g],
                        cache["shared_v"][g], pos, cfg),
                    cfg.hybrid_attn_every)
        x = tiered_scan(body, x, stacked, n_layers=cfg.n_layers,
                        prefetch=prefetch, engine=engine, remote=layer_remote)
        if cfg.family not in ("dense", "vlm"):
            new = {"conv": torch.stack(new_conv),
                   "state": torch.stack(new_state)}
        x = L.rmsnorm(_fetched(params, "ln_f", engine, remote), x)
        logits = L.logits(_fetched(params, "embed", engine, remote), x, cfg)
    finally:
        if engine is not None:
            engine.close()
    return logits, {**cache, **new, "pos": pos + 1}
