"""Encoder-decoder backbone (seamless-m4t-medium).

A port of ``repro.models.encdec``, in the API of
:mod:`repro_torch.models.transformer`:

  init_params(gen, cfg, device=)               -> params (nested dicts)
  encode(params, frames, cfg, ...)             -> encoder output
  forward(params, batch, cfg, ...)             -> (logits, aux=0)
  loss_fn(params, batch, cfg, ...)             -> (loss, metrics)
  init_decode_cache(cfg, batch, max_len)       -> cache
  prefill(params, cache, frames, cfg)          -> cache with cross K/V
  decode_step(params, cache, tokens, cfg)      -> (logits[B,1,V], cache)

The audio frontend is a stub, as in the reference: batches carry
precomputed frame embeddings ``frames: (B, F, d_model)``. The encoder
(full self-attention over the frames) and the decoder (causal
self-attention, cross attention to the encoder output, MLP) are stacked
layers driven by :func:`~repro_torch.core.tiering.tiered_scan` through
:func:`~repro_torch.models.transformer.scan_stacked_layers`, each loop its
own dual buffer: a host-offload plan (``plan=``) streams either stack's
REMOTE weights, and ``remat`` checkpoints both loops. All three attentions
of the forward go through the models' flash (kernel B2 on a card: full
over the frames, causal over the tokens, full with Sq != Sk across).

The decoder reads the encoder output in every layer: the layer body
closes over it, so a non-reentrant checkpoint saves no copy of it (the
ops that save it inside a boundary are recomputed) and its gradient
reaches the encoder through the forward's own graph.

Decode runs cross attention against per-layer K and V that
:func:`prefill` computes once from the encoder output, through the plain
:func:`~repro_torch.models.layers._sdpa` with a full mask, as the
reference does; its self-attention is :func:`~repro_torch.models.layers.
gqa_decode_step`, whose K/V writes follow the reference's (C6).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import HostFetchEngine, resolve_device
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.tiering import (
    RemoteGrads,
    map_leaves,
    peer_keys,
    remote_keys,
    tiered_scan,
)
from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain, replicate_like
from repro_torch.models.transformer import (
    _dense_layer_init,
    _engine,
    _fetched,
    _Fetcher,
    scan_stacked_layers,
)

Params = dict[str, Any]


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``gen`` (on its device) with the
    reference's shapes and scales, then moved to ``device``. A decoder
    layer is an encoder layer (``ln1``, ``ln2``, ``attn``, ``mlp``) plus
    the cross attention's norm ``ln_x`` and projections ``cross``."""
    dev, d, n = resolve_device(device), cfg.d_model, cfg.n_layers
    dec = _dense_layer_init(gen, cfg, n)
    dec["ln_x"] = L.rmsnorm_init(d, cfg.dtype, stack=n, device=gen.device)
    dec["cross"] = L.attention_init(gen, cfg, stack=n)
    p: Params = {
        "embed": L.embed_init(gen, cfg),
        "enc_layers": _dense_layer_init(gen, cfg, cfg.n_encoder_layers),
        "dec_layers": dec,
        "ln_enc": L.rmsnorm_init(d, cfg.dtype, device=gen.device),
        "ln_f": L.rmsnorm_init(d, cfg.dtype, device=gen.device),
    }
    return map_leaves(lambda _k, t: t.to(dev), p)


def _positions(B: int, S: int, like: torch.Tensor) -> torch.Tensor:
    """(B, S) positions on ``like``'s device (replicated on its mesh when
    ``like`` is a DTensor)."""
    return replicate_like(torch.arange(S, device=like.device).expand(B, S),
                          like)


def _encode(frames, cfg: ModelConfig, fetch: _Fetcher, *, remat: str,
            prefetch: bool, prefetch_under_remat: bool) -> torch.Tensor:
    """The encoder over ``fetch``'s placement: (B, F, d) frames -> (B, F,
    d) in the model's dtype."""
    B, F, _ = frames.shape
    positions = _positions(B, F, frames)
    x = constrain(frames.to(cfg.dtype), "batch", "seq_sp", None)

    def layer(c, p):
        c = c + L.as_carry(L.gqa_attention(p["attn"], L.whole_seq(L.rmsnorm(
            p["ln1"], c)), cfg, positions=positions, causal=False))
        c = c + L.as_carry(L.mlp(p["mlp"], L.whole_seq(L.rmsnorm(
            p["ln2"], c))))
        return constrain(c, "batch", "seq_sp", None)

    x = scan_stacked_layers(
        layer, x, fetch.params["enc_layers"],
        cfg.n_encoder_layers, remat=remat, prefetch=prefetch,
        prefetch_under_remat=prefetch_under_remat,
        **fetch.scan_kw("enc_layers"))
    return L.whole_seq(L.rmsnorm(fetch("ln_enc"), x))


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: str = "none", prefetch: bool = True,
           prefetch_under_remat: bool = True,
           plan: PlacementPlan | None = None,
           engine: HostFetchEngine | None = None) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> encoder output (B, F, d), on
    the frames' device; ``plan`` and ``engine`` as in :func:`forward`."""
    fetch = _Fetcher(params, plan, frames.device, engine, None)
    enc = None
    try:
        enc = _encode(frames, cfg, fetch, remat=remat, prefetch=prefetch,
                      prefetch_under_remat=prefetch_under_remat)
    finally:
        fetch.close(enc)
    return enc


def _forward(params, batch, cfg: ModelConfig, fetch: _Fetcher, *, remat: str,
             prefetch: bool, prefetch_under_remat: bool) -> torch.Tensor:
    enc = _encode(batch["frames"], cfg, fetch, remat=remat, prefetch=prefetch,
                  prefetch_under_remat=prefetch_under_remat)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens)
    x = constrain(L.embed(fetch("embed"), tokens, cfg), "batch", "seq_sp",
                  None)

    def layer(c, p):
        c = c + L.as_carry(L.gqa_attention(p["attn"], L.whole_seq(L.rmsnorm(
            p["ln1"], c)), cfg, positions=positions, causal=True))
        c = c + L.as_carry(L.gqa_attention(p["cross"], L.whole_seq(
            L.rmsnorm(p["ln_x"], c)), cfg, positions=positions, kv=enc))
        c = c + L.as_carry(L.mlp(p["mlp"], L.whole_seq(L.rmsnorm(
            p["ln2"], c))))
        return constrain(c, "batch", "seq_sp", None)

    x = scan_stacked_layers(
        layer, x, params["dec_layers"], cfg.n_layers, remat=remat,
        prefetch=prefetch, prefetch_under_remat=prefetch_under_remat,
        **fetch.scan_kw("dec_layers"))
    x = L.rmsnorm(fetch("ln_f"), x)
    return L.logits(fetch("embed"), x, cfg)


def forward(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    remat: str = "none",
    prefetch: bool = True,
    prefetch_under_remat: bool = True,
    plan: PlacementPlan | None = None,
    engine: HostFetchEngine | None = None,
    remote_grads: RemoteGrads | None = None,
    **_kw,
):
    """batch: ``frames`` (B, F, d), ``tokens`` (B, S), on the device of
    the tokens. Returns (logits[B,S,V_padded] float32, aux = 0). The other
    arguments are :func:`repro_torch.models.transformer.forward`'s."""
    dev = batch["tokens"].device
    fetch = _Fetcher(params, plan, dev, engine, remote_grads)
    logits = None
    try:
        logits = _forward(params, batch, cfg, fetch, remat=remat,
                          prefetch=prefetch,
                          prefetch_under_remat=prefetch_under_remat)
    finally:
        fetch.close(logits)
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


def loss_fn(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    remat: str = "full",
    prefetch: bool = True,
    prefetch_under_remat: bool = True,
    plan: PlacementPlan | None = None,
    engine: HostFetchEngine | None = None,
    remote_grads: RemoteGrads | None = None,
    **_kw,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of the decoder -> (nll, {"nll", "aux"});
    the arguments as in :func:`forward`."""
    logits, aux = forward(params, batch, cfg, remat=remat, prefetch=prefetch,
                          prefetch_under_remat=prefetch_under_remat,
                          plan=plan, engine=engine, remote_grads=remote_grads)
    nll = L.cross_entropy(logits[:, :-1].float(), batch["labels"][:, 1:])
    return nll, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """The decoder's self-attention K/V caches for ``max_len`` tokens, the
    cross-attention K/V over ``frontend_len`` frames (``ck``, ``cv``,
    filled by :func:`prefill`) and the decode position ``pos``."""
    dev = resolve_device(device)
    nL, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    F = cfg.frontend_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "k": zeros(nL, batch, max_len, KV, Dh),
            "v": zeros(nL, batch, max_len, KV, Dh),
            "ck": zeros(nL, batch, F, KV, Dh),
            "cv": zeros(nL, batch, F, KV, Dh)}


def _layer_scan(body, x, params: Params, caches: dict, cfg: ModelConfig,
                plan: PlacementPlan | None, engine, prefetch: bool,
                sub: tuple[str, ...] = ()):
    """``tiered_scan`` of ``body`` over the decoder layers' parameters
    (``params["dec_layers"]``, or its subtree at the path ``sub``) as
    ``"p"`` beside the stacked per-layer ``caches``: a plan's REMOTE
    leaves among them are streamed through ``engine``."""
    tree, prefix = params["dec_layers"], "params['dec_layers']"
    for k in sub:
        tree, prefix = tree[k], prefix + f"[{k!r}]"
    layer_remote = frozenset("['p']" + k for k in remote_keys(plan, prefix))
    layer_peer = {"['p']" + k: a for k, a in peer_keys(plan, prefix).items()}
    return tiered_scan(body, x, {"p": tree, **caches}, n_layers=cfg.n_layers,
                       prefetch=prefetch, engine=engine, remote=layer_remote,
                       peer=layer_peer)


def prefill(params: Params, cache: dict, frames: torch.Tensor,
            cfg: ModelConfig, *, plan: PlacementPlan | None = None,
            prefetch: bool = True) -> dict:
    """Encode the source and compute each decoder layer's cross K and V
    from the encoder output, written into ``cache["ck"]`` and
    ``cache["cv"]`` in place (the returned cache holds the same tensors).
    ``plan`` streams REMOTE weights as in :func:`forward`."""
    engine = _engine(plan, frames.device)
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    try:
        enc = encode(params, frames, cfg, plan=plan, engine=engine,
                     prefetch=prefetch)
        shape = (*enc.shape[:2], KV, Dh)

        def body(_c, sl):
            sl["ck"].copy_((enc @ sl["p"]["wk"]).reshape(shape))
            sl["cv"].copy_((enc @ sl["p"]["wv"]).reshape(shape))
            return _c

        _layer_scan(body, None, params, {"ck": cache["ck"], "cv": cache["cv"]},
                    cfg, plan, engine, prefetch, sub=("cross",))
    finally:
        if engine is not None:
            engine.close()
    return {**cache}


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, *, prefetch: bool = True,
                plan: PlacementPlan | None = None, **_kw):
    """One-token decode after :func:`prefill`. tokens: (B, 1). Returns
    (logits[B,1,V], new cache). The self-attention K/V caches are written
    in place, as in :func:`repro_torch.models.transformer.decode_step`;
    the decoder layers are a ``tiered_scan`` over the weights and the four
    stacked caches, so a host-offload ``plan`` streams the weights here
    too."""
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    pos = cache["pos"]
    B = tokens.shape[0]
    H, Dh, F = cfg.n_heads, cfg.head_dim, cache["ck"].shape[2]
    positions = pos.reshape(B, 1) if pos.ndim else pos.reshape(1, 1).expand(
        B, 1)
    full = torch.ones((1, 1, 1, F), dtype=torch.bool, device=tokens.device)

    def body(xx, sl):
        p = sl["p"]
        o, _, _ = L.gqa_decode_step(p["attn"], L.rmsnorm(p["ln1"], xx),
                                    sl["k"], sl["v"], pos, cfg)
        xx = xx + o
        # cross attention against the precomputed encoder K/V, full mask
        h = L.rmsnorm(p["ln_x"], xx)
        q = L.rope(L._split_heads(h @ p["cross"]["wq"], H, Dh), positions,
                   cfg.rope_theta)
        o = L._sdpa(q, sl["ck"], sl["cv"], full, cfg)
        xx = xx + o.reshape(B, 1, H * Dh) @ p["cross"]["wo"]
        return xx + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], xx))

    try:
        x = L.embed(_fetched(params, "embed", engine, remote), tokens, cfg)
        x = _layer_scan(body, x, params,
                        {n: cache[n] for n in ("k", "v", "ck", "cv")}, cfg,
                        plan, engine, prefetch)
        x = L.rmsnorm(_fetched(params, "ln_f", engine, remote), x)
        logits = L.logits(_fetched(params, "embed", engine, remote), x, cfg)
    finally:
        if engine is not None:
            engine.close()
    return logits, {**cache, "pos": pos + 1}
