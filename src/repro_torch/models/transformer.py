"""Model assembly: the dense, vlm, moe, ssm and hybrid families.

A port of ``repro.models.transformer``, with the same public API:

  init_params(gen, cfg, device=)           -> params (nested dicts)
  forward(params, batch, cfg, ...)         -> (logits, aux)
  loss_fn(params, batch, cfg, ...)         -> (loss, metrics)
  init_decode_cache(cfg, batch, max_len)   -> cache
  decode_step(params, cache, tokens, cfg)  -> (logits, cache[, routing])

Layers are *stacked* (leading dim = n_layers) and driven by
:func:`repro_torch.core.tiering.tiered_scan`, DOLMA's dual buffer over
layers: with a host-offload plan (``plan=``, from
:func:`~repro_torch.core.tiering.place_params`) layer i+1's REMOTE weights
are copied from pinned host memory while layer i computes. REMOTE leaves
outside the stack are fetched where they are used: the embedding at each
use, the hybrid's shared block once a forward or decode step (when the
caller trains, each such subtree once a forward, so that its gradient
gathers in one node). Every placement computes the same values: its logits
are bit-identical to the all-local run's, and so are the loss and the
gradients of :func:`loss_fn`.

``remat`` names a checkpoint policy (:data:`REMAT_POLICIES`, with an
optional ``_flat`` suffix) for the layer loops, the reference's
``jax.checkpoint`` policies in ``torch.utils.checkpoint`` terms:
``"full"`` saves nothing inside a boundary, ``"dots"`` the outputs of the
matrix products (``aten.mm``/``bmm``/``addmm``), ``"dots_no_batch"`` those
of the unbatched ones (``mm``/``addmm``).

The attention block is GQA (:mod:`repro_torch.models.layers`) or MLA
(:mod:`repro_torch.models.mla`, ``cfg.attention == "mla"``). The moe family
(deepseek-v3, mixtral) runs two layer loops, each its own dual buffer: the
``first_k_dense`` attention + MLP blocks (``dense_layers``), then the
attention + MoE blocks (``layers``, :mod:`repro_torch.models.moe`), whose
load-balance losses sum into ``aux``. Its ``mtp`` block (deepseek-v3's
multi-token prediction) runs only in :func:`loss_fn`.

The hybrid family (zamba2) runs its Mamba2 stack in one layer loop and
applies the shared attention block after every ``hybrid_attn_every``-th
layer: the reference's groups, each followed by the shared block, then the
tail, computed in the same order, while the dual buffer also fetches
across the shared block. The layer body is given its layer index, so a
recompute of any layer or block applies the shared block after the same
layers.

The enc-dec family lives in :mod:`repro_torch.models.encdec`, which
drives its two layer loops through :func:`scan_stacked_layers` and
:class:`_Fetcher`.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.distributed.tensor import Replicate
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import HostFetchEngine, resolve_device
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.tiering import (
    RemoteGrads,
    host_names,
    like_global,
    local_part,
    map_leaves,
    peer_keys,
    remote_carry_placer,
    remote_keys,
    tiered_scan,
)
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.sharding import (
    constrain,
    current_mesh,
    is_dtensor,
    replicate_like,
    resolve_spec,
)

Params = dict[str, Any]

def _saving(*ops) -> Callable:
    """A checkpoint ``context_fn`` that saves the outputs of ``ops`` and
    recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


_aten = torch.ops.aten
#: The reference's ``jax.checkpoint`` policies as checkpoint ``context_fn``s
#: (None: no checkpoint).
REMAT_POLICIES = {
    "none": None,
    "full": noop_context_fn,
    "dots": _saving(_aten.mm.default, _aten.bmm.default, _aten.addmm.default),
    "dots_no_batch": _saving(_aten.mm.default, _aten.addmm.default),
}


def scan_stacked_layers(fn, carry, stacked, n_layers: int, *, remat: str,
                        prefetch: bool, prefetch_under_remat: bool = True,
                        **scan_kw):
    """Map a remat policy string onto :func:`tiered_scan`.

    ``remat`` is a :data:`REMAT_POLICIES` key, optionally suffixed
    ``_flat``: ``'<policy>_flat'`` checkpoints each layer alone (one
    forward and one recompute, against sqrt-L's two, at O(L) saved
    carries). Under remat the dual buffer runs only with
    ``prefetch and prefetch_under_remat``. ``scan_kw`` goes to
    :func:`tiered_scan` (the placement's ``remote`` leaves and ``engine``).
    Under a mesh the saved block carries take their logical placements
    (:func:`_activation_carry_placer`). The hybrid's shared block runs
    inside its layer's checkpoint, where the reference checkpoints it on
    its own.
    """
    if remat == "none":
        return tiered_scan(fn, carry, stacked, n_layers=n_layers,
                           prefetch=prefetch, **scan_kw)
    flat = remat.endswith("_flat")
    return tiered_scan(
        fn, carry, stacked, n_layers=n_layers, remat=True,
        policy=REMAT_POLICIES[remat.removesuffix("_flat")],
        prefetch=prefetch and prefetch_under_remat,
        min_layers=10 ** 9 if flat else 12,
        remote_carry_fn=_activation_carry_placer(), **scan_kw)


def _activation_carry_placer():
    """The layer loop's ``remote_carry_fn`` for its saved block carries:
    under a mesh, each carry leaf is constrained to its logical
    (``batch``, ``seq_sp``) spec, so that saved activations are split like
    the weights (:func:`~repro_torch.core.tiering.remote_carry_placer`);
    None without one."""
    mesh = current_mesh()
    if mesh is None:
        return None

    def spec_fn(leaf):
        names = ("batch", "seq_sp") + (None,) * (leaf.ndim - 2)
        return resolve_spec(leaf.shape, names, mesh)

    return remote_carry_placer(mesh, spec_fn=spec_fn)


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
    h = L.whole_seq(L.rmsnorm(p["ln1"], x))
    if cfg.attention == "mla":
        return x + L.as_carry(MLA.mla_attention(p["attn"], h, cfg,
                                                positions=positions))
    return x + L.as_carry(L.gqa_attention(p["attn"], h, cfg,
                                          positions=positions))


def _dense_layer(p, x, cfg, positions):
    x = _attention_part(p, x, cfg, positions)
    x = x + L.as_carry(L.mlp(p["mlp"], L.whole_seq(L.rmsnorm(p["ln2"], x))))
    return constrain(x, "batch", "seq_sp", None)


def _moe_layer(p, x, cfg, positions, groups=None):
    x = _attention_part(p, x, cfg, positions)
    out, aux = MOE.moe_ffn(p["moe"], L.rmsnorm(p["ln2"], x), cfg,
                           groups=groups)
    return constrain(x + L.as_carry(out), "batch", "seq_sp", None), aux


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
    x = x + L.as_carry(SSM.ssm_block(p["ssm"], L.whole_seq(L.rmsnorm(
        p["ln"], x)), cfg))
    return constrain(x, "batch", "seq_sp", None)


def _with_shared_block(layer_fn: Callable, shared_fn: Callable,
                       every: int) -> Callable:
    """The body ``(carry, p, i)`` of a layer loop run with its layer index:
    layer ``i``, then ``shared_fn(carry, g)`` after every ``every``-th
    layer, ``g = (i + 1) // every - 1`` the invocation (0, 1, ...). It
    depends on ``i`` alone, so a recompute of any layer applies the shared
    block where the first run did."""

    def body(carry, p, i: int):
        carry = layer_fn(carry, p)
        if (i + 1) % every == 0:
            carry = shared_fn(carry, (i + 1) // every - 1)
        return carry

    return body


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``gen`` (on its device) with the
    reference's shapes and scales, then moved to ``device``."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(
            f"init_params: family {cfg.family} handled in encdec.py")
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
    if not host_names(plan):
        return None
    return HostFetchEngine(throttle=0.0, device=dev)


def _fetched(params: Params, key: str, engine: HostFetchEngine | None,
             remote: frozenset[str], grads: RemoteGrads | None = None
             ) -> Params:
    """``params[key]``, a subtree used whole outside the layer loop, with
    the leaves the plan made REMOTE fetched through ``engine`` in one read
    at this use (and attached to ``grads`` when the caller trains)."""
    sub = params[key]
    prefix = f"[{key!r}]"
    names = {k[len(prefix):] for k in remote if k.startswith(prefix)}
    if not names:
        return sub
    leaves = dict(_leaves_with_keys(sub))
    got = engine.acquire(engine.fetch(
        key, {k: local_part(leaves[k]).detach() for k in names}, pace=False))
    if grads is not None:
        got = {k: grads.attach("params" + prefix + k, None, t,
                               local_part(leaves[k]).shape)
               for k, t in got.items()}
    got = {k: like_global(t, leaves[k]) for k, t in got.items()}
    return map_leaves(lambda k, t: got.get(k, t), sub)


class _Fetcher:
    """A forward's access to the REMOTE leaves of ``plan``: the copy engine
    (the caller's, or one of its own), and each subtree used outside the
    layer loops fetched at each use, or, when the caller collects the
    gradients of REMOTE leaves (``grads``), once a forward."""

    def __init__(self, params: Params, plan: PlacementPlan | None,
                 dev: torch.device, engine: HostFetchEngine | None,
                 grads: RemoteGrads | None):
        self.params, self.plan, self.grads = params, plan, grads
        self.own = engine is None
        self.engine = _engine(plan, dev) if engine is None else engine
        self.remote = remote_keys(plan, "params")
        self._cache: dict[str, Params] = {}

    def __call__(self, key: str) -> Params:
        if self.grads is None:
            return _fetched(self.params, key, self.engine, self.remote)
        if key not in self._cache:
            self._cache[key] = _fetched(self.params, key, self.engine,
                                        self.remote, self.grads)
        return self._cache[key]

    def scan_kw(self, key: str) -> dict:
        """:func:`tiered_scan`'s placement arguments for ``params[key]``."""
        prefix = f"params[{key!r}]"
        return {"engine": self.engine, "remote": remote_keys(self.plan, prefix),
                "peer": peer_keys(self.plan, prefix), "grads": self.grads,
                "prefix": prefix}

    def close(self, out: torch.Tensor | None) -> None:
        """Close an engine of its own, unless ``out`` still needs it: a
        backward through checkpointed layers re-issues their fetches (the
        engine's thread then ends when the graph lets it go)."""
        if self.own and self.engine is not None and not (
                out is not None and out.requires_grad):
            self.engine.close()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_trunk(params, x, positions, cfg: ModelConfig, *, remat: str,
               prefetch: bool, prefetch_under_remat: bool, fetch: _Fetcher,
               moe_groups: int | None = None):
    """The layer loops; returns (hidden, aux_loss). The hybrid's shared
    block is fetched once here."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def scan(fn, carry, key: str, n: int, **kw):
        return scan_stacked_layers(
            fn, carry, params[key], n, remat=remat, prefetch=prefetch,
            prefetch_under_remat=prefetch_under_remat, **fetch.scan_kw(key),
            **kw)

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
        shared = fetch("shared_attn")
        body = _with_shared_block(
            fn, lambda c, _g: _dense_layer(shared, c, cfg, positions),
            cfg.hybrid_attn_every)
        return scan(body, x, "layers", cfg.n_layers, with_index=True), aux
    return scan(fn, x, "layers", cfg.n_layers), aux


def _forward(params, batch, cfg: ModelConfig, fetch: _Fetcher, *, remat: str,
             prefetch: bool, prefetch_under_remat: bool,
             moe_groups: int | None):
    """(logits, aux, hidden): the forward on ``fetch``'s placement."""
    tokens = batch["tokens"]
    x = L.embed(fetch("embed"), tokens, cfg)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = replicate_like(torch.arange(S, device=x.device).expand(B, S),
                               x)
    x = constrain(x, "batch", "seq_sp", None)
    x, aux = _run_trunk(params, x, positions, cfg, remat=remat,
                        prefetch=prefetch,
                        prefetch_under_remat=prefetch_under_remat,
                        fetch=fetch, moe_groups=moe_groups)
    x = L.whole_seq(L.rmsnorm(fetch("ln_f"), x))
    if cfg.family == "vlm":
        x = x[:, batch["patches"].shape[1]:]
    return L.logits(fetch("embed"), x, cfg), aux, x


def forward(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    remat: str = "none",
    prefetch: bool = True,
    prefetch_under_remat: bool = True,
    plan: PlacementPlan | None = None,
    moe_groups: int | None = None,
    return_hidden: bool = False,
    engine: HostFetchEngine | None = None,
    remote_grads: RemoteGrads | None = None,
):
    """Full-sequence forward on the device of ``batch["tokens"]``.

    Returns (logits[B,S_tokens,V_padded] float32, aux_loss[, hidden]): for
    the vlm family the patch embeddings (``batch["patches"]``, (B, F, d))
    are prepended and only text positions give logits (and ``hidden``, the
    final-normed activations); ``aux_loss`` is the moe family's
    load-balance loss summed over the MoE layers (0 for the others),
    ``moe_groups`` its dispatch groups (a batch row each by default).
    ``remat`` checkpoints the layer loops (see :func:`scan_stacked_layers`).
    ``plan`` names the REMOTE leaves of params placed by
    :func:`~repro_torch.core.tiering.place_params`; ``prefetch`` turns the
    layer loops' dual buffer on. A train step passes its own ``engine``
    and the ``remote_grads`` that gather the REMOTE leaves' gradients
    (:class:`~repro_torch.core.tiering.RemoteGrads`).
    """
    fetch = _Fetcher(params, plan, batch["tokens"].device, engine,
                     remote_grads)
    logits = None
    try:
        logits, aux, hidden = _forward(
            params, batch, cfg, fetch, remat=remat, prefetch=prefetch,
            prefetch_under_remat=prefetch_under_remat, moe_groups=moe_groups)
    finally:
        fetch.close(logits)
    if return_hidden:
        return logits, aux, hidden
    return logits, aux


def loss_fn(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    remat: str = "full",
    prefetch: bool = True,
    prefetch_under_remat: bool = True,
    aux_weight: float = 0.01,
    mtp_weight: float = 0.1,
    moe_groups: int | None = None,
    plan: PlacementPlan | None = None,
    engine: HostFetchEngine | None = None,
    remote_grads: RemoteGrads | None = None,
) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy, plus ``aux_weight`` x the MoE aux loss and
    ``mtp_weight`` x the MTP loss -> (loss, {"nll", "aux"[, "mtp_nll"]}).

    The MTP loss is deepseek-v3's multi-token prediction: one extra block
    predicts token t+2 from (trunk hidden_t, embed(token_{t+1})), over the
    full sequence with the last two positions masked out of the loss.
    ``plan``, ``engine`` and ``remote_grads`` as in :func:`forward`.
    """
    want_hidden = bool(cfg.mtp_depth and "mtp" in params)
    fetch = _Fetcher(params, plan, batch["tokens"].device, engine,
                     remote_grads)
    loss = None
    try:
        logits, aux, hidden = _forward(
            params, batch, cfg, fetch, remat=remat, prefetch=prefetch,
            prefetch_under_remat=prefetch_under_remat, moe_groups=moe_groups)
        labels = batch["labels"]
        nll = L.cross_entropy(logits[:, :-1].float(), labels[:, 1:])
        loss = nll + aux_weight * aux
        metrics = {"nll": nll, "aux": aux}
        if want_hidden:
            mtp_nll = _mtp_nll(fetch, hidden, batch, cfg)
            # whole on every rank first: the card's torch 2.11 adds no
            # Partial(sum) to a Partial(avg)
            loss = _replicated(loss) + mtp_weight * _replicated(mtp_nll)
            metrics["mtp_nll"] = mtp_nll
    finally:
        fetch.close(loss)
    return loss, metrics


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim; a plain tensor itself."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)


def _roll_seq(t: torch.Tensor, shift: int) -> torch.Tensor:
    """``t`` (B, S) rolled along its sequence; a DTensor (split over the
    batch alone) on each rank's rows."""
    return like_global(torch.roll(local_part(t), shift, 1), t)


def _mtp_nll(fetch: _Fetcher, hidden, batch, cfg: ModelConfig):
    """The MTP block's mean NLL of token t+2 at the first S - 2 positions."""
    mtp = fetch("mtp")
    B, S, _ = hidden.shape
    emb_next = L.embed(fetch("embed"), _roll_seq(batch["tokens"], -1), cfg)
    h = torch.cat([hidden, emb_next], dim=-1) @ mtp["proj"]
    positions = replicate_like(torch.arange(S, device=h.device).expand(B, S),
                               h)
    h = _dense_layer(mtp["layer"], h, cfg, positions)
    h = L.rmsnorm(mtp["ln"], h)
    mtp_logits = L.logits(fetch("embed"), h, cfg).float()
    tgt = _roll_seq(batch["labels"], -2)
    return L.cross_entropy(mtp_logits[:, :S - 2], tgt[:, :S - 2])


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
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(
            f"decode cache for {cfg.family} lives in encdec.py")
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
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    pos = cache["pos"]
    new: dict = {}
    routing = [] if return_routing and cfg.family == "moe" else None

    def scan(body, x, key: str, caches: dict, n: int, **kw):
        prefix = f"params[{key!r}]"
        layer_remote = frozenset("['p']" + k
                                 for k in remote_keys(plan, prefix))
        layer_peer = {"['p']" + k: a
                      for k, a in peer_keys(plan, prefix).items()}
        return tiered_scan(body, x, {"p": params[key], **caches}, n_layers=n,
                           prefetch=prefetch, engine=engine,
                           remote=layer_remote, peer=layer_peer, **kw)

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
                         cfg.n_layers, with_index=True)
            else:
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
