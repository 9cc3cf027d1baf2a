"""Model assembly: the ssm family so far.

A port of part of ``repro.models.transformer``, with the same public API:

  init_params(gen, cfg, device=)           -> params (nested dicts)
  forward(params, batch, cfg, ...)         -> (logits, aux)
  init_decode_cache(cfg, batch, max_len)   -> cache
  decode_step(params, cache, tokens, cfg)  -> (logits, cache)

Layers are *stacked* (leading dim = n_layers) and driven by
:func:`repro_torch.core.tiering.tiered_scan`, DOLMA's dual buffer over
layers: with a host-offload plan (``plan=``, from
:func:`~repro_torch.core.tiering.place_params`) layer i+1's REMOTE weights
are copied from pinned host memory while layer i computes. REMOTE leaves
outside the stack (the embedding) are fetched at each use. Every placement
computes the same values: its logits are bit-identical to the all-local
run's.

The dense, vlm and moe families wait for ROADMAP A3 and A7, the hybrid
family (zamba2) for A8's hybrid part on top of A3's attention, the loss for
A9.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import HostFetchEngine, resolve_device
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.tiering import map_leaves, remote_keys, tiered_scan
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Params = dict[str, Any]

_WAITS_FOR = {
    "dense": "ROADMAP A3 (the dense decoder)",
    "vlm": "ROADMAP A3 (the dense decoder)",
    "moe": "ROADMAP A7 (MoE and MLA)",
    "hybrid": "ROADMAP A8's hybrid part (zamba2, on A3's attention)",
    "encdec": "ROADMAP A9 (models/encdec.py)",
    "audio": "ROADMAP A9 (models/encdec.py)",
}


def _require_ssm(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{what}: the {cfg.family} family waits for "
            f"{_WAITS_FOR.get(cfg.family, 'its slice')}")


# ---------------------------------------------------------------------------
# layers and init
# ---------------------------------------------------------------------------

def _ssm_layer_init(gen: torch.Generator, cfg: ModelConfig,
                    n: int) -> Params:
    return {
        "ln": L.rmsnorm_init(cfg.d_model, cfg.dtype, stack=n, device=gen.device),
        "ssm": SSM.ssm_init(gen, cfg, stack=n),
    }


def _ssm_layer(p, x, cfg):
    return x + SSM.ssm_block(p["ssm"], L.rmsnorm(p["ln"], x), cfg)


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``gen`` (on its device) with the
    reference's shapes and scales, then moved to ``device``."""
    _require_ssm(cfg, "init_params")
    dev = resolve_device(device)
    p: Params = {
        "embed": L.embed_init(gen, cfg),
        "ln_f": L.rmsnorm_init(cfg.d_model, cfg.dtype, device=gen.device),
        "layers": _ssm_layer_init(gen, cfg, cfg.n_layers),
    }
    return map_leaves(lambda _k, t: t.to(dev), p)


def _engine(plan: PlacementPlan | None,
            dev: torch.device) -> HostFetchEngine | None:
    """The copy engine of a host-offload plan with REMOTE leaves: unpaced,
    so a transfer costs only its real copy."""
    if plan is None or not plan.remote_names():
        return None
    return HostFetchEngine(throttle=0.0, device=dev)


def _use(params: Params, path: tuple[str, ...],
         engine: HostFetchEngine | None, remote: frozenset[str]):
    """The leaf of ``params`` at ``path``; one the plan made REMOTE (it is
    used whole, outside the layer loop) is fetched through ``engine`` at
    this use."""
    key = "".join(f"[{k!r}]" for k in path)
    t = params
    for k in path:
        t = t[k]
    if key not in remote:
        return t
    return engine.acquire(engine.fetch(key, {"t": t}, pace=False))["t"]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    batch: dict,
    cfg: ModelConfig,
    *,
    prefetch: bool = True,
    plan: PlacementPlan | None = None,
):
    """Full-sequence forward on the device of ``batch["tokens"]``.

    Returns (logits[B,S,V_padded] float32, aux_loss). ``plan`` names the
    REMOTE leaves of params placed by
    :func:`~repro_torch.core.tiering.place_params`; ``prefetch`` turns the
    layer loop's dual buffer on.
    """
    _require_ssm(cfg, "forward")
    tokens = batch["tokens"]
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    try:
        x = L.embed({"embedding": _use(params, ("embed", "embedding"), engine,
                                       remote)}, tokens, cfg)
        x = tiered_scan(lambda c, p: _ssm_layer(p, c, cfg), x,
                        params["layers"], n_layers=cfg.n_layers,
                        prefetch=prefetch, engine=engine,
                        remote=remote_keys(plan, "params['layers']"))
        x = L.rmsnorm({"scale": _use(params, ("ln_f", "scale"), engine,
                                     remote)}, x)
        logits = L.logits({"embedding": _use(params, ("embed", "embedding"),
                                             engine, remote)}, x, cfg)
    finally:
        if engine is not None:
            engine.close()
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """The recurrent state of every layer (O(1) in ``max_len``)."""
    _require_ssm(cfg, "init_decode_cache")
    dev = resolve_device(device)
    st = SSM.ssm_decode_init(cfg, batch, device=dev)
    nL = cfg.n_layers
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "conv": st["conv"].unsqueeze(0).repeat(nL, *([1] * st["conv"].ndim)),
        "state": st["state"].unsqueeze(0).repeat(nL, *([1] * st["state"].ndim)),
    }


def decode_step(
    params: Params, cache: dict, tokens: torch.Tensor, cfg: ModelConfig,
    *, prefetch: bool = True, plan: PlacementPlan | None = None,
):
    """One-token decode. tokens: (B, 1). Returns (logits[B,1,V], new cache).

    The layer loop is :func:`tiered_scan` over the stacked params and the
    stacked per-layer caches, so a host-offload ``plan`` streams the
    weights here too.
    """
    _require_ssm(cfg, "decode_step")
    engine = _engine(plan, tokens.device)
    remote = remote_keys(plan, "params")
    new_conv, new_state = [], []

    def body(xx, sl):
        h = L.rmsnorm(sl["p"]["ln"], xx)
        o, st = SSM.ssm_decode_step(
            sl["p"]["ssm"], h, {"conv": sl["conv"], "state": sl["state"]}, cfg)
        new_conv.append(st["conv"])
        new_state.append(st["state"])
        return xx + o

    try:
        x = L.embed({"embedding": _use(params, ("embed", "embedding"), engine,
                                       remote)}, tokens, cfg)
        stacked = {"p": params["layers"], "conv": cache["conv"],
                   "state": cache["state"]}
        x = tiered_scan(body, x, stacked, n_layers=cfg.n_layers,
                        prefetch=prefetch, engine=engine,
                        remote=frozenset("['p']" + k for k in remote_keys(
                            plan, "params['layers']")))
        x = L.rmsnorm({"scale": _use(params, ("ln_f", "scale"), engine,
                                     remote)}, x)
        logits = L.logits({"embedding": _use(params, ("embed", "embedding"),
                                             engine, remote)}, x, cfg)
    finally:
        if engine is not None:
            engine.close()
    cache = {**cache, "conv": torch.stack(new_conv), "state": torch.stack(
        new_state), "pos": cache["pos"] + 1}
    return logits, cache
