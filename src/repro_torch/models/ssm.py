"""Mamba2 blocks via SSD (state-space duality), chunked formulation.

A port of ``repro.models.ssm``. Per head h (headdim P, state N):

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . h_t + D_h x_t

:func:`ssm_block`'s chunk scan goes through :func:`repro_torch.kernels.ops.ssd`
(the hand-written SSD kernel on a card). :func:`_ssd_scan` is the
reference's plain chunked algorithm, with an initial and a final state; it
and :func:`ssd_reference_recurrent` are the oracles the tests hold the
kernel path to. Exponentials are computed in float32.

Decode keeps O(1) state: (conv ring buffer, SSM state (B,H,P,N)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, _init, rmsnorm
from repro_torch.models.sharding import (
    constrain,
    is_dtensor,
    local_call,
    replicate_like,
)


def ssm_init(gen: torch.Generator, cfg: ModelConfig, *, stack: int) -> Params:
    """``stack`` Mamba2 blocks' parameters along a leading dim (the
    reference stacks its per-layer init with ``vmap``), drawn on the
    generator's device."""
    d = cfg.d_model
    di, g, n, hN = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    w = cfg.ssm_conv_width
    conv_ch = di + 2 * g * n
    dev = gen.device

    def full(shape, value, dtype):
        return torch.full((stack, *shape), value, dtype=dtype, device=dev)

    return {
        "in_proj": _init(gen, (d, 2 * di + 2 * g * n + hN), cfg.dtype,
                         stack=stack),
        "conv_w": _init(gen, (w, conv_ch), cfg.dtype, scale=w ** -0.5,
                        stack=stack),
        "conv_b": full((conv_ch,), 0.0, cfg.dtype),
        "A_log": full((hN,), 0.0, torch.float32),
        "D": full((hN,), 1.0, torch.float32),
        "dt_bias": full((hN,), 0.0, torch.float32),
        "norm": {"scale": full((di,), 1.0, cfg.dtype)},
        "out_proj": _init(gen, (di, d), cfg.dtype, stack=stack),
    }


def _split_proj(p, x, cfg: ModelConfig):
    di, g, n, hN = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + di + 2 * g * n]
    dt_raw = zxbcdt[..., -hN:]
    return z, xbc, dt_raw


def _causal_conv(p, xbc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) in the activation dtype: a
    cross-correlation (no flip) with w-1 zeros on the left, then silu."""
    if is_dtensor(xbc):
        return _local_conv(p, xbc, cfg)
    w = cfg.ssm_conv_width
    C = xbc.shape[-1]
    weight = p["conv_w"].to(xbc.dtype).t().reshape(C, 1, w)
    out = F.conv1d(F.pad(xbc.transpose(1, 2), (w - 1, 0)), weight, groups=C)
    out = out.transpose(1, 2)
    return F.silu(out + p["conv_b"].to(out.dtype))


def _local_conv(p, xbc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_causal_conv` of a DTensor on each rank's local shards: a
    split batch or channel dim stays split (the conv is per channel), a
    split sequence is gathered first (each position reads the w - 1
    before it)."""
    rep = Replicate()
    x_p, w_p, b_p = [], [], []
    for a in xbc.placements:
        x_p.append(a if a in (Shard(0), Shard(2)) else rep)
        w_p.append(Shard(1) if a == Shard(2) else rep)
        b_p.append(Shard(0) if a == Shard(2) else rep)
    return local_call(
        "conv", lambda x, w, b: _causal_conv({"conv_w": w, "conv_b": b}, x,
                                             cfg),
        (xbc, p["conv_w"], p["conv_b"]), (x_p, w_p, b_p), tuple(x_p),
        xbc.device_mesh)


def _ssd_scan(xh, Bm, Cm, dt, A, cfg: ModelConfig, init_state=None):
    """Chunked SSD in plain torch. xh: (B,L,H,P); Bm,Cm: (B,L,G,N); dt:
    (B,L,H) float32.

    Returns y: (B,L,H,P) in ``xh``'s dtype and the final state (B,H,P,N)
    float32.
    """
    Bsz, L, H, P = xh.shape
    G = Bm.shape[2]
    N = cfg.ssm_state
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"seq {L} not divisible by chunk {Q}")
    nc = L // Q
    rep = H // G

    def chunked(t, extra):  # (B,L,...) -> (B,nc,Q,...)
        return t.reshape(Bsz, nc, Q, *extra)

    xc = chunked(xh, (H, P)).float()
    Bc = chunked(Bm, (G, N)).repeat_interleave(rep, dim=3).float()  # (B,nc,Q,H,N)
    Cc = chunked(Cm, (G, N)).repeat_interleave(rep, dim=3).float()
    dtc = chunked(dt, (H,))

    dA = dtc * A                      # (B,nc,Q,H), A negative
    cum = torch.cumsum(dA, dim=2)     # inclusive
    total = cum[:, :, -1]             # (B,nc,H)

    # intra-chunk quadratic term; the mask selects (exp overflows for k > q)
    Lmat = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,q,k,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    Lmat = torch.where(mask[None, None, :, :, None], Lmat, 0.0) * dtc[:, :, None]
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores * Lmat, xc)

    # chunk-local states (contribution of each chunk to the carry)
    decay_out = torch.exp(total[:, :, None] - cum)  # (B,nc,Q,H)
    S_local = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_out * dtc, Bc, xc)

    # inter-chunk recurrence (tiny loop over nc); emit the entering state
    lam = torch.exp(total)  # (B,nc,H)
    S = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    S_prev = []
    for c in range(nc):
        S_prev.append(S)
        S = lam[:, c, :, None, None] * S + S_local[:, c]
    S_prev = torch.stack(S_prev, dim=1)  # (B,nc,H,P,N)

    decay_in = torch.exp(cum)  # (B,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cc, S_prev) * decay_in[..., None]

    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y.to(xh.dtype), S


def ssm_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full Mamba2 block (no residual/norm: the caller wraps). The chunk
    scan runs through :func:`ops.ssd`."""
    Bsz, L, _ = x.shape
    di, g, n, hN, P = (
        cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim,
    )
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc = _causal_conv(p, xbc, cfg)
    xs = xbc[..., :di].reshape(Bsz, L, hN, P)
    Bm = xbc[..., di : di + g * n].reshape(Bsz, L, g, n)
    Cm = xbc[..., di + g * n :].reshape(Bsz, L, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (H,)

    # ops.ssd returns float32; the reference's scan casts y to xs's dtype
    # before the D term is added
    xs = constrain(xs, "batch", None, "heads", None)
    y = _ssd(xs, Bm, Cm, dt, A, chunk=cfg.ssm_chunk).to(xs.dtype)
    y = y + (p["D"][:, None] * xs.float()).to(y.dtype)
    y = y.reshape(Bsz, L, di)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return y @ p["out_proj"]


def _ssd(xs, Bm, Cm, dt, A, *, chunk: int) -> torch.Tensor:
    """:func:`ops.ssd`; on DTensors, on each rank's local shards.

    A mesh dim that splits the batch splits every input alike. One that
    splits the heads keeps them split when the local heads read only local
    groups (one group, read by every head, or a group count the dim
    divides); any other split is gathered first on that mesh dim."""
    if not is_dtensor(xs):
        return ops.ssd(xs, Bm, Cm, dt, A, chunk=chunk)
    mesh, G = xs.device_mesh, Bm.shape[2]
    rep = Replicate()
    x_p, bc_p, dt_p, a_p = [], [], [], []
    for a, n in zip(xs.placements, mesh.shape):
        if a == Shard(0):
            row = (a, a, a, rep)
        elif a == Shard(2) and (G == 1 or G % n == 0):
            row = (a, rep if G == 1 else a, a, Shard(0))
        else:
            row = (rep,) * 4
        for out, pl in zip((x_p, bc_p, dt_p, a_p), row):
            out.append(pl)
    return local_call(
        "ssd", lambda *ts: ops.ssd(*ts, chunk=chunk), (xs, Bm, Cm, dt, A),
        (x_p, bc_p, bc_p, dt_p, a_p), tuple(x_p), mesh)


# -- decode -----------------------------------------------------------------

def ssm_decode_init(cfg: ModelConfig, batch: int, *,
                    device: torch.device | str) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=cfg.dtype, device=device),
        "state": torch.zeros(
            (batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
            dtype=torch.float32, device=device),
    }


def _state_update_local(state, dt, Bh, Ch, xs, A, D):
    decay = torch.exp(dt * A)  # (B,H)
    S = state * decay[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, Bh, xs.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + D[:, None] * xs.float()
    return S, y


def _state_update(state, dt, Bh, Ch, xs, A, D):
    """One step of the recurrence: the new state (B,H,P,N) and y (B,H,P).
    On DTensors on each rank's local shards, the batch and the heads split
    as the state is (every (b, h) is independent)."""
    if not is_dtensor(state):
        return _state_update_local(state, dt, Bh, Ch, xs, A, D)
    sp = tuple(a if a in (Shard(0), Shard(1)) else Replicate()
               for a in state.placements)
    heads = tuple(Shard(0) if a == Shard(1) else Replicate() for a in sp)
    args = [state, dt, Bh, Ch, xs, A, D]
    args[5:] = [replicate_like(t, state) for t in args[5:]]
    return local_call("ssm_state", _state_update_local, args,
                      (sp, sp, sp, sp, sp, heads, heads), (sp, sp),
                      state.device_mesh)


def ssm_decode_step(
    p: Params, x: torch.Tensor, cache: dict, cfg: ModelConfig
) -> tuple[torch.Tensor, dict]:
    """One-token step. x: (B,1,d). O(1) in context length."""
    Bsz = x.shape[0]
    di, g, n, hN, P = (
        cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim,
    )
    z, xbc_new, dt_raw = _split_proj(p, x, cfg)  # (B,1,*)
    window = torch.cat([cache["conv"], xbc_new], dim=1)  # (B,w,C)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
    xbc = F.silu(conv_out + p["conv_b"].float())[:, None].to(x.dtype)
    new_conv = window[:, 1:]

    xs = xbc[..., :di].reshape(Bsz, hN, P)
    Bm = xbc[..., di : di + g * n].reshape(Bsz, g, n)
    Cm = xbc[..., di + g * n :].reshape(Bsz, g, n)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    rep = hN // g
    Bh = Bm.repeat_interleave(rep, dim=1).float()  # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()

    S, y = _state_update(cache["state"], dt, Bh, Ch, xs, A, p["D"])
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "state": S}


def ssd_reference_recurrent(xh, Bm, Cm, dt, A):
    """O(L) recurrent oracle. Same shapes as :func:`_ssd_scan`, float32."""
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2).float()
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    xf = xh.float()
    dtf = dt.float()
    S = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * A)  # (B,H)
        S = S * decay[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1)  # (B,L,H,P)
