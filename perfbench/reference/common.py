"""What the families' references share: the products in a stated precision,
RMSNorm, rotary embeddings, causal attention, the SwiGLU MLP, the loss,
AdamW, and the train step that runs them.

Written from the published equations in plain PyTorch. Every product runs
in float32 with TF32 off (``prec="f32"``), or, for the check's control,
with both operands rounded to float8 e4m3 at a scale per tensor, forward
and backward (``prec="fp8"``, the precision below the bf16 the
configurations state). Each stacked leaf's layers are parameters of their
own (units, named as :mod:`perfbench.weights` names them), and each layer
is recomputed in the backward (``torch.utils.checkpoint``) so that the
float32 step fits beside its state.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8 e4m3's largest finite value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a scale that maps its largest
    magnitude to e4m3's largest, returned in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = FP8_MAX / amax
    return (x.float() * s).to(torch.float8_e4m3fn).float() / s


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` with each operand of the forward and of both backward
    products rounded by :func:`fp8_round`, accumulated in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8_round(g)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` (same batch dims, no broadcasting of a batched ``b``) in
    ``prec``."""
    if prec == "f32":
        return a.float() @ b.float()
    if prec == "fp8":
        return _Fp8MatMul.apply(a.float(), b.float())
    raise ValueError(f"unknown precision {prec!r}")


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (..., k) times ``w`` (k, n)."""
    y = matmul(x.reshape(-1, x.shape[-1]), w, prec)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, H, D) at positions 0..S-1: the two
    halves of each head rotated by angles ``pos / theta^(2i/D)``."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = ang.sin()[:, None], ang.cos()[:, None]       # (S, 1, half)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: str) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(D), causal) v over (B, S, H, D) queries and (B,
    S, KV, D) keys and values, each KV head read by H / KV query heads."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.transpose(1, 2).repeat_interleave(rep, dim=1)
    v = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return matmul(probs, v, prec).transpose(1, 2)


def attention_block(x, w: dict, model: dict, prec: str) -> torch.Tensor:
    """Pre-norm GQA attention then a SwiGLU MLP, each added to ``x``.
    ``w``'s keys: ``attn.wq``, ``attn.wk``, ``attn.wv``, ``attn.wo``,
    ``mlp.w_gate``, ``mlp.w_up``, ``mlp.w_down``, ``ln1.scale``,
    ``ln2.scale``."""
    B, S, d = x.shape
    H, KV = model["n_heads"], model["n_kv_heads"]
    Dh = model.get("head_dim") or d // H
    eps, theta = model["norm_eps"], model["rope_theta"]
    h = rmsnorm(x, w["ln1.scale"], eps)
    q = rope(linear(h, w["attn.wq"], prec).reshape(B, S, H, Dh), theta)
    k = rope(linear(h, w["attn.wk"], prec).reshape(B, S, KV, Dh), theta)
    v = linear(h, w["attn.wv"], prec).reshape(B, S, KV, Dh)
    o = causal_attention(q, k, v, prec).reshape(B, S, H * Dh)
    x = x + linear(o, w["attn.wo"], prec)
    h = rmsnorm(x, w["ln2.scale"], eps)
    g = F.silu(linear(h, w["mlp.w_gate"], prec)) * linear(h, w["mlp.w_up"],
                                                          prec)
    return x + linear(g, w["mlp.w_down"], prec)


def checkpointed(fn, x, w: dict):
    """``fn(x, w)`` recomputed in the backward; ``w``'s tensors are inputs
    of the checkpoint, so their gradients arrive."""
    keys = list(w)

    def call(x, *ts):
        return fn(x, dict(zip(keys, ts)))

    return torch.utils.checkpoint.checkpoint(call, x, *w.values(),
                                             use_reentrant=False)


def layer_weights(P: dict, prefix: str, i: int | None) -> dict:
    """The units of ``P`` under ``prefix`` (of layer ``i`` of a stack),
    keyed by their path below it."""
    tail = "" if i is None else f".{i}"
    out = {}
    for name, t in P.items():
        if name.startswith(prefix + ".") and name.endswith(tail):
            key = name[len(prefix) + 1:len(name) - len(tail)]
            if i is not None or not key.rsplit(".", 1)[-1].isdigit():
                out[key] = t
    return out


def lm_loss(x, P: dict, batch: dict, model: dict, prec: str) -> torch.Tensor:
    """The final norm, the head tied to the embedding over the vocabulary's
    real rows, and the mean next-token NLL."""
    x = rmsnorm(x, P["ln_f.scale"], model["norm_eps"])
    E = P["embed.embedding"][:model["vocab_size"]]
    logits = linear(x[:, :-1], E.t(), prec)
    labels = batch["labels"][:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (from 1): linear warm-up, then a
    cosine from ``lr`` down to ``min_lr_ratio`` of it over
    ``decay_steps``."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / warm
    prog = min(max((step - warm) / max(opt["decay_steps"] - warm, 1), 0.0),
               1.0)
    r = opt["min_lr_ratio"]
    return lr * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw(p, g, m, v, step: int, scale: float, opt: dict):
    """One AdamW step of one unit in float32 on the clipped gradient
    ``g * scale``; the parameter kept in its own type. Returns (p, m, v)."""
    g = g.float() * scale
    m = opt["b1"] * m + (1 - opt["b1"]) * g
    v = opt["b2"] * v + (1 - opt["b2"]) * g * g
    upd = (m / (1 - opt["b1"] ** step)) / (
        torch.sqrt(v / (1 - opt["b2"] ** step)) + opt["eps"])
    p32 = p.float()
    p32 = p32 - lr_at(opt, step) * (upd + opt["weight_decay"] * p32)
    return p32.to(p.dtype), m, v


def train(loss_fn, units: dict, batches, model: dict, opt: dict,
          prec: str = "f32") -> dict:
    """AdamW training of ``units`` (name -> tensor, each in its stated
    type) by ``loss_fn(P, batch, model, prec)`` over ``batches``; the
    gradients of float32 copies, clipped by their global norm. Returns
    each step's loss, the norm of each unit's first clipped gradient, and
    the units after the last step."""
    m = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
         for k, t in units.items()}
    v = {k: torch.zeros_like(x) for k, x in m.items()}
    losses, first = [], None
    with exact_float32():
        for step, batch in enumerate(batches, start=1):
            P = {k: t.to(torch.float32, copy=True).requires_grad_(True)
                 for k, t in units.items()}
            loss = loss_fn(P, batch, model, prec)
            grads = torch.autograd.grad(loss, list(P.values()))
            losses.append(float(loss.detach()))
            del P, loss
            gnorm = math.sqrt(sum(float(g.double().square().sum())
                                  for g in grads))
            scale = min(opt["grad_clip"] / (gnorm + 1e-9), 1.0)
            if first is None:
                first = {k: float(torch.linalg.vector_norm(g.double()))
                         * scale for k, g in zip(units, grads)}
            new = {}
            for k, g in zip(list(units), grads):
                new[k], m[k], v[k] = adamw(units[k], g, m[k], v[k], step,
                                           scale, opt)
            units = new
            del grads
    return {"losses": losses, "first_grad": first, "units": units}
