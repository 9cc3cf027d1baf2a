"""Forward FLOPs of the dense family (attention + SwiGLU MLP blocks, the
head tied to the embedding): every product ``2·m·n·k``, attention over the
causal pairs as ``work.flash_work`` counts them."""
from __future__ import annotations

from perfbench.counts import work


def attention_block_flops(model: dict, batch: int, seq: int) -> float:
    """One attention + MLP block over ``batch`` x ``seq`` tokens."""
    d, H, KV = model["d_model"], model["n_heads"], model["n_kv_heads"]
    Dh = model.get("head_dim") or d // H
    T = batch * seq
    proj = 2.0 * T * d * (H * Dh + 2 * KV * Dh) + 2.0 * T * H * Dh * d
    attn, _ = work.flash_work(batch, H, seq, seq, KV, Dh, Dh, causal=True,
                              window=None, itemsize=2)
    mlp = 3 * 2.0 * T * d * model["d_ff"]
    return proj + attn + mlp


def head_flops(model: dict, batch: int, seq: int) -> float:
    """The logits: the final hidden states times the vocabulary."""
    return 2.0 * batch * seq * model["d_model"] * model["vocab_size"]


def forward_flops(model: dict, batch: int, seq: int) -> float:
    return (model["n_layers"] * attention_block_flops(model, batch, seq)
            + head_flops(model, batch, seq))
