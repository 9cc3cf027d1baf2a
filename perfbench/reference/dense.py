"""Plain reference of the dense family (granite-8b): a stack of pre-norm
GQA attention + SwiGLU MLP blocks with rotary embeddings, a final RMSNorm
and the head tied to the embedding; mean next-token cross-entropy.

``param_specs`` lists the parameters as the program's tree holds them
(stacked over the layers, the vocabulary padded to a multiple of 2048 rows
of which the tokens and the head use the first ``vocab_size``) and how the
benchmark draws them: N(0, 1/fan_in) for each projection, N(0, 1/d_model)
for the embedding (so that the tied head's logits start near unit scale),
ones for each norm's scale. bf16 throughout.
"""
from __future__ import annotations

import torch

from perfbench.reference.common import (
    attention_block,
    checkpointed,
    layer_weights,
    lm_loss,
)
from perfbench.weights import Spec

VOCAB_ROWS = 2048  # the program pads the embedding to a multiple of these


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // VOCAB_ROWS) * VOCAB_ROWS


def block_specs(model: dict, prefix: str, n: int | None) -> list[Spec]:
    """One attention + MLP block's parameters under ``prefix``, stacked
    over ``n`` layers (None: one block, not stacked)."""
    d, H, KV, ff = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["d_ff"])
    Dh = model.get("head_dim") or d // H
    bf16 = torch.bfloat16
    lead = () if n is None else (n,)
    st = n is not None

    def normal(path, shape):
        return Spec((prefix, *path), lead + shape, bf16,
                    ("normal", shape[0] ** -0.5), st)

    return [
        Spec((prefix, "ln1", "scale"), lead + (d,), bf16, ("const", 1.0), st),
        Spec((prefix, "ln2", "scale"), lead + (d,), bf16, ("const", 1.0), st),
        normal(("attn", "wq"), (d, H * Dh)),
        normal(("attn", "wk"), (d, KV * Dh)),
        normal(("attn", "wv"), (d, KV * Dh)),
        normal(("attn", "wo"), (H * Dh, d)),
        normal(("mlp", "w_gate"), (d, ff)),
        normal(("mlp", "w_up"), (d, ff)),
        normal(("mlp", "w_down"), (ff, d)),
    ]


def embedding_specs(model: dict) -> list[Spec]:
    d = model["d_model"]
    return [
        Spec(("embed", "embedding"), (padded_vocab(model), d), torch.bfloat16,
             ("normal", d ** -0.5)),
        Spec(("ln_f", "scale"), (d,), torch.bfloat16, ("const", 1.0)),
    ]


def param_specs(model: dict) -> list[Spec]:
    return embedding_specs(model) + block_specs(model, "layers",
                                                model["n_layers"])


def loss(P: dict, batch: dict, model: dict, prec: str) -> torch.Tensor:
    x = P["embed.embedding"][batch["tokens"].long()]
    for i in range(model["n_layers"]):
        x = checkpointed(lambda x, w: attention_block(x, w, model, prec), x,
                         layer_weights(P, "layers", i))
    return lm_loss(x, P, batch, model, prec)
