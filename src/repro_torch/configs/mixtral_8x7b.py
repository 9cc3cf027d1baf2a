"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

MoE 8 experts top-2, sliding-window attention (w=4096) [arXiv:2401.04088; hf].
SWA makes this arch sub-quadratic => the long_500k cell runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,           # dense-equivalent (unused in MoE layers)
    moe_d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    expert_sharding="tensor",  # 8 experts < 16-way model axis: TP within experts
    first_k_dense=0,
)
