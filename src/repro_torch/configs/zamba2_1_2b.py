"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64.

Mamba2 backbone + a shared attention block invoked periodically
[arXiv:2411.15242; hf]. Hybrid => long_500k runs (SSM state is O(1); the
shared block's KV cache is O(L) but decode cost per token is linear).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    hybrid_attn_every=6,   # shared block applied after every 6 mamba layers
    tie_embeddings=True,
)
