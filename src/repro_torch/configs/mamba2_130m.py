"""mamba2-130m [ssm]: 24L d_model=768 (attention-free) vocab=50280 ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060]. Attention-free: decode keeps an
O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)
