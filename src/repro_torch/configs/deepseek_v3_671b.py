"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 vocab=129280.

MLA attention, MoE with 1 shared + 256 routed experts top-8, MTP
[arXiv:2412.19437; hf]. First 3 layers are dense (d_ff=18432); the remaining
58 are MoE with per-expert hidden 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense layers' hidden (first_k_dense)
    moe_d_ff=2048,
    vocab_size=129280,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    first_k_dense=3,
    expert_sharding="expert",  # 256 experts / 16-way model axis = 16 per device
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
)
