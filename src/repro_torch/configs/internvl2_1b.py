"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

InternViT vision frontend + InternLM2/Qwen2-0.5B LM backbone
[arXiv:2404.16821; hf]. The vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings (batch, frontend_len,
d_model) that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend_len=256,      # ViT patch embeddings per image
)
