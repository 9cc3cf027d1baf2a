"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.

Encoder-decoder, multimodal [arXiv:2308.11596; hf]. The speech/audio frontend
is a STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, frontend_len, d_model); the transformer backbone
(12 encoder + 12 decoder layers with cross-attention) is fully implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend_len=1024,      # precomputed audio frame embeddings per example
)
