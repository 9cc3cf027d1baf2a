"""Optimizer of the port: AdamW with tiered moments, int8 block-quantized
state and error-feedback gradient compression (``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, global_norm, init, schedule, update
from repro_torch.optim.quantized import QTensor, dequantize, is_qtensor, quantize
from repro_torch.optim.compression import (
    CompressionConfig,
    apply_error_feedback,
    compress,
    decompress,
    init_error_feedback,
    quantize_roundtrip,
)

__all__ = [
    "AdamWConfig",
    "CompressionConfig",
    "QTensor",
    "apply_error_feedback",
    "compress",
    "decompress",
    "dequantize",
    "global_norm",
    "init",
    "init_error_feedback",
    "is_qtensor",
    "quantize",
    "quantize_roundtrip",
    "schedule",
    "update",
]
