"""Model configurations of the port: ``--arch <id>`` resolution and the
reduced configs of the CPU tests.

A copy of ``repro.configs``: all ten configurations, as data; the models
run every family. ``reduced_config`` applies the reference's overrides
with the same numbers, so both packages build identical reduced configs.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "granite-34b",
    "glm4-9b",
    "granite-8b",
    "starcoder2-7b",
    "seamless-m4t-medium",
    "mixtral-8x7b",
    "deepseek-v3-671b",
    "mamba2-130m",
    "zamba2-1.2b",
    "internvl2-1b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def reduced_config(config: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's overrides)."""
    small: dict = dict(
        n_layers=min(config.n_layers, 2),
        d_model=64,
        d_ff=128 if config.d_ff else 0,
        vocab_size=256,
    )
    if config.n_heads:
        small.update(n_heads=4, n_kv_heads=min(config.n_kv_heads, 4) or 1, head_dim=16)
    if config.is_moe:
        small.update(n_experts=4, top_k=min(config.top_k, 2), moe_d_ff=32,
                     first_k_dense=min(config.first_k_dense, 1))
    if config.attention == "mla":
        small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
    if config.ssm_state:
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if config.hybrid_attn_every:
        small.update(hybrid_attn_every=2, n_layers=4)
    if config.n_encoder_layers:
        small.update(n_encoder_layers=2)
    if config.frontend_len:
        small.update(frontend_len=8)
    if config.sliding_window:
        small.update(sliding_window=16)
    small.update(overrides)
    return dataclasses.replace(config, **small)


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "reduced_config"]
