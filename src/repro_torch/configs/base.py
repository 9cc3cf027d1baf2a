"""Model/config schema (a copy of ``repro.configs.base`` with torch dtypes)."""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention flavor
    attention: Literal["gqa", "mla", "none"] = "gqa"
    sliding_window: int | None = None  # SWA width (mixtral: 4096)
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden (deepseek: 2048)
    first_k_dense: int = 0      # deepseek: first 3 layers dense
    capacity_factor: float = 1.25
    expert_sharding: Literal["expert", "tensor"] = "expert"

    # MLA (deepseek-v3 dims)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # hybrid (zamba2): one shared attention block applied every k mamba layers
    hybrid_attn_every: int = 0

    # enc-dec
    n_encoder_layers: int = 0

    # modality frontend stubs ([audio]/[vlm]): precomputed embeddings length
    frontend_len: int = 0

    # multi-token prediction (deepseek MTP)
    mtp_depth: int = 0

    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only archs assigned

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        for layer in range(self.n_layers):
            if self.family in ("ssm",) or (
                self.family == "hybrid" and True
            ):
                # mamba2 block
                di, g, s, hn = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_nheads
                n += d * (2 * di + 2 * g * s + hn)  # in_proj
                n += self.ssm_conv_width * (di + 2 * g * s)  # conv
                n += 3 * hn + di  # A, D, dt_bias, norm
                n += di * d  # out_proj
                n += d  # ln
                continue
            # attention
            if self.attention == "mla":
                n += d * self.q_lora_rank + self.q_lora_rank * H * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
                n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                n += self.kv_lora_rank * H * (self.qk_nope_head_dim + self.v_head_dim)
                n += H * self.v_head_dim * d
            else:
                n += d * H * Dh + 2 * d * KV * Dh + H * Dh * d
            # mlp / moe
            if self.is_moe and layer >= self.first_k_dense:
                n += d * self.n_experts  # router
                n += self.n_experts * 3 * d * self.moe_d_ff
                n += self.n_shared_experts * 3 * d * self.moe_d_ff
            else:
                n += 3 * d * ff
            n += 2 * d  # norms
        n += d  # final norm
        if self.family == "hybrid" and self.hybrid_attn_every:
            n += d * H * Dh + 2 * d * KV * Dh + H * Dh * d + 3 * d * ff + 2 * d
        if self.n_encoder_layers:
            n += self.n_encoder_layers * (
                d * H * Dh + 2 * d * KV * Dh + H * Dh * d + 3 * d * ff + 2 * d
            )
            # decoder cross-attention
            n += self.n_layers * (d * H * Dh + 2 * d * KV * Dh + H * Dh * d + d)
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        n_moe_layers = self.n_layers - self.first_k_dense
        all_expert = n_moe_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        active_expert = n_moe_layers * self.top_k * 3 * self.d_model * self.moe_d_ff
        return total - all_expert + active_expert


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def runnable_cells(config: ModelConfig) -> list[str]:
    """Which of the four shape cells apply to this architecture (DESIGN.md §4)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if config.sub_quadratic:
        cells.append("long_500k")
    return cells
