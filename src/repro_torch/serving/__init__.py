"""Serving: the batched engine over a DOLMA-tiered KV cache, and the
continuous-batching multi-tenant scheduler (a port of ``repro.serving``;
MoE expert paging waits for ROADMAP A7)."""
from repro_torch.serving.engine import AutoscaleConfig, EngineConfig, ServingEngine
from repro_torch.serving.scheduler import (
    ContinuousScheduler,
    Request,
    RequestQueue,
    SchedulerConfig,
    TenantState,
)

__all__ = [
    "AutoscaleConfig",
    "ContinuousScheduler",
    "EngineConfig",
    "Request",
    "RequestQueue",
    "SchedulerConfig",
    "ServingEngine",
    "TenantState",
]
