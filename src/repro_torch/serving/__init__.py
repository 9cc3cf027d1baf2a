"""Serving: the batched engine over a DOLMA-tiered KV cache, MoE expert
paging, and the continuous-batching multi-tenant scheduler (a port of
``repro.serving``)."""
from repro_torch.serving.engine import AutoscaleConfig, EngineConfig, ServingEngine
from repro_torch.serving.expert_paging import (
    ExpertPager,
    ExpertPagingConfig,
    ExpertParamStore,
)
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
    "ExpertPager",
    "ExpertPagingConfig",
    "ExpertParamStore",
    "Request",
    "RequestQueue",
    "SchedulerConfig",
    "ServingEngine",
    "TenantState",
]
