"""The port's core: DOLMA's data-object runtime and the streaming executor.

Re-exports what the port has so far, as ``repro.core`` does: the slab
allocator, remote store and memory pool, the dual-buffer runtime, the sizing
advisor, the two-level scheduler, placement over an object catalog, the
fabric model and simulated clock, telemetry, the measured streaming
executor, and the tiering of a model's parameters with its layer loop. The
reference's training-side tiering names (the remat scans, the gradient-safe
barrier, the sharding probes) wait for their slices.
"""
from repro_torch.core.alloc import (
    DEFAULT_STRIPE_BYTES,
    SlabAllocator,
    object_footprint_bytes,
    size_class_bytes,
)
from repro_torch.core.dual_buffer import DolmaRuntime, run_iterative
from repro_torch.core.exec import (
    ExecResult,
    HostFetchEngine,
    SimReport,
    StreamingExecutor,
    StreamStage,
    attention_chain,
    balanced_throttle,
    matmul_chain,
    untiered_oracle,
)
from repro_torch.core.fabric import (
    ETHERNET_25G,
    INFINIBAND_100G,
    LOCAL_DDR,
    FabricModel,
    FabricResource,
    FabricTimelines,
    SimClock,
    fit_fabric_model,
)
from repro_torch.core.metadata import MetadataTable, ObjectMeta, Status, Tier
from repro_torch.core.objects import (
    SMALL_OBJECT_BYTES,
    DataObject,
    ObjectCatalog,
    ObjectKind,
)
from repro_torch.core.placement import (
    PlacementPlan,
    PlacementPolicy,
    PlanDiff,
    demotion_order,
    diff_plans,
)
from repro_torch.core.pool import ExtentLostError, MemoryPool, OrphanExtentError
from repro_torch.core.remote_store import NodeFailure, RemoteStore
from repro_torch.core.scheduler import ThreadBuffers, TwoLevelScheduler
from repro_torch.core.sizing import (
    CostModel,
    ModelConfig,
    RollingProfile,
    SizingAdvice,
    WorkloadProfile,
    advise_local_size,
    synthetic_profile,
)
from repro_torch.core.telemetry import (
    NULL_TELEMETRY,
    MetricsSnapshot,
    Telemetry,
    validate_chrome_trace,
)
from repro_torch.core.tiering import (
    RemoteGrads,
    TieringConfig,
    blocked_remat_scan,
    grad_safe_barrier,
    place_params,
    place_state,
    prefetch_scan,
    remote_carry_placer,
    plan_for_params,
    supports_host_offload,
    tiered_scan,
)

__all__ = [
    "CostModel",
    "DEFAULT_STRIPE_BYTES",
    "DataObject",
    "DolmaRuntime",
    "ETHERNET_25G",
    "ExecResult",
    "ExtentLostError",
    "FabricModel",
    "FabricResource",
    "FabricTimelines",
    "HostFetchEngine",
    "INFINIBAND_100G",
    "LOCAL_DDR",
    "MemoryPool",
    "MetadataTable",
    "MetricsSnapshot",
    "ModelConfig",
    "NULL_TELEMETRY",
    "NodeFailure",
    "ObjectCatalog",
    "ObjectKind",
    "ObjectMeta",
    "OrphanExtentError",
    "PlacementPlan",
    "PlacementPolicy",
    "PlanDiff",
    "RemoteStore",
    "RollingProfile",
    "SMALL_OBJECT_BYTES",
    "SimClock",
    "SimReport",
    "SizingAdvice",
    "SlabAllocator",
    "Status",
    "StreamStage",
    "StreamingExecutor",
    "Telemetry",
    "ThreadBuffers",
    "Tier",
    "TieringConfig",
    "TwoLevelScheduler",
    "WorkloadProfile",
    "advise_local_size",
    "attention_chain",
    "balanced_throttle",
    "demotion_order",
    "diff_plans",
    "fit_fabric_model",
    "matmul_chain",
    "object_footprint_bytes",
    "RemoteGrads",
    "blocked_remat_scan",
    "grad_safe_barrier",
    "place_params",
    "place_state",
    "plan_for_params",
    "prefetch_scan",
    "remote_carry_placer",
    "run_iterative",
    "size_class_bytes",
    "supports_host_offload",
    "synthetic_profile",
    "tiered_scan",
    "untiered_oracle",
    "validate_chrome_trace",
]
