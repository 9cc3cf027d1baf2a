"""The port's core: the streaming executor and the substrate it stands on.

Re-exports what the port has so far: placement over an object catalog, the
fabric model and simulated clock, telemetry, the measured streaming
executor, and the tiering of a model's parameters with its layer loop.
"""
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
    INFINIBAND_100G,
    FabricModel,
    FabricResource,
    SimClock,
    fit_fabric_model,
)
from repro_torch.core.metadata import Tier
from repro_torch.core.objects import DataObject, ObjectCatalog, ObjectKind
from repro_torch.core.placement import PlacementPlan, PlacementPolicy
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.core.tiering import (
    TieringConfig,
    place_params,
    plan_for_params,
    tiered_scan,
)
