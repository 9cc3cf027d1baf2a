"""The port's core: the streaming executor and the substrate it stands on.

Re-exports this slice only: placement over an object catalog, the fabric
model and simulated clock, telemetry, and the measured streaming executor.
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
