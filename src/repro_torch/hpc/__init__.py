"""The paper's eight evaluated workloads, implemented on DolmaRuntime.

A copy of ``repro.hpc`` for this package, numpy as there.
"""
from repro_torch.hpc.base import (
    HPCWorkload,
    WorkloadResult,
    pooled_runtime,
    profile_workload,
    run_workload,
)
from repro_torch.hpc.bt import BT
from repro_torch.hpc.cg import CG
from repro_torch.hpc.ft import FT
from repro_torch.hpc.is_sort import IS
from repro_torch.hpc.lu import LU
from repro_torch.hpc.mg import MG
from repro_torch.hpc.miniamr import MiniAMR
from repro_torch.hpc.xsbench import XSBench

WORKLOADS = {
    "CG": CG,
    "MG": MG,
    "FT": FT,
    "BT": BT,
    "LU": LU,
    "IS": IS,
    "XSBench": XSBench,
    "miniAMR": MiniAMR,
}

__all__ = [
    "HPCWorkload", "WORKLOADS", "WorkloadResult", "pooled_runtime",
    "profile_workload", "run_workload",
] + list(WORKLOADS)
