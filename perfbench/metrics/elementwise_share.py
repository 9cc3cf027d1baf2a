"""Percent of kernel time (copies and memsets left out) in kernels that
are neither cuBLAS GEMMs nor the port's B2 or B3 kernels."""
from perfbench.counts.categories import NOT_KERNELS


def read(tl, cell):
    total = tl.time_ns(exclude=NOT_KERNELS)
    if total <= 0:
        return None
    return 100.0 * tl.time_ns(("elementwise",)) / total
