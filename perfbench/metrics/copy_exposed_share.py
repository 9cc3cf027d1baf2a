"""Percent of the window in which a host-to-device or device-to-host copy
runs and no other device work does; nothing where no such copy ran."""
from perfbench.counts.categories import HOST_COPIES
from perfbench.trace import length


def read(tl, cell):
    if not tl.intervals(HOST_COPIES):
        return None
    return 100.0 * length(tl.copy_only()) / (tl.end - tl.start)
