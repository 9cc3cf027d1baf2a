"""Percent of the window in which the card runs no kernel, copy or memset:
one minus the union of the device's intervals over the window."""
from perfbench.trace import length


def read(tl, cell):
    return 100.0 * (1.0 - length(tl.busy()) / (tl.end - tl.start))
