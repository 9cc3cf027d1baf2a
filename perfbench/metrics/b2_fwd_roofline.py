"""Percent: the least time of B2's forward calls (one kernel a call), each the
larger of its operations over the bf16 peak and its bytes over HBM's, over
the device time of all the kernels of those calls; nothing where no call
ran."""
from perfbench.counts import calls

LAUNCH = r"flash_(wgmma|fwd)_kernel"


def read(tl, cell):
    bound = calls.b2_fwd_bound_s(cell.model, cell.traffic)
    return calls.roofline_share(tl.count(LAUNCH), bound,
                                tl.time_ns(("b2_fwd",)))
