"""Percent: the least time of B2's backward calls (delta, dk/dv, dq and, where
its heads are split, a reduce kernel a call; counted by the delta kernel),
each the larger of its operations over the bf16 peak and its bytes over
HBM's, over the device time of all the kernels of those calls; nothing where
no call ran."""
from perfbench.counts import calls

LAUNCH = r"flash_bwd_delta"


def read(tl, cell):
    bound = calls.b2_bwd_bound_s(cell.model, cell.traffic)
    return calls.roofline_share(tl.count(LAUNCH), bound,
                                tl.time_ns(("b2_bwd",)))
