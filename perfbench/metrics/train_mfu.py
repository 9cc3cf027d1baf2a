"""Percent of the card's bf16 peak that the window's model FLOPs (the
steps' forward products once, backward twice, recomputation not counted)
reach over the window."""
from perfbench.counts import mfu, peaks


def read(tl, cell):
    flops = mfu.step_flops(cell.model, cell.traffic["batch"],
                           cell.traffic["seq"])
    if flops is None or tl.steps == 0:
        return None
    return 100.0 * flops * tl.steps / (tl.seconds * peaks.BF16_FLOPS)
