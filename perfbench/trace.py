"""The traced run's timeline: device intervals from ``torch.profiler``,
kept in memory, and the interval arithmetic the per-layer metrics use.

The window is the ``perfbench.window`` range recorded on the host; every
device operation (kernel, copy, memset) is clipped to it. Shares of the
window are unions of intervals, never sums of durations: a copy and a
kernel that overlap on two streams cover the window once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import re
import types

from perfbench.counts.categories import HOST_COPIES, category

WINDOW = "perfbench.window"
TOP = 10


def union(iv) -> list[tuple[int, int]]:
    """Intervals ``iv`` ((start, end) pairs) merged into disjoint sorted
    ones."""
    out: list[list[int]] = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(iv) -> int:
    """Total length of disjoint intervals ``iv``."""
    return sum(e - s for s, e in iv)


def minus(a, b) -> list[tuple[int, int]]:
    """The parts of disjoint sorted ``a`` that disjoint sorted ``b`` does
    not cover."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int       # ns
    end: int         # ns
    category: str


@dataclasses.dataclass
class Timeline:
    """A traced window: its bounds (ns), the device's operations in it,
    and the host's (name, start, end) ranges, for the idle gaps."""
    start: int
    end: int
    ops: list[DeviceOp]
    host: list[tuple[str, int, int]]
    steps: int = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def intervals(self, cats=None, exclude=()) -> list[tuple[int, int]]:
        """The union of the operations of categories ``cats`` (all by
        default) but ``exclude``."""
        return union((o.start, o.end) for o in self.ops
                     if (cats is None or o.category in cats)
                     and o.category not in exclude)

    def time_ns(self, cats=None, exclude=()) -> int:
        """Summed durations (not a union) of those operations."""
        return sum(o.end - o.start for o in self.ops
                   if (cats is None or o.category in cats)
                   and o.category not in exclude)

    def count(self, pattern: str) -> int:
        """Launches whose name matches ``pattern``."""
        pat = re.compile(pattern)
        return sum(1 for o in self.ops if pat.search(o.name))

    def busy(self) -> list[tuple[int, int]]:
        return self.intervals()

    def copy_only(self) -> list[tuple[int, int]]:
        """Where a host-device copy runs and no other device work does."""
        return minus(self.intervals(HOST_COPIES),
                     self.intervals(exclude=HOST_COPIES))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing (the innermost host range open at
        the gap's middle), each summed by name, ``TOP`` of each."""
        by_op = collections.Counter()
        for o in self.ops:
            by_op[o.name[:120]] += (o.end - o.start) / 1e9
        idle = minus([(self.start, self.end)], self.busy())
        by_host = collections.Counter()
        # gaps in order of their middles; host ranges opened in order of
        # their starts; the open range that started last and has not
        # ended before the middle is the innermost one there
        host = iter(sorted((s, e, n) for n, s, e in self.host))
        nxt = next(host, None)
        open_: list = []
        for s, e in idle:
            mid = (s + e) // 2
            while nxt is not None and nxt[0] <= mid:
                heapq.heappush(open_, (-nxt[0], nxt[1], nxt[2]))
                nxt = next(host, None)
            while open_ and open_[0][1] < mid:
                heapq.heappop(open_)
            name = open_[0][2][:120] if open_ else "(none)"
            by_host[name] += (e - s) / 1e9
        return {"device_ops": [[n, s] for n, s in by_op.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(TOP)]}


@contextlib.contextmanager
def traced(enabled: bool):
    """``torch.profiler`` over the block, CPU and CUDA activity, when
    ``enabled``; yields a holder whose ``results`` are the raw trace once
    the block has closed (None when not enabled)."""
    holder = types.SimpleNamespace(results=None)
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.results = prof.profiler.kineto_results


def timeline(results, steps: int) -> Timeline:
    """The window's timeline from a finished profiler.

    Device events are the card's kernels, copies and memsets; the
    profiler also mirrors each host range (``record_function``) on the
    device, under the range's own name, and those are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = results.events()
    window, device, host = None, [], []
    for e in events:
        if e.device_type() == cuda:
            continue
        name, s = e.name(), e.start_ns()
        if name == WINDOW:
            window = (s, s + e.duration_ns())
        else:
            host.append((name, s, s + e.duration_ns()))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    ranges = {h[0] for h in host} | {WINDOW}
    for e in events:
        if e.device_type() != cuda or e.name() in ranges:
            continue
        name, s = e.name(), e.start_ns()
        device.append((name, s, s + e.duration_ns(), category(name)))
    w0, w1 = window
    ops = [DeviceOp(n, max(s, w0), min(e, w1), c)
           for n, s, e, c in device if e > w0 and s < w1]
    host = [(n, s, e) for n, s, e in host if e > w0 and s < w1]
    return Timeline(w0, w1, ops, host, steps)
