"""Emulated memory fabric with a performance model calibrated to the paper.

The container has no InfiniBand hardware; DOLMA's remote tier is emulated on
host memory with a latency/bandwidth model anchored to the paper's measured
numbers (§3.1, Fig 4):

  * InfiniBand (100 Gb/s):  4 MiB seq write 424.46 µs, seq read 1561 µs,
    rand write 461.92 µs, rand read 1599.7 µs; 512 KiB rand write 60.4 µs;
    1–8 KiB ops land in the 2–6 µs range.
  * Ethernet (25 Gb/s): line rate 4x lower, higher per-op base cost.
  * Reads carry a round-trip penalty; writes stream one-sided (the paper's
    central read/write asymmetry — writes ~3.5x faster at 4 MiB).
  * Access pattern (seq vs rand) barely matters remotely (NIC DMA, no CPU
    cache effects) — the model therefore only distinguishes read vs write.

Times are accounted on a :class:`SimClock` (discrete-event, deterministic, and
independent of this container's wall clock) so benchmarks of 24-thread runs
are reproducible on a single CPU core.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Iterable

from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry


@dataclasses.dataclass(frozen=True)
class FabricModel:
    """time(op) = base_us + size_bytes / bw_bytes_per_us.

    ``read_gbps`` is the bandwidth of a *single outstanding* read (RTT-bound:
    the paper measures 4 MiB IB reads at ~2.7 GB/s). ``read_line_gbps`` is the
    asymptote when many reads are posted concurrently and pipeline the RTT —
    which is exactly what the dual buffer's asynchronous prefetch does; a
    synchronous on-demand reader never gets it (Fig 9/10's mechanism).
    """

    name: str
    read_base_us: float
    read_gbps: float        # one outstanding op (sync on-demand reads)
    write_base_us: float
    write_gbps: float       # one-sided writes stream near line rate already
    atomic_us: float        # one remote atomic (CAS / fetch-add)
    read_line_gbps: float = 0.0   # pipelined async reads; 0 => same as read_gbps
    max_op_bytes: int = 1 << 30   # fixed max transfer per RDMA op (§6.1.2)

    def read_us(self, size_bytes: int) -> float:
        return self._op_us(size_bytes, self.read_base_us, self.read_gbps)

    def write_us(self, size_bytes: int) -> float:
        return self._op_us(size_bytes, self.write_base_us, self.write_gbps)

    # calibration: a single outstanding 4 MiB read runs at read_gbps;
    # a window of W outstanding bytes pipelines the RTT:
    #   rate(W) = line * W / (W + W0),  W0 = 4MiB * (line/read_gbps - 1)
    @property
    def window_w0_bytes(self) -> float:
        line = self.read_line_gbps or self.read_gbps
        return 4 * (1 << 20) * max(line / self.read_gbps - 1.0, 1e-6)

    def stream_us(self, kind: str, size_bytes: int, chunk_bytes: int,
                  *, mode: str) -> float:
        """Duration of a chunked transfer.

        Reads: the paper's 4 MiB anchor (one blocking read, ~2.7 GB/s on IB)
        is the single-outstanding-op rate; DOLMA's posted asynchronous reads
        pipeline toward the ~11 GB/s line asymptote. Modes:

          pipelined — fully posted (dual-buffer prefetch): line rate, bounded
            by ~1M posted ops/s (tiny chunks from tiny budgets stay slow,
            §6.1.1);
          windowed — demand reads, <= one buffer-window outstanding:
            rate(W) = line*W/(W+W0); never slower than serial;
          serial — one op at a time (sync RDMA baseline): read_gbps flat.

        Writes are one-sided and stream near line rate in all modes (§3.1a).
        """
        if size_bytes <= 0:
            return 0.0
        chunk = max(min(chunk_bytes, self.max_op_bytes), 1)
        n_ops = -(-size_bytes // chunk)
        if kind != "read":
            base, bw = self.write_base_us, self.write_gbps
            if mode == "pipelined":
                return base + size_bytes / (bw * 1e3) + 1.0 * n_ops
            return n_ops * base + size_bytes / (bw * 1e3)

        base, bw = self.read_base_us, self.read_gbps
        line = self.read_line_gbps or self.read_gbps
        serial_us = n_ops * base + size_bytes / (bw * 1e3)
        if mode == "serial":
            return serial_us
        if mode == "pipelined":
            issue_us = 1.0 * n_ops  # ~1M posted ops/s/QP
            return base + max(size_bytes / (line * 1e3), issue_us)
        # windowed
        rate = line * chunk / (chunk + self.window_w0_bytes)
        windowed_us = n_ops * base + size_bytes / (rate * 1e3)
        return min(windowed_us, serial_us)

    def _op_us(self, size_bytes: int, base_us: float, gbps: float) -> float:
        if size_bytes < 0:
            raise ValueError("negative transfer size")
        bytes_per_us = gbps * 1e3  # GB/s == bytes/ns == 1e3 bytes/us
        n_ops = max(1, -(-size_bytes // self.max_op_bytes))
        return n_ops * base_us + size_bytes / bytes_per_us

    def scaled(self, factor: float) -> "FabricModel":
        """A model whose every op takes ``factor`` x as long.

        time' = factor * (base + bytes/bw) = (factor*base) + bytes/(bw/factor)
        — used to price a throttled emulation (wall-clock pacing at a
        fraction of the modeled fabric speed) without touching the anchors.
        """
        if not (factor > 0.0):
            raise ValueError(f"scaled(): factor must be > 0, got {factor!r}")
        return dataclasses.replace(
            self,
            name=f"{self.name}-x{factor:g}",
            read_base_us=self.read_base_us * factor,
            read_gbps=self.read_gbps / factor,
            write_base_us=self.write_base_us * factor,
            write_gbps=self.write_gbps / factor,
            atomic_us=self.atomic_us * factor,
            read_line_gbps=(self.read_line_gbps / factor
                            if self.read_line_gbps else 0.0),
        )


def fit_fabric_model(
    measurements: "Iterable[tuple[str, int, float]]",
    *,
    base: FabricModel,
    name: str | None = None,
) -> FabricModel:
    """Fit base-cost/bandwidth parameters from wall-clock measurements.

    ``measurements`` is an iterable of ``(kind, nbytes, us)`` samples from
    the real streaming path (kind: ``"read"`` | ``"write"``). Each kind with
    at least two distinct sizes gets a least-squares fit of the affine cost
    model ``us = base_us + nbytes / (gbps * 1e3)``; kinds without enough
    samples keep ``base``'s parameters. The fitted base is clamped to >= 0
    (measurement noise can produce a slightly negative intercept; a negative
    base would poison every later prediction), in which case the bandwidth
    is refit through the sample mean. The read fit also becomes
    ``read_line_gbps``: the measured path is fully posted, so the
    single-op and pipelined asymptote rates coincide by construction.
    """
    samples: dict[str, list[tuple[int, float]]] = {"read": [], "write": []}
    for kind, nbytes, us in measurements:
        if kind not in samples:
            raise ValueError(f"fit_fabric_model: unknown op kind {kind!r}")
        if nbytes <= 0 or not (us >= 0.0):
            raise ValueError(
                f"fit_fabric_model: bad sample ({kind!r}, {nbytes}, {us})"
            )
        samples[kind].append((int(nbytes), float(us)))

    fitted: dict[str, tuple[float, float]] = {}  # kind -> (base_us, gbps)
    for kind, pts in samples.items():
        if len({n for n, _ in pts}) < 2:
            continue
        xs = [float(n) for n, _ in pts]
        ys = [us for _, us in pts]
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        slope = sxy / sxx  # us per byte
        intercept = my - slope * mx
        if intercept < 0.0:
            intercept = 0.0
            slope = my / mx  # refit through the mean with base pinned at 0
        if slope <= 0.0:
            raise ValueError(
                f"fit_fabric_model: non-positive {kind} bandwidth fit "
                f"(slope {slope:.3g} us/byte) — sweep sizes too narrow?"
            )
        fitted[kind] = (intercept, 1.0 / (slope * 1e3))

    read_base, read_gbps = fitted.get("read", (base.read_base_us, base.read_gbps))
    write_base, write_gbps = fitted.get(
        "write", (base.write_base_us, base.write_gbps)
    )
    return dataclasses.replace(
        base,
        name=name or f"{base.name}-calibrated",
        read_base_us=read_base,
        read_gbps=read_gbps,
        read_line_gbps=read_gbps if "read" in fitted else base.read_line_gbps,
        write_base_us=write_base,
        write_gbps=write_gbps,
    )


def _calibrated(name, *, read_anchor, write_anchor, read_base_us, write_base_us,
                atomic_us, line_gbps):
    """Build a model whose large-transfer time matches a paper anchor point."""
    (r_bytes, r_us), (w_bytes, w_us) = read_anchor, write_anchor
    read_gbps = r_bytes / max(r_us - read_base_us, 1e-9) / 1e3
    write_gbps = w_bytes / max(w_us - write_base_us, 1e-9) / 1e3
    return FabricModel(
        name=name,
        read_base_us=read_base_us,
        read_gbps=read_gbps,
        write_base_us=write_base_us,
        write_gbps=write_gbps,
        atomic_us=atomic_us,
        read_line_gbps=line_gbps,
    )


MIB = 1 << 20

# Anchors from Fig 4: IB 4 MiB seq read = 1561 us, seq write = 424.46 us
# (single outstanding op). Pipelined line asymptote ~11 GB/s (100 Gb/s link).
INFINIBAND_100G = _calibrated(
    "infiniband-100g",
    read_anchor=(4 * MIB, 1561.0),
    write_anchor=(4 * MIB, 424.46),
    read_base_us=4.0,   # 1-8 KiB ops measured at 2-6 us
    write_base_us=2.5,
    atomic_us=3.0,
    line_gbps=11.0,
)

# Ethernet 25 Gb/s: 4x lower line rate, heavier per-op cost (paper Fig 4 shows
# Ethernet consistently ~3-5x slower than IB at large sizes).
ETHERNET_25G = _calibrated(
    "ethernet-25g",
    read_anchor=(4 * MIB, 4 * 1561.0),
    write_anchor=(4 * MIB, 4 * 424.46),
    read_base_us=12.0,
    write_base_us=8.0,
    atomic_us=10.0,
    line_gbps=2.8,
)

# Local DDR via NUMA (the Oracle baseline): no per-op base cost worth modeling
# at object granularity; ~25 GB/s effective stream per the paper's local
# numbers (4 MiB seq read 445 us -> 9.4 GB/s read path; seq write 557 us).
LOCAL_DDR = FabricModel(
    name="local-ddr",
    read_base_us=0.08,
    read_gbps=9.4,
    write_base_us=0.08,
    write_gbps=7.5,
    atomic_us=0.02,
)

# TPU-side constants (the adaptation targets; used by roofline + tiering).
# TPU_V5E_HBM_GBPS is the reference's TPU v5e HBM rate, not the H100's: the
# "auto" tiering budget prices a step's compute with it so that the port's
# plans stay equal to the reference's.
TPU_V5E_HBM_GBPS = 819.0
TPU_V5E_PEAK_BF16_TFLOPS = 197.0
TPU_V5E_ICI_GBPS_PER_LINK = 50.0
PCIE_HOST_GBPS = 32.0  # host<->HBM staging bandwidth (PCIe gen4 x16 class)


class SimClock:
    """Deterministic discrete-event clock.

    Threads of execution are modeled as named timelines; fabric resources
    (QPs) serialize the ops scheduled on them. ``now`` of a timeline advances
    as work is charged to it.
    """

    def __init__(self) -> None:
        self._timeline_now: dict[str, float] = {}
        self._lock = threading.Lock()

    def now(self, timeline: str = "main") -> float:
        return self._timeline_now.get(timeline, 0.0)

    def advance(self, timeline: str, us: float) -> float:
        """Charge ``us`` of busy time to ``timeline``; return its new now."""
        # `not (us >= 0)` also catches NaN: a single corrupted charge would
        # silently poison every later timestamp on the timeline (and, via
        # makespan, every benchmark number derived from it)
        if not (us >= 0.0):
            raise ValueError(f"advance({timeline!r}): invalid charge {us!r}")
        with self._lock:
            t = self._timeline_now.get(timeline, 0.0) + us
            self._timeline_now[timeline] = t
            return t

    def wait_until(self, timeline: str, t_us: float) -> float:
        if not (t_us >= 0.0):
            raise ValueError(
                f"wait_until({timeline!r}): invalid target {t_us!r}"
            )
        with self._lock:
            t = max(self._timeline_now.get(timeline, 0.0), t_us)
            self._timeline_now[timeline] = t
            return t

    def makespan(self) -> float:
        return max(self._timeline_now.values(), default=0.0)

    def reset(self) -> None:
        with self._lock:
            self._timeline_now.clear()


#: Historical name for the per-timeline fabric clock (docs/issues refer to
#: the timeline set as "fabric timelines"; the class predates that naming).
FabricTimelines = SimClock


class FabricResource:
    """One RDMA resource (QP + CQ): ops issued on it serialize.

    Models the contention the paper's two-level scheduler (§4.3) manages:
    threads sharing a resource queue behind one another.
    """

    _ids = itertools.count()

    def __init__(self, clock: SimClock, model: FabricModel, name: str | None = None,
                 *, telemetry: Telemetry | None = None, track: str | None = None):
        self.clock = clock
        self.model = model
        self.name = name or f"qp{next(self._ids)}"
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.track = track or f"fabric/{self.name}"
        self._free_at = 0.0
        self._lock = threading.Lock()
        self.bytes_read = 0
        self.bytes_written = 0
        self.n_ops = 0

    @property
    def free_at(self) -> float:
        """Sim-time this QP drains — the congestion signal routing reads."""
        with self._lock:
            return self._free_at

    def calibrate(
        self,
        measurements: Iterable[tuple[str, int, float]],
        *,
        name: str | None = None,
    ) -> FabricModel:
        """Refit this resource's cost model from real-path measurements.

        ``measurements`` come from a microbenchmark sweep of the measured
        streaming executor (:class:`repro_torch.core.exec.HostFetchEngine`
        collects them as ``(kind, nbytes, us)`` wall-clock samples). The
        fitted model (:func:`fit_fabric_model`) replaces :attr:`model` in
        place, so every op this QP subsequently prices — and every simulator
        prediction issued through it — uses the calibrated parameters.
        Returns the new model.
        """
        self.model = fit_fabric_model(measurements, base=self.model, name=name)
        return self.model

    def issue(self, kind: str, size_bytes: int, issue_time_us: float) -> tuple[float, float]:
        """Issue an op at ``issue_time_us``; returns (start, completion) times."""
        dur = (
            self.model.read_us(size_bytes)
            if kind == "read"
            else self.model.write_us(size_bytes)
            if kind == "write"
            else self.model.atomic_us
        )
        return self._occupy(kind, size_bytes, issue_time_us, dur)

    def issue_stream(self, kind: str, size_bytes: int, chunk_bytes: int,
                     issue_time_us: float, *, pipelined: bool | str) -> tuple[float, float]:
        """Issue a chunked transfer. ``pipelined`` accepts True ('pipelined'),
        False ('serial'), or an explicit mode string incl. 'windowed'."""
        if size_bytes <= 0:
            t = issue_time_us
            return t, t
        mode = pipelined if isinstance(pipelined, str) else (
            "pipelined" if pipelined else "serial"
        )
        dur = self.model.stream_us(kind, size_bytes, chunk_bytes, mode=mode)
        return self._occupy(kind, size_bytes, issue_time_us, dur)

    def issue_batch(self, kind: str, sizes: list[int], chunk_bytes: int,
                    issue_time_us: float, *, mode: str = "pipelined",
                    ) -> tuple[float, list[float], float]:
        """One posted scatter-gather transfer spanning several extents.

        The per-op base cost is paid once for the whole batch; element *i*
        completes when the cumulative bytes through it have streamed.
        Counts as a single posted op. Returns (start, completions, end).
        """
        total = sum(max(s, 0) for s in sizes)
        if total <= 0:
            t = issue_time_us
            return t, [t] * len(sizes), t
        with self._lock:
            start = max(self._free_at, issue_time_us)
            completions: list[float] = []
            cum = 0
            for s in sizes:
                cum += max(s, 0)
                completions.append(
                    start + self.model.stream_us(kind, cum, chunk_bytes, mode=mode)
                )
            end = max(completions)
            self._free_at = end
            self.n_ops += 1
            if kind == "read":
                self.bytes_read += total
            elif kind == "write":
                self.bytes_written += total
        self._record(f"{kind}_batch", start, end, total, n_requests=len(sizes))
        return start, completions, end

    def _occupy(self, kind: str, size_bytes: int, issue_time_us: float,
                dur: float) -> tuple[float, float]:
        with self._lock:
            start = max(self._free_at, issue_time_us)
            end = start + dur
            self._free_at = end
            self.n_ops += 1
            if kind == "read":
                self.bytes_read += size_bytes
            elif kind == "write":
                self.bytes_written += size_bytes
        self._record(kind, start, end, size_bytes)
        return start, end

    def _record(self, kind: str, start: float, end: float, size_bytes: int,
                **args) -> None:
        """One span per op on this QP's track + per-track byte/op counters."""
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.record_span(kind, track=self.track, begin_us=start, end_us=end,
                        cat="io", nbytes=size_bytes, **args)
        tel.count("fabric.n_ops", 1, track=self.track)
        if kind.startswith("read"):
            tel.count("fabric.bytes_read", size_bytes, track=self.track)
        elif kind.startswith("write"):
            tel.count("fabric.bytes_written", size_bytes, track=self.track)
