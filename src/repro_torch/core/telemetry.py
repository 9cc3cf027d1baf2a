"""Unified telemetry: span tracing, counters/gauges, and trace export.

Every subsystem of the simulator reports time and bytes somewhere — the
fabric timelines expose ``now()``, the pool counts per-QP bytes, the
runtime keeps private prefetch counters, the serving engine logs autoscale
decisions — but until this module there was no single place where a run's
*structure* (where time went: fetch stall vs. overlapped prefetch vs.
compute; where bytes live: per tier, per pool node) could be read off or
exported. :class:`Telemetry` is that place:

  * a **span tracer** — ``with tel.span("fetch", timeline=..., obj=...)``
    records begin/end on the *simulated* fabric clock (explicit-time
    recording via :meth:`Telemetry.record_span` for callers that compute
    ``(start, end)`` analytically, which is most of the simulator);
  * a **counter/gauge registry** — monotonically accumulating counters
    (cache hits/misses, prefetch accuracy inputs, bytes moved per tier and
    per pool node, stall-µs vs. overlap-µs) and last-value gauges
    (per-wave KV occupancy, autoscale targets), with flat ``name{k=v}``
    label encoding;
  * **exporters** — a Chrome-trace-event JSON writer (open the file at
    https://ui.perfetto.dev: one track per fabric timeline/QP/node, spans
    nested under them) and a flat :class:`MetricsSnapshot` with a
    :meth:`MetricsSnapshot.diff` for regression comparison.

Telemetry is process-wide *but injectable*: components accept an optional
``telemetry=`` and default to the shared :data:`NULL_TELEMETRY`, whose
recorders return immediately — tracing disabled is the default and changes
no benchmark number (telemetry only ever *reads* the clock, never advances
it; the reconciliation tests in ``tests/test_telemetry.py`` assert both
properties).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Iterator

# span categories (the event taxonomy, DESIGN.md §9):
#   compute   — time the compute timeline advanced doing work
#   stall     — time the compute timeline waited on the fabric (barriers)
#   io        — fabric-resource occupancy (one span per RDMA op/stream/batch)
#   step      — one runtime iteration (parent span; children nest under it)
#   migration — pool rebalance / recovery passes
#   serve     — serving waves (wall-clock track)
#   span      — anything recorded via the generic ``span()`` context manager
SPAN_CATS = ("compute", "stall", "io", "step", "migration", "serve", "span")

# categories whose durations tile a compute timeline end-to-end: their sum
# reconciles with the simulator's elapsed_us (asserted in tests)
TIMELINE_CATS = ("compute", "stall")


def _json_default(obj: Any) -> Any:
    """Best-effort JSON coercion for numpy scalars and exotic arg values."""
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return str(obj)


@dataclasses.dataclass
class SpanEvent:
    """One begin/end interval on a named track (timeline/QP/node)."""

    name: str
    track: str
    begin_us: float
    end_us: float
    cat: str = "span"
    args: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dur_us(self) -> float:
        """Span duration in microseconds."""
        return self.end_us - self.begin_us


@dataclasses.dataclass
class InstantEvent:
    """A point-in-time marker (autoscale decision, eviction, node failure)."""

    name: str
    track: str
    t_us: float
    args: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MetricsSnapshot:
    """Flat counter/gauge snapshot — the regression-comparison surface.

    ``counters`` accumulate monotonically over a run; ``gauges`` hold the
    last observed value. ``diff`` compares two snapshots of the same
    schema: counter deltas plus ``(old, new)`` pairs for changed gauges.
    """

    counters: dict[str, float] = dataclasses.field(default_factory=dict)
    gauges: dict[str, float] = dataclasses.field(default_factory=dict)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        """Serialize with sorted keys (stable diff/regression artifacts)."""
        return {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "meta": dict(self.meta),
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "MetricsSnapshot":
        """Rebuild a snapshot from its :meth:`to_json` dict."""
        return cls(
            counters=dict(d.get("counters", {})),
            gauges=dict(d.get("gauges", {})),
            meta=dict(d.get("meta", {})),
        )

    def diff(self, other: "MetricsSnapshot") -> dict[str, Any]:
        """``self`` (baseline) → ``other`` (current): counter deltas and
        changed gauges, for perf-regression comparison."""
        keys = sorted(set(self.counters) | set(other.counters))
        counters = {
            k: other.counters.get(k, 0.0) - self.counters.get(k, 0.0)
            for k in keys
        }
        gauges = {
            k: (self.gauges.get(k), other.gauges.get(k))
            for k in sorted(set(self.gauges) | set(other.gauges))
            if self.gauges.get(k) != other.gauges.get(k)
        }
        return {
            "counters": {k: v for k, v in counters.items() if v != 0.0},
            "gauges": gauges,
        }


def _key(name: str, labels: dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Telemetry:
    """Injectable span tracer + counter registry over a simulated clock.

    ``clock`` is any object with ``now(timeline) -> float`` (a
    :class:`~repro_torch.core.fabric.SimClock`); it is only *read*. A Telemetry
    created unbound is bound lazily by the first component that owns a
    clock (:meth:`bind_clock`), so one instance can be handed to a whole
    runtime/pool/engine stack at construction time.
    """

    def __init__(self, *, clock: Any | None = None, enabled: bool = True,
                 max_events: int = 500_000) -> None:
        self.clock = clock
        self.enabled = enabled
        self.max_events = max_events
        self.spans: list[SpanEvent] = []
        self.instants: list[InstantEvent] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.dropped_events = 0
        self._lock = threading.Lock()
        # wall-clock origin for measured (non-simulated) tracks: set lazily
        # on the first wall reading so wall tracks and simulated tracks both
        # start near t=0 and render side by side in one Perfetto view
        self._wall_origin: float | None = None

    def bind_clock(self, clock: Any) -> None:
        """Attach a clock after construction (first owner wins)."""
        if self.clock is None:
            self.clock = clock

    # -- recording ---------------------------------------------------------
    def record_span(self, name: str, *, track: str, begin_us: float,
                    end_us: float, cat: str = "span", **args: Any) -> None:
        """Record a span whose begin/end were computed analytically."""
        if not self.enabled:
            return
        with self._lock:
            if len(self.spans) + len(self.instants) >= self.max_events:
                self.dropped_events += 1
                return
            self.spans.append(
                SpanEvent(name=name, track=track, begin_us=float(begin_us),
                          end_us=float(end_us), cat=cat, args=args)
            )

    @contextlib.contextmanager
    def span(self, name: str, *, timeline: str = "main", cat: str = "span",
             **args: Any) -> Iterator[None]:
        """Span over a ``with`` body, clocked on the simulated ``timeline``.

        Reads the bound clock at entry and exit — the body is expected to
        advance the simulated timeline (charge compute, wait on a fetch);
        wall-clock never enters the trace.
        """
        if not self.enabled or self.clock is None:
            yield
            return
        t0 = self.clock.now(timeline)
        try:
            yield
        finally:
            self.record_span(name, track=timeline, begin_us=t0,
                             end_us=self.clock.now(timeline), cat=cat, **args)

    def wall_now_us(self) -> float:
        """Wall-clock µs since this instance's first wall reading.

        The measured-overlap executor records real fetch/compute spans with
        these timestamps; the shared origin keeps them comparable with the
        simulated tracks (both start near 0) in one exported trace.
        """
        now = time.perf_counter()
        with self._lock:
            if self._wall_origin is None:
                self._wall_origin = now
            return (now - self._wall_origin) * 1e6

    @contextlib.contextmanager
    def wall_span(self, name: str, *, track: str, cat: str = "span",
                  **args: Any) -> Iterator[None]:
        """Span over a ``with`` body measured on the real (wall) clock."""
        if not self.enabled:
            yield
            return
        t0 = self.wall_now_us()
        try:
            yield
        finally:
            self.record_span(name, track=track, begin_us=t0,
                             end_us=self.wall_now_us(), cat=cat, **args)

    def instant(self, name: str, *, track: str, t_us: float | None = None,
                timeline: str | None = None, **args: Any) -> None:
        """Record a point event; time from ``t_us`` or the bound clock."""
        if not self.enabled:
            return
        if t_us is None:
            t_us = (self.clock.now(timeline or track)
                    if self.clock is not None else 0.0)
        with self._lock:
            if len(self.spans) + len(self.instants) >= self.max_events:
                self.dropped_events += 1
                return
            self.instants.append(
                InstantEvent(name=name, track=track, t_us=float(t_us),
                             args=args)
            )

    def count(self, name: str, delta: float = 1.0, **labels: Any) -> None:
        """Accumulate ``delta`` onto counter ``name`` (flat label encoding)."""
        if not self.enabled:
            return
        key = _key(name, labels)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + float(delta)

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set gauge ``name`` to its latest observed value."""
        if not self.enabled:
            return
        with self._lock:
            self.gauges[_key(name, labels)] = float(value)

    # -- queries -----------------------------------------------------------
    def counter(self, name: str, **labels: Any) -> float:
        """Current value of a counter under exactly these labels (0 if unset)."""
        with self._lock:
            return self.counters.get(_key(name, labels), 0.0)

    def tracks(self) -> list[str]:
        """All track names that recorded a span or instant, sorted."""
        with self._lock:
            seen = {s.track for s in self.spans}
            seen.update(i.track for i in self.instants)
        return sorted(seen)

    def spans_on(self, track: str,
                 cats: tuple[str, ...] | None = None) -> list[SpanEvent]:
        """Spans recorded on ``track``, optionally filtered by category."""
        with self._lock:
            return [s for s in self.spans
                    if s.track == track and (cats is None or s.cat in cats)]

    def track_total_us(self, track: str,
                       cats: tuple[str, ...] = TIMELINE_CATS) -> float:
        """Summed span durations on a track, leaf categories only.

        With the default categories this reconciles with the simulator:
        compute + stall spans tile a runtime timeline end-to-end, so the
        total equals ``clock.now(track)`` (asserted in tests).
        """
        return sum(s.dur_us for s in self.spans_on(track, cats))

    def track_end_us(self, track: str) -> float:
        """Latest span end on a track (0 if the track has no spans)."""
        spans = self.spans_on(track)
        return max((s.end_us for s in spans), default=0.0)

    def reset(self) -> None:
        """Drop all recorded events, counters, gauges, and the wall origin."""
        with self._lock:
            self.spans.clear()
            self.instants.clear()
            self.counters.clear()
            self.gauges.clear()
            self.dropped_events = 0
            self._wall_origin = None

    # -- exporters ---------------------------------------------------------
    def snapshot(self, **meta: Any) -> MetricsSnapshot:
        """Flat counter/gauge snapshot; ``meta`` is carried verbatim."""
        with self._lock:
            meta = dict(meta)
            if self.dropped_events:
                meta["dropped_events"] = self.dropped_events
            return MetricsSnapshot(
                counters=dict(self.counters),
                gauges=dict(self.gauges),
                meta=meta,
            )

    def to_chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON (the Perfetto/about:tracing format).

        One ``tid`` per track, named via ``thread_name`` metadata events;
        spans become complete (``ph: "X"``) events, instants ``ph: "i"``.
        Timestamps are the recorded microseconds (simulated-clock tracks
        and wall-clock tracks coexist; they share an origin of 0).
        """
        with self._lock:
            spans = list(self.spans)
            instants = list(self.instants)
            counters = dict(self.counters)
        tracks = sorted({s.track for s in spans} | {i.track for i in instants})
        tid_of = {track: tid for tid, track in enumerate(tracks, start=1)}
        events: list[dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "dolma-sim"}},
        ]
        for track, tid in tid_of.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": track}})
        for s in spans:
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": s.begin_us, "dur": s.dur_us,
                "pid": 1, "tid": tid_of[s.track], "args": s.args,
            })
        for i in instants:
            events.append({
                "name": i.name, "cat": "instant", "ph": "i", "s": "t",
                "ts": i.t_us, "pid": 1, "tid": tid_of[i.track],
                "args": i.args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"counters": dict(sorted(counters.items()))},
        }

    def write_chrome_trace(self, path: str) -> dict[str, Any]:
        """Serialize :meth:`to_chrome_trace` to ``path``; returns the dict."""
        trace = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f, indent=None, default=_json_default)
            f.write("\n")
        return trace


#: Shared disabled instance — the default for every ``telemetry=`` slot.
NULL_TELEMETRY = Telemetry(enabled=False)


def validate_chrome_trace(trace: dict[str, Any]) -> None:
    """Validate a dict against the Chrome trace-event schema (the subset
    this exporter emits); raises :class:`ValueError` on the first problem.

    Checked: ``traceEvents`` is a list of dicts; every event has ``ph``,
    ``pid``, ``tid`` and ``name``; complete events (``X``) carry numeric
    ``ts``/``dur`` with ``dur >= 0``; instants (``i``) carry numeric ``ts``
    and a scope ``s``; metadata events (``M``) carry an ``args.name``; every
    referenced ``tid`` has a ``thread_name`` metadata event.
    """
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    named_tids: set[tuple[int, int]] = set()
    used_tids: set[tuple[int, int]] = set()
    for n, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {n}: not an object")
        for field in ("ph", "pid", "tid", "name"):
            if field not in ev:
                raise ValueError(f"event {n}: missing {field!r}")
        ph = ev["ph"]
        if ph == "M":
            if ev["name"] == "thread_name":
                if not ev.get("args", {}).get("name"):
                    raise ValueError(f"event {n}: thread_name without a name")
                named_tids.add((ev["pid"], ev["tid"]))
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"event {n}: {ph!r} needs a numeric ts")
        used_tids.add((ev["pid"], ev["tid"]))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {n}: X needs a numeric dur >= 0")
        elif ph == "i":
            if ev.get("s") not in ("t", "p", "g"):
                raise ValueError(f"event {n}: instant scope must be t/p/g")
        else:
            raise ValueError(f"event {n}: unknown phase {ph!r}")
    unnamed = used_tids - named_tids
    if unnamed:
        raise ValueError(f"tracks without thread_name metadata: {sorted(unnamed)}")
