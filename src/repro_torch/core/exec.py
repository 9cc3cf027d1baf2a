"""Measured overlap: DOLMA's dual buffer run for real on an NVIDIA card.

The port of ``repro.core.exec``. :class:`StreamingExecutor` runs a chain of
compute stages whose data objects (matmul weights, attention K/V) are
placed by the §4.1 policy:

  * LOCAL-tier objects live on the card, copied there once at placement;
  * REMOTE-tier objects live in pinned host memory and stream in through
    :class:`HostFetchEngine` — one emulated QP (a worker thread) that
    sleeps the modeled fabric time, then really moves the bytes with an
    asynchronous host-to-device copy on its own CUDA stream;
  * compute runs through the hand-written kernels
    (:mod:`repro_torch.kernels.ops`) on the caller's current stream;
  * the dual buffer is the prefetch: the next remote stage's fetch is
    posted *before* the current stage computes, so copy and kernel overlap;
    the deferred access barrier is :meth:`HostFetchEngine.acquire` at
    first use: it waits for the read, then the compute stream waits on the
    copy's CUDA event just before the stage's kernel is launched;
  * ``commit_output=True`` writes the final activation back to pinned host
    memory on the copy stream, after an event recorded on the compute
    stream.

Pinned memory matters: a ``non_blocking`` copy from pageable memory runs
synchronously, and the overlap would vanish without an error. Per-stage
compute times synchronise the compute stream only; a device-wide
synchronise would also wait for the copy stream and charge fetch time to
compute.

:meth:`StreamingExecutor.simulate` replays the identical control flow on a
:class:`~repro_torch.core.fabric.SimClock`, and
:meth:`FabricResource.calibrate` fits its cost model from the engine's own
wall-clock measurements, so the prediction error is a property of the
model. Outputs are bit-identical to the untiered oracle: prefetch on,
prefetch off and all-local runs launch the same deterministic kernels on
the same values.

Every entry point takes ``device=``, ``"cuda"`` by default, and raises when
asked for a card that is not there. ``device="cpu"`` runs the same control
flow with the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.fabric import (
    FabricModel,
    FabricResource,
    INFINIBAND_100G,
    SimClock,
)
from repro_torch.core.metadata import Tier
from repro_torch.core.objects import DataObject, ObjectCatalog, ObjectKind
from repro_torch.core.placement import PlacementPlan, PlacementPolicy
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.kernels import ops
from repro_torch.kernels.traced import is_traced

#: Default RDMA-op chunk for the emulated QP (the paper's 4 MiB anchor).
DEFAULT_CHUNK_BYTES = 4 << 20


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; raises if it is a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run the plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):  # meta: shapes only, no data
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def host_tensor(a: Any, *, pin: bool) -> torch.Tensor:
    """A contiguous CPU tensor of ``a`` (tensor or numpy array), pinned if
    asked — the form REMOTE objects take in the host store."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    t = t.contiguous()
    # a traced (fake) tensor has no memory to pin: it stands for the
    # pinned copy it would be
    if pin and not is_traced(t) and not t.is_pinned():
        t = t.pin_memory()
    return t


def _draw(a: np.ndarray, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """Float32 numpy draw -> host tensor of ``dtype`` (numpy has no bf16)."""
    return host_tensor(torch.from_numpy(a.astype(np.float32)).to(dtype),
                       pin=pin)


@dataclasses.dataclass
class StreamStage:
    """One link of a streamed compute chain.

    ``params`` holds the streamable payloads by role — ``{"w": ...}`` for a
    matmul stage, ``{"k": ..., "v": ...}`` for an attention stage (the KV
    path) — as host tensors. ``kwargs`` is forwarded to the kernel wrapper
    (block sizes, causal/window flags).
    """

    name: str
    op: str                                   # "matmul" | "attention"
    params: dict[str, torch.Tensor]
    tier: Tier = Tier.REMOTE
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return int(sum(_nbytes(a) for a in self.params.values()))


class HostFetchEngine:
    """One emulated QP: a worker thread that really moves the bytes.

    A read = (modeled fabric time, really slept) + (an asynchronous
    host-to-device copy on the engine's copy stream, waited for with a CUDA
    event); a write is the mirror image (device to pinned host). The clock
    stops only after the event has completed, so every paced op's
    ``(kind, nbytes, us)`` in :attr:`measurements` covers the whole
    transfer — the input to :meth:`FabricResource.calibrate`. The single
    worker serializes ops like a real QP. ``throttle`` scales the modeled
    time (0 disables pacing so a transfer costs only its real copy).
    """

    def __init__(
        self,
        *,
        fabric: FabricModel = INFINIBAND_100G,
        throttle: float = 1.0,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        telemetry: Telemetry | None = None,
        track: str = "wall/fabric",
        device: str | torch.device = "cuda",
    ) -> None:
        if throttle < 0.0:
            raise ValueError(f"throttle must be >= 0, got {throttle!r}")
        self.device = resolve_device(device)
        self.fabric = fabric
        self.throttle = float(throttle)
        self.chunk_bytes = int(chunk_bytes)
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.track = track
        self.measurements: list[tuple[str, int, float]] = []
        self.bytes_read = 0
        self.bytes_written = 0
        self.n_ops = 0
        self._lock = threading.Lock()
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dolma-fetch"
        )

    # -- pacing ------------------------------------------------------------
    def pace_us(self, kind: str, nbytes: int) -> float:
        """Modeled duration of one posted transfer at the current throttle."""
        if self.throttle <= 0.0 or nbytes <= 0:
            return 0.0
        return self.throttle * self.fabric.stream_us(
            kind, nbytes, self.chunk_bytes, mode="pipelined"
        )

    def prediction_model(self) -> FabricModel:
        """The model :meth:`StreamingExecutor.simulate` should price with
        when no calibrated model is supplied: the base fabric slowed to the
        throttled emulation speed (pacing dominates the real copy)."""
        if self.throttle <= 0.0:
            return self.fabric
        return self.fabric.scaled(self.throttle)

    # -- transfers ---------------------------------------------------------
    def _read(self, payloads: dict[str, torch.Tensor]):
        """Host to device on the copy stream. Returns the device tensors and
        the copy's event once the bytes have landed."""
        cs = self._copy_stream
        with torch.cuda.device(self.device), torch.cuda.stream(cs):
            out = {k: a.to(self.device, non_blocking=True)
                   for k, a in payloads.items()}
            done = torch.cuda.Event()
            done.record(cs)
        done.synchronize()
        return out, done

    def _write(self, arrays: dict[str, torch.Tensor], ready: Any,
               into: dict[str, torch.Tensor] | None = None
               ) -> dict[str, torch.Tensor]:
        """Device to pinned host on the copy stream, after ``ready`` (an
        event recorded on the producer's stream once the arrays were
        computed), into new pinned tensors or the host tensors ``into``.
        Returns the host tensors once the bytes have landed."""
        cs = self._copy_stream
        with torch.cuda.device(self.device), torch.cuda.stream(cs):
            cs.wait_event(ready)
            out = {}
            for k, a in arrays.items():
                host = (into[k] if into is not None else
                        torch.empty(a.shape, dtype=a.dtype, pin_memory=True))
                host.copy_(a, non_blocking=True)
                if not is_traced(a):
                    a.record_stream(cs)
                out[k] = host
            done = torch.cuda.Event()
            done.record(cs)
        done.synchronize()
        return out

    def _transfer(self, kind: str, name: str, payloads: dict[str, Any],
                  pace: bool, ready: Any,
                  into: dict[str, torch.Tensor] | None = None):
        tel = self.telemetry
        w0 = tel.wall_now_us() if tel.enabled else 0.0
        t0 = time.perf_counter()
        nbytes = int(sum(_nbytes(a) for a in payloads.values()))
        if pace:
            sleep_us = self.pace_us(kind, nbytes)
            if sleep_us > 0.0:
                time.sleep(sleep_us * 1e-6)
        if self._copy_stream is None:
            # on the CPU the host and the "device" are one memory: a copy
            if into is not None:
                out = {k: into[k].copy_(a) for k, a in payloads.items()}
            else:
                out = {k: a.clone() for k, a in payloads.items()}
            result = (out, None) if kind == "read" else out
        elif kind == "read":
            result = self._read(payloads)
        else:
            result = self._write(payloads, ready, into)
        us = (time.perf_counter() - t0) * 1e6
        with self._lock:
            self.n_ops += 1
            if kind == "read":
                self.bytes_read += nbytes
            else:
                self.bytes_written += nbytes
            if pace:
                self.measurements.append((kind, nbytes, us))
        if tel.enabled:
            tel.record_span(kind, track=self.track, begin_us=w0,
                            end_us=tel.wall_now_us(), cat="io",
                            obj=name, nbytes=nbytes)
            tel.count(f"exec.bytes_{'read' if kind == 'read' else 'written'}",
                      nbytes, track=self.track)
        return result

    def fetch(self, name: str, payloads: dict[str, torch.Tensor],
              *, pace: bool = True) -> Future:
        """Post an async read (host → device). The future resolves to the
        device tensors and the copy's CUDA event (``None`` on the CPU);
        :meth:`acquire` is the barrier that hands them to a consumer."""
        return self._submit("read", name, payloads, pace, None)

    def _submit(self, *args) -> Future:
        """``_transfer(*args)`` on the worker; inline for traced (fake)
        tensors, whose fake mode takes one thread at a time: a trace posts
        the same copies, in the caller's thread."""
        if not any(is_traced(t) for t in args[2].values()):
            return self._pool.submit(self._transfer, *args)
        fut: Future = Future()
        try:
            fut.set_result(self._transfer(*args))
        except BaseException as e:  # noqa: BLE001 - raised at result()
            fut.set_exception(e)
        return fut

    def acquire(self, fut: Future) -> dict[str, torch.Tensor]:
        """The deferred access barrier of a posted read, called by the
        consumer just before first use: wait for the read, make the caller's
        current stream wait on the copy's event, and record the tensors on
        that stream (so the caching allocator cannot hand their memory to a
        later fetch while a kernel there still reads them)."""
        tensors, ready = fut.result()
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tensors.values():
                if not is_traced(t):
                    t.record_stream(stream)
        return tensors

    def write(self, name: str, arrays: dict[str, torch.Tensor],
              *, pace: bool = True, into: dict[str, torch.Tensor] | None = None
              ) -> "Future[dict[str, torch.Tensor]]":
        """Post an async write-back (device → pinned host): into new pinned
        tensors, or in place into the host tensors ``into`` (DOLMA's commit
        of an updated REMOTE object)."""
        ready = None
        if self._copy_stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return self._submit("write", name, arrays, pace, ready, into)

    def measure_sweep(
        self,
        sizes_bytes: Sequence[int],
        *,
        kinds: Sequence[str] = ("read", "write"),
        repeats: int = 2,
        seed: int = 0,
    ) -> list[tuple[str, int, float]]:
        """Microbenchmark the real path; returns the new (kind, nbytes, us)
        samples (also appended to :attr:`measurements`).

        Each size first makes one unpaced, unmeasured round trip: on a card
        the first transfer of a new size pays for the caching allocators'
        device and pinned-host blocks (tens of ms on an H100 host), a
        one-off set-up cost that is not the fabric's and would swamp the
        fit."""
        rng = np.random.default_rng(seed)
        before = len(self.measurements)
        pin = self._copy_stream is not None
        for size in sizes_bytes:
            n = max(int(size) // 4, 1)
            host = host_tensor(rng.standard_normal(n).astype(np.float32),
                               pin=pin)
            dev = self.acquire(self.fetch("sweep", {"x": host},
                                          pace=False))["x"]
            self.write("sweep", {"x": dev}, pace=False).result()
            for _ in range(max(repeats, 1)):
                if "read" in kinds:
                    dev = self.acquire(self.fetch("sweep", {"x": host}))["x"]
                else:
                    dev = host.to(self.device)
                if "write" in kinds:
                    self.write("sweep", {"x": dev}).result()
        with self._lock:
            return list(self.measurements[before:])

    def drain(self) -> None:
        """Wait until every posted op has retired (the commit fence)."""
        self._pool.submit(lambda: None).result()

    def close(self) -> None:
        self._pool.shutdown(wait=True)


@dataclasses.dataclass
class ExecResult:
    """One measured chain execution."""

    output: Any                        # final activation (device tensor)
    elapsed_us: float                  # wall-clock, fetch warmup included
    stage_compute_us: dict[str, float]
    stage_wait_us: dict[str, float]    # barrier stalls per remote stage
    prefetch: bool
    fetched_bytes: int

    @property
    def compute_us(self) -> float:
        return sum(self.stage_compute_us.values())

    @property
    def stall_us(self) -> float:
        return sum(self.stage_wait_us.values())


@dataclasses.dataclass
class SimReport:
    """The simulator's prediction for the same chain + config."""

    predicted_us: float
    stage_stall_us: dict[str, float]
    stage_compute_us: dict[str, float]
    fabric_name: str
    prefetch: bool

    def error_vs(self, measured_us: float) -> float:
        """Relative prediction error against a wall-clock measurement."""
        return abs(self.predicted_us - measured_us) / max(measured_us, 1e-9)


class StreamingExecutor:
    """Wall-clock streaming execution of a tiered compute chain.

    The measured counterpart of ``DolmaRuntime``'s simulated loop: same
    structure (placement → per-stage fetch barrier → compute → optional
    commit; prefetch posted one stage ahead), but every duration is real.
    """

    def __init__(
        self,
        stages: Iterable[StreamStage],
        *,
        prefetch: bool = True,
        engine: HostFetchEngine | None = None,
        fabric: FabricModel = INFINIBAND_100G,
        throttle: float = 1.0,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        telemetry: Telemetry | None = None,
        commit_output: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.stages = list(stages)
        names = [st.name for st in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        for st in self.stages:
            if st.op not in ("matmul", "attention"):
                raise ValueError(f"stage {st.name!r}: unknown op {st.op!r}")
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.engine = engine or HostFetchEngine(
            fabric=fabric, throttle=throttle, chunk_bytes=chunk_bytes,
            telemetry=self.telemetry, device=self.device,
        )
        if self.engine.device != self.device:
            raise ValueError(
                f"engine moves bytes to {self.engine.device}, executor runs "
                f"on {self.device}")
        self.commit_output = commit_output
        self.track = "wall/exec"
        self._local_params: dict[int, dict[str, torch.Tensor]] = {}
        self._host_store: dict[int, dict[str, torch.Tensor]] = {}
        self._place()

    # -- placement ---------------------------------------------------------
    def _place(self) -> None:
        """Materialize LOCAL params on the device; REMOTE params stay in
        pinned host memory (the emulated remote data-object region)."""
        self._local_params.clear()
        self._host_store.clear()
        pin = self.device.type == "cuda"
        for i, st in enumerate(self.stages):
            if st.tier is Tier.REMOTE:
                self._host_store[i] = {
                    k: host_tensor(a, pin=pin) for k, a in st.params.items()
                }
            else:
                self._local_params[i] = {
                    k: torch.as_tensor(a, device=self.device)
                    for k, a in st.params.items()
                }

    def plan_tiers(self, local_fraction: float,
                   *, policy: PlacementPolicy | None = None) -> PlacementPlan:
        """Decide which stages stream with the same placement policy the
        simulator uses (largest-remote-first over an object catalog), then
        re-seat the params. Returns the plan."""
        catalog = ObjectCatalog(
            DataObject(
                name=st.name,
                shape=(st.nbytes,),
                dtype=np.uint8,
                kind=ObjectKind.PARAM,
                n_reads=1,
                lifetime_iters=math.inf,
            )
            for st in self.stages
        )
        policy = policy or PlacementPolicy()
        plan = policy.plan(catalog, local_fraction=local_fraction)
        for st in self.stages:
            st.tier = plan.tier_of(st.name)
        self._place()
        return plan

    # -- execution ---------------------------------------------------------
    def _compute_stage(self, st: StreamStage,
                       params: dict[str, torch.Tensor], x: torch.Tensor):
        if st.op == "matmul":
            return ops.matmul(x, params["w"], **st.kwargs)
        return ops.attention(x, params["k"], params["v"], **st.kwargs)

    def _sync(self) -> None:
        """Wait for the compute stream only (never the copy stream)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def warmup(self, x: Any) -> torch.Tensor:
        """Run the chain once unpaced: loads the kernels and warms the
        transfer path so measured runs pay neither. Returns the final
        activation (which doubles as the untiered-oracle output)."""
        x = torch.as_tensor(x, device=self.device)
        for i, st in enumerate(self.stages):
            params = self._local_params.get(i)
            if params is None:
                params = self.engine.acquire(self.engine.fetch(
                    st.name, self._host_store[i], pace=False))
            x = self._compute_stage(st, params, x)
        self._sync()
        return x

    def run(self, x: Any) -> ExecResult:
        """One measured pass over the chain. With ``prefetch`` on, remote
        stage *j*'s read is posted before stage *i*'s compute (i < j next
        remote); off, every read is a demand fetch the compute waits for."""
        tel = self.telemetry
        eng = self.engine
        x = torch.as_tensor(x, device=self.device)
        self._sync()
        remote = [i for i, st in enumerate(self.stages)
                  if st.tier is Tier.REMOTE]
        futures: dict[int, Future] = {}
        next_post = 0
        stage_wait: dict[str, float] = {}
        stage_compute: dict[str, float] = {}
        fetched = 0

        def post_next(after_i: int) -> None:
            nonlocal next_post
            while next_post < len(remote) and remote[next_post] <= after_i:
                next_post += 1
            if next_post < len(remote):
                j = remote[next_post]
                futures[j] = eng.fetch(
                    self.stages[j].name, self._host_store[j]
                )
                next_post += 1

        t_start = time.perf_counter()
        if self.prefetch and remote:
            # warmup fetch: the first remote stage cannot be hidden (§6.1)
            post_next(-1)
        for i, st in enumerate(self.stages):
            params = self._local_params.get(i)
            if st.tier is Tier.REMOTE:
                fut = futures.pop(i, None)
                if fut is None:  # demand fetch (prefetch off, or mispost)
                    fut = eng.fetch(st.name, self._host_store[i])
                w0 = tel.wall_now_us() if tel.enabled else 0.0
                t0 = time.perf_counter()
                params = eng.acquire(fut)  # the deferred access barrier
                wait_us = (time.perf_counter() - t0) * 1e6
                stage_wait[st.name] = wait_us
                fetched += st.nbytes
                if tel.enabled:
                    tel.record_span("stall:barrier", track=self.track,
                                    begin_us=w0, end_us=tel.wall_now_us(),
                                    cat="stall", obj=st.name)
                if self.prefetch:
                    # dual buffer: post the next remote read before computing
                    post_next(i)
            t0 = time.perf_counter()
            w0 = tel.wall_now_us() if tel.enabled else 0.0
            x = self._compute_stage(st, params, x)
            self._sync()
            stage_compute[st.name] = (time.perf_counter() - t0) * 1e6
            if tel.enabled:
                tel.record_span(f"compute:{st.name}", track=self.track,
                                begin_us=w0, end_us=tel.wall_now_us(),
                                cat="compute", op=st.op)
        if self.commit_output:
            with tel.wall_span("commit", track=self.track, cat="io"):
                eng.write("output", {"y": x}).result()
        elapsed_us = (time.perf_counter() - t_start) * 1e6
        if tel.enabled:
            tel.count("exec.runs")
            tel.count("exec.elapsed_us", elapsed_us)
        return ExecResult(
            output=x,
            elapsed_us=elapsed_us,
            stage_compute_us=stage_compute,
            stage_wait_us=stage_wait,
            prefetch=self.prefetch,
            fetched_bytes=fetched,
        )

    # -- the simulator, held to the same control flow ----------------------
    def simulate(
        self,
        *,
        compute_us: dict[str, float],
        fabric: FabricModel | None = None,
        prefetch: bool | None = None,
        telemetry: Telemetry | None = None,
        track_prefix: str = "sim",
        commit_bytes: int = 0,
    ) -> SimReport:
        """Charged-timeline replay of :meth:`run` on a fresh SimClock.

        ``compute_us`` holds the measured per-stage kernel times (from a
        prior :class:`ExecResult`); ``fabric`` is normally the *calibrated*
        model from :meth:`FabricResource.calibrate` — the default falls back
        to the engine's throttled base model.
        """
        prefetch = self.prefetch if prefetch is None else prefetch
        model = fabric or self.engine.prediction_model()
        tel = telemetry if telemetry is not None else NULL_TELEMETRY
        clock = SimClock()
        qp = FabricResource(clock, model, name=f"{track_prefix}-qp",
                            telemetry=tel, track=f"{track_prefix}/fabric")
        tl = f"{track_prefix}/exec"
        remote = [i for i, st in enumerate(self.stages)
                  if st.tier is Tier.REMOTE]
        pending: dict[int, float] = {}
        next_post = 0
        stage_stall: dict[str, float] = {}
        stage_comp: dict[str, float] = {}

        def post_next(after_i: int) -> None:
            nonlocal next_post
            while next_post < len(remote) and remote[next_post] <= after_i:
                next_post += 1
            if next_post < len(remote):
                j = remote[next_post]
                _, end = qp.issue_stream(
                    "read", self.stages[j].nbytes, self.engine.chunk_bytes,
                    clock.now(tl), pipelined=True,
                )
                pending[j] = end
                next_post += 1

        if prefetch and remote:
            post_next(-1)
        for i, st in enumerate(self.stages):
            if st.tier is Tier.REMOTE:
                end = pending.pop(i, None)
                if end is None:
                    _, end = qp.issue_stream(
                        "read", st.nbytes, self.engine.chunk_bytes,
                        clock.now(tl), pipelined=True,
                    )
                t0 = clock.now(tl)
                t = clock.wait_until(tl, end)
                stage_stall[st.name] = t - t0
                if tel.enabled and t > t0:
                    tel.record_span("stall:barrier", track=tl, begin_us=t0,
                                    end_us=t, cat="stall", obj=st.name)
                if prefetch:
                    post_next(i)
            us = compute_us[st.name]
            t0 = clock.now(tl)
            t = clock.advance(tl, us)
            stage_comp[st.name] = us
            if tel.enabled and us > 0.0:
                tel.record_span(f"compute:{st.name}", track=tl, begin_us=t0,
                                end_us=t, cat="compute", op=st.op)
        if self.commit_output and commit_bytes > 0:
            _, end = qp.issue_stream("write", commit_bytes,
                                     self.engine.chunk_bytes,
                                     clock.now(tl), pipelined=True)
            clock.wait_until(tl, end)
        return SimReport(
            predicted_us=clock.now(tl),
            stage_stall_us=stage_stall,
            stage_compute_us=stage_comp,
            fabric_name=model.name,
            prefetch=prefetch,
        )


# -- chain builders (shared by tests, examples and chip_smoke.py) ----------
def matmul_chain(
    n_layers: int,
    *,
    m: int = 256,
    k: int = 512,
    n: int | None = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
    device: str | torch.device = "cuda",
) -> tuple[list[StreamStage], torch.Tensor]:
    """A chain of square-ish streamed matmuls: x @ W0 @ W1 ... (K = N so the
    activation shape is stable across layers). The same seed draws the same
    values as ``repro.core.exec.matmul_chain``; for a CUDA ``device`` the
    host tensors are pinned, ready to stream."""
    pin = resolve_device(device).type == "cuda"
    n = k if n is None else n
    if n != k:
        raise ValueError(f"matmul_chain needs N == K to chain, got K={k} N={n}")
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(k)
    stages = [
        StreamStage(
            name=f"w{i}",
            op="matmul",
            params={"w": _draw(rng.standard_normal((k, n)) * scale, dtype,
                               pin)},
            kwargs={"block_m": block_m, "block_n": block_n, "block_k": block_k},
        )
        for i in range(n_layers)
    ]
    x0 = _draw(rng.standard_normal((m, k)), dtype, pin)
    return stages, x0


def attention_chain(
    n_layers: int,
    *,
    batch: int = 1,
    heads: int = 4,
    kv_heads: int | None = None,
    seq: int = 256,
    head_dim: int = 32,
    causal: bool = True,
    window: int | None = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    block_q: int = 128,
    block_k: int = 128,
    device: str | torch.device = "cuda",
) -> tuple[list[StreamStage], torch.Tensor]:
    """A chain of attention stages whose K/V tensors are the streamed
    objects (the serving KV path); the query is the flowing activation."""
    pin = resolve_device(device).type == "cuda"
    kv = heads if kv_heads is None else kv_heads
    rng = np.random.default_rng(seed)
    stages = [
        StreamStage(
            name=f"kv{i}",
            op="attention",
            params={
                "k": _draw(rng.standard_normal((batch, seq, kv, head_dim)),
                           dtype, pin),
                "v": _draw(rng.standard_normal((batch, seq, kv, head_dim)),
                           dtype, pin),
            },
            kwargs={"causal": causal, "window": window,
                    "block_q": block_q, "block_k": block_k},
        )
        for i in range(n_layers)
    ]
    q0 = _draw(rng.standard_normal((batch, seq, heads, head_dim)), dtype, pin)
    return stages, q0


def untiered_oracle(stages: Sequence[StreamStage], x: Any,
                    *, device: str | torch.device = "cuda") -> torch.Tensor:
    """All-local reference run: identical kernels, no streaming — the
    bit-identity ground truth for every measured configuration."""
    oracle = StreamingExecutor(
        [dataclasses.replace(st, tier=Tier.LOCAL) for st in stages],
        prefetch=False, throttle=0.0, device=device,
    )
    try:
        return oracle.warmup(x)
    finally:
        oracle.engine.close()


def balanced_throttle(
    stages: Sequence[StreamStage],
    compute_us: dict[str, float],
    *,
    fabric: FabricModel = INFINIBAND_100G,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ratio: float = 1.0,
) -> float:
    """Throttle that makes the mean modeled fetch of the remote stages take
    ``ratio`` x their mean measured compute — the balanced operating point
    where overlap matters most (ideal prefetch speedup → 1 + ratio)."""
    remote = [st for st in stages if st.tier is Tier.REMOTE]
    if not remote:
        raise ValueError("balanced_throttle: no REMOTE stages to pace")
    fetch = [
        fabric.stream_us("read", st.nbytes, chunk_bytes, mode="pipelined")
        for st in remote
    ]
    comp = [compute_us[st.name] for st in remote]
    mean_fetch = sum(fetch) / len(fetch)
    mean_comp = sum(comp) / len(comp)
    if mean_fetch <= 0.0:
        raise ValueError("balanced_throttle: modeled fetch time is zero")
    return ratio * mean_comp / mean_fetch
