"""Per-device analysis of a torch trace: FLOPs, bytes, collectives, memory.

The counterpart of ``repro.launch.hlo_analysis``, which parses the HLO text
of a compiled module. There is no HLO here: :func:`analyze` runs a function
on fake tensors (:class:`Tracer`, a ``FakeTensorMode``: shapes, types and
devices, no storage) and counts every ATen op as it is dispatched.

* **Per device.** Under a device mesh every op on DTensors reaches the
  tracer as the local op DTensor dispatches on one rank's shards (rank 0
  of the fake process group), with the collectives its redistributions
  post (``_c10d_functional.*``) at their local shapes. So each count is
  one rank's, not the global one: a matmul split over the mesh counts its
  share, a replicated one its whole, a contraction left ``Partial`` the
  local product. Ops inside ``local_call`` run on local tensors already.
  The global shapes DTensor's sharding propagation runs through the fake
  mode to infer an output are not counted (:func:`_propagation_paused`).
* **FLOPs** are the formulas of ``torch.utils.flop_counter`` (matmuls,
  convolutions, attention) and those the port's kernels register
  (:mod:`repro_torch.kernels.traced`, from
  :mod:`repro_torch.kernels.work`). Elementwise ops count none, where the
  reference counts one a result element.
* **Bytes** follow the reference's bookkeeping: ``bytes`` is every op's
  operands plus result, ``bytes_min`` only matmuls, copies, slicing and
  gathering ops, cat, reductions and collectives, and views move none.
  Eager torch runs each elementwise op as its own kernel, so the bytes are
  the sum over ops, where the reference's count stops at XLA's fusions.
* **Loops.** Eager torch runs every iteration of a Python layer loop and
  every recompute of a checkpoint, so the counts need no trip-count
  correction (the reference's ``known_trip_count``).
* **Memory.** Every storage an op creates is tracked from its creation to
  its release (``weakref.finalize`` on the storage): the peak of the live
  bytes on the trace's device, the arguments' bytes (a DTensor's local
  shard), the outputs', and the host bytes (storages on the CPU when the
  trace's device is a card: the REMOTE leaves of a host-offload plan).

``global_flops`` is ``FlopCounterMode``'s count of the same run (the same
formulas, counted by :class:`_GlobalFlops` without FlopCounterMode's
module tracking, which costs a production cell's trace several seconds),
the counterpart of the reference's ``cost_analysis()``: DTensor ops at
their global shapes, ops inside ``local_call`` at one rank's.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_WIRE_NAMES = {  # the reference's op names
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")

# ops that move no bytes themselves: allocation, aliasing, bookkeeping
_ZERO_BYTE_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "record_stream", "wait_tensor",
    "set_", "resize_", "_local_scalar_dense",
}
# the ops whose traffic bytes_min keeps (the reference's dot, copy, slicing,
# cat, pad, sort, reduce and collectives)
_MIN_BYTE_OPS = {
    "mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
    "b1_matmul", "b2_flash", "b3_scan",
    "copy_", "_to_copy", "clone", "contiguous",
    "index", "index_select", "gather", "scatter", "scatter_add",
    "index_put", "index_put_", "index_add", "index_add_", "slice_scatter",
    "embedding", "embedding_dense_backward", "cat", "constant_pad_nd",
    "sort", "sum", "mean", "amax", "amin", "max", "min", "prod",
    "logsumexp", "cumsum",
}


@dataclasses.dataclass
class Collective:
    op: str
    result_bytes: int
    group_size: int
    computation: str
    multiplier: float = 1.0
    label: str = ""  # the ATen op that posted it

    @property
    def wire_bytes(self) -> float:
        """Ring-algorithm bytes on the wire per device."""
        g = max(self.group_size, 1)
        if self.op.startswith("all-reduce"):
            return 2 * (g - 1) / g * self.result_bytes
        if self.op.startswith("reduce-scatter"):
            # result is the scattered shard; input = g * result
            return (g - 1) * self.result_bytes
        if self.op.startswith("all-gather"):
            return (g - 1) / g * self.result_bytes
        if self.op.startswith("all-to-all"):
            return (g - 1) / g * self.result_bytes
        return self.result_bytes  # collective-permute, broadcast


@dataclasses.dataclass
class ModuleAnalysis:
    flops: float
    bytes: float
    bytes_min: float
    collective_bytes: float        # sum of result sizes (per device)
    collective_wire_bytes: float   # ring wire estimate (per device)
    by_collective: dict
    collectives: list
    # per ATen op: {"count", "flops", "bytes"} (the reference keys this by
    # HLO computation)
    per_computation: dict
    memory: dict = dataclasses.field(default_factory=dict)
    global_flops: float = 0.0

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "bytes_min": self.bytes_min,
            "collective_bytes": self.collective_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "by_collective": dict(self.by_collective),
        }

    def launches(self, op: str) -> int:
        """How often the trace dispatched ``op`` (``"repro_torch.b2_flash"``:
        the kernel launches the run on the card makes)."""
        return self.per_computation.get(op, {}).get("count", 0)


def _tensors(tree: Any):
    """The tensors of nested dicts, lists, tuples and dataclasses (an int8
    moment), a DTensor as its local shard."""
    if isinstance(tree, torch.Tensor):
        yield getattr(tree, "_local_tensor", tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Memory:
    """Live bytes by device type, from each tracked storage's creation to
    its release."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live: collections.Counter = collections.Counter()
        self.peak: collections.Counter = collections.Counter()
        self.keys: set[int] = set()

    def track(self, t: torch.Tensor) -> int | None:
        """Count ``t``'s storage from now on (once); its key."""
        st = t.untyped_storage()
        key = st._cdata
        dev = t.device.type
        with self.lock:
            if key in self.keys:
                return key
            n = st.nbytes()
            self.keys.add(key)
            self.live[dev] += n
            self.peak[dev] = max(self.peak[dev], self.live[dev])
        weakref.finalize(st, self._free, key, dev, n)
        return key

    def _free(self, key: int, dev: str, n: int) -> None:
        with self.lock:
            self.keys.discard(key)
            self.live[dev] -= n


class _Record:
    """What one :func:`analyze` run counted."""

    def __init__(self):
        self.lock = threading.Lock()
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.ops: dict = collections.defaultdict(
            lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})
        self.collectives: list[Collective] = []
        self.memory = _Memory()


def _group_size(args) -> int:
    """The size of the process group a collective names (its last string
    argument), 1 where none resolves."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in reversed(args):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                return 1
        if isinstance(a, torch.ScriptObject):  # c10d's boxed arguments
            try:
                a = torch._C._distributed_c10d.ProcessGroup.unbox(a)
            except RuntimeError:  # a ReduceOp
                continue
        if isinstance(a, torch._C._distributed_c10d.ProcessGroup):
            return a.size()
    return 1


class Tracer(FakeTensorMode):
    """A fake-tensor mode that counts each op it dispatches while
    :func:`analyze` runs (and nothing otherwise). Make a trace's inputs
    under it (``with Tracer() as t: ...``), then call :func:`analyze`."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=False)
        self._rec: _Record | None = None
        self._paused = threading.local()

    def paused(self) -> bool:
        return getattr(self._paused, "depth", 0) > 0

    def dispatch(self, func, types, args=(), kwargs=None):
        """The op as the fake mode runs it, counted when it is the
        outermost: the ops a fake impl decomposes it into run inside one
        kernel on the card (``sum`` into ``sum.dim_IntList``)."""
        kwargs = kwargs or {}
        local = self._paused
        local.nested = getattr(local, "nested", 0) + 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            local.nested -= 1
        rec = self._rec
        if (rec is not None and out is not NotImplemented
                and local.nested == 0 and not self.paused()):
            self._count(rec, func, args, kwargs, out)
        return out

    @staticmethod
    def _count(rec: _Record, func, args, kwargs, out) -> None:
        info = _OP_INFO.get(func)
        if info is None:
            info = _OP_INFO[func] = _op_info(func)
        key, views, zero, keep, wire, formula = info
        if key is None:
            return
        outs = list(_tensors(out))
        if not views:
            for t in outs:
                rec.memory.track(t)
        flops = 0.0
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        nbytes = 0
        if not zero:
            nbytes = (sum(map(_nbytes, _tensors((args, kwargs))))
                      + sum(map(_nbytes, outs)))
        with rec.lock:
            rec.flops += flops
            rec.bytes += nbytes
            if keep:
                rec.bytes_min += nbytes
            st = rec.ops[key]
            st["count"] += 1
            st["flops"] += flops
            st["bytes"] += nbytes
            if wire:
                rec.collectives.append(Collective(
                    op=wire, result_bytes=sum(map(_nbytes, outs)),
                    group_size=_group_size(args), computation="main",
                    label=key))


#: :func:`_op_info` of each op dispatched so far.
_OP_INFO: dict = {}


def _op_info(func) -> tuple:
    """How :meth:`Tracer._count` counts ``func``: (its name, None for an
    op that is not counted; whether it is a view (its output shares an
    input's storage); whether it moves no bytes; whether bytes_min keeps
    it; its collective's name or None; its FLOP formula or None)."""
    ns, name = func.namespace, func._opname
    if ns == "prim":
        return None, True, True, False, None, None
    wire = _WIRE_NAMES.get(name) if ns in _COLLECTIVE_NAMESPACES else None
    return (f"{ns}.{name}", func.is_view,
            func.is_view or name in _ZERO_BYTE_OPS,
            name in _MIN_BYTE_OPS or wire is not None, wire,
            flop_registry.get(func.overloadpacket))


@contextlib.contextmanager
def _propagation_paused(tracer: Tracer):
    """Leave uncounted the fake ops DTensor's sharding propagation runs at
    global shapes to infer an op's output (not the rank's work)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    saved = {}
    for attr in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        fn = getattr(ShardingPropagator, attr, None)
        if fn is None:
            continue

        def paused(self, *a, _fn=fn, **k):
            tracer._paused.depth = getattr(tracer._paused, "depth", 0) + 1
            try:
                return _fn(self, *a, **k)
            finally:
                tracer._paused.depth -= 1

        saved[attr] = fn
        setattr(ShardingPropagator, attr, paused)
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(ShardingPropagator, attr, fn)


def _tracer_of(tree: Any) -> Tracer | None:
    for t in _tensors(tree):
        if isinstance(t, FakeTensor):
            if not isinstance(t.fake_mode, Tracer):
                raise TypeError("analyze: the inputs are fake tensors of "
                                "another fake mode; make them under a Tracer")
            return t.fake_mode
    return None


def analyze(fn: Callable, *args, device: str | None = None,
            **kwargs) -> ModuleAnalysis:
    """Run ``fn(*args, **kwargs)`` on fake tensors and count it, per device
    (see the module's docstring). Fake inputs must come from one
    :class:`Tracer`; real ones are made fake first. ``device`` is the
    type whose bytes are the device's (default: that of the first input
    tensor); storages on the CPU are host bytes when it is a card."""
    tracer = _tracer_of((args, kwargs))
    if tracer is None:
        tracer = Tracer()
        args, kwargs = torch.utils._pytree.tree_map_only(
            torch.Tensor, tracer.from_tensor, (args, kwargs))
    rec = _Record()
    dev, arg_keys, arg_bytes = _arguments(rec.memory, (args, kwargs), device)
    counter = _GlobalFlops()
    tracer._rec = rec
    try:
        with tracer, _propagation_paused(tracer), counter:
            out = fn(*args, **kwargs)
    finally:
        tracer._rec = None
    by_op: dict[str, float] = collections.defaultdict(float)
    for c in rec.collectives:
        by_op[c.op] += c.result_bytes * c.multiplier
    return ModuleAnalysis(
        flops=rec.flops,
        bytes=rec.bytes,
        bytes_min=rec.bytes_min,
        collective_bytes=sum(c.result_bytes * c.multiplier
                             for c in rec.collectives),
        collective_wire_bytes=sum(c.wire_bytes * c.multiplier
                                  for c in rec.collectives),
        by_collective=dict(by_op),
        collectives=rec.collectives,
        per_computation={k: dict(v) for k, v in rec.ops.items()},
        memory=_memory_dict(rec.memory, dev, arg_keys, arg_bytes, out),
        global_flops=float(counter.total),
    )


class _GlobalFlops(TorchDispatchMode):
    """``FlopCounterMode``'s total: above the tracer, each op as the
    traced code calls it (a DTensor op at its global shapes) through
    ``torch.utils.flop_counter``'s formulas."""

    def __init__(self):
        super().__init__()
        self.total = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


class _MemoryMode(TorchDispatchMode):
    """:func:`analyze`'s memory tracker over real tensors."""

    def __init__(self, memory: _Memory):
        super().__init__()
        self.memory = memory

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self.memory.track(t)
        return out


def measure_memory(fn: Callable, *args, device: str | None = None,
                   **kwargs) -> dict:
    """:func:`analyze`'s memory dict of ``fn(*args, **kwargs)`` run on real
    tensors: the same tracker, without the trace."""
    mem = _Memory()
    dev, arg_keys, arg_bytes = _arguments(mem, (args, kwargs), device)
    with _MemoryMode(mem):
        out = fn(*args, **kwargs)
    return _memory_dict(mem, dev, arg_keys, arg_bytes, out)


def _arguments(mem: _Memory, tree: Any, device: str | None):
    """Track the inputs' storages: (the device's type, their keys, the
    bytes by device type)."""
    ins = list(_tensors(tree))
    dev = device or (ins[0].device.type if ins else "cpu")
    keys = {mem.track(t) for t in ins}
    return dev, keys, dict(mem.live)


def _memory_dict(mem: _Memory, dev: str, arg_keys: set, arg_bytes: dict,
                 out: Any) -> dict:
    """The reference's ``memory_analysis()`` keys from a tracked run."""
    out_keys, out_bytes, alias_bytes = set(), 0, 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata in out_keys or t.device.type != dev:
            continue
        out_keys.add(st._cdata)
        out_bytes += st.nbytes()
        if st._cdata in arg_keys:  # updated in place
            alias_bytes += st.nbytes()
    host = "cpu" if dev != "cpu" else None
    peak = mem.peak[dev]
    argument = arg_bytes.get(dev, 0)
    return {
        "argument_bytes": argument,
        "output_bytes": out_bytes,
        # what the peak holds besides the arguments and the new outputs,
        # so that the reference's sum below is the peak
        "temp_bytes": peak - argument - out_bytes + alias_bytes,
        "alias_bytes": alias_bytes,
        "host_argument_bytes": arg_bytes.get(host, 0) if host else 0,
        "host_temp_bytes": (mem.peak[host] - arg_bytes.get(host, 0)
                            if host else 0),
        "peak_bytes_est": peak,
    }
