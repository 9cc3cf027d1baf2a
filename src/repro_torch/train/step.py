"""Train step factory: loss -> grads -> (optional compression) -> AdamW.

A port of ``repro.train.step``. It puts the DOLMA pieces together at the
step level:

  * a placement plan over the parameters *and* the optimizer moments
    (``plan=``, from :func:`repro_torch.core.tiering.place_state`): REMOTE
    leaves live in pinned host memory;
  * the dual-buffer weight stream inside the model's layer loop (prefetch),
    composed with checkpointing (``remat``);
  * microbatch gradient accumulation (bounds activation memory);
  * optional int8 error-feedback gradient compression.

Under a device mesh (:mod:`repro_torch.models.sharding`) the parameters,
moments and batch are DTensors, laid out by
:func:`~repro_torch.models.sharding.distribute_tree` as the reference's
dry-run lays them out with its spec trees. Each gradient comes back with
its parameter's placements (a share summed over the ranks that computed
it), the global norm sums each shard once (:func:`~repro_torch.optim.adamw.
global_norm`), and AdamW runs on each rank's local shards: parameter,
gradient and moments are split alike. An int8 moment's codes are split as
its parameter; its scales (one per block of 256 along the last dim) keep
the leading splits and are whole along the last dim
(:func:`~repro_torch.models.sharding.opt_pspec_tree`): each rank updates
its codes with its own slice of the scales, and the updated slices are
gathered (:func:`_int8_update`). Gradient compression's error-feedback
buffer is replicated, as the reference's: each gradient is gathered whole,
passed through the error feedback as without a mesh, and laid out again as
it was.

``jax.value_and_grad`` becomes ``torch.autograd.grad`` over the parameters
kept on the device, and the gradients of REMOTE parameters gather on the
device through :class:`~repro_torch.core.tiering.RemoteGrads`. The update
then runs leaf by leaf on the device: a REMOTE parameter and its REMOTE
moments are fetched through the step's
:class:`~repro_torch.core.exec.HostFetchEngine`, updated by the same
:func:`~repro_torch.optim.adamw.leaf_update` as a local leaf, and written
back in place on the engine's copy stream (DOLMA's commit). Every placement
and both prefetch settings give ``torch.equal`` losses, gradients and
updates.

The step runs with ``torch.use_deterministic_algorithms(True,
warn_only=True)``: the embedding's backward (an index with accumulate)
adds with atomics on a card otherwise, and run-to-run equality is the
contract. cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` (``":4096:8"``) set
before its first call for the same: the launcher and ``chip_smoke.py`` set
it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import HostFetchEngine, resolve_device
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.tiering import (
    RemoteGrads,
    TieringConfig,
    host_names,
    like_global,
    local_part,
    remote_keys,
)
from repro_torch.models import get_model
from repro_torch.models.sharding import is_dtensor, local_shape_and_offset
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves, unflatten
from repro_torch.optim.compression import (
    CompressionConfig,
    error_feedback_leaf,
    init_error_feedback,
)
from repro_torch.optim.quantized import BLOCK, QTensor, quantize_blocks


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "full"
    microbatches: int = 1
    prefetch: bool = True          # dual-buffer layer-weight prefetch
    # keep the dual buffer on under remat (the fetches inside the block
    # boundary: recomputed, not saved), as TieringConfig's knob
    prefetch_under_remat: bool = True
    moe_groups: int | None = None
    compression: CompressionConfig = CompressionConfig()
    # where params and moments live (None: all on the device); its prefetch
    # knobs must be the step's own, as :meth:`from_tiering` makes them
    tiering: TieringConfig | None = None

    def __post_init__(self):
        t = self.tiering
        if t is not None and (t.prefetch, t.prefetch_under_remat) != (
                self.prefetch, self.prefetch_under_remat):
            raise ValueError(
                f"TrainStepConfig: tiering's prefetch={t.prefetch}, "
                f"prefetch_under_remat={t.prefetch_under_remat} disagree with "
                f"the step's {self.prefetch}, {self.prefetch_under_remat}; "
                f"build the config with TrainStepConfig.from_tiering")

    @classmethod
    def from_tiering(cls, tiering: TieringConfig,
                     **overrides) -> "TrainStepConfig":
        """Step config whose scan knobs and placement follow ``tiering``
        (a prefetch knob in ``overrides`` is set in both)."""
        knobs = {k: overrides.pop(k, getattr(tiering, k))
                 for k in ("prefetch", "prefetch_under_remat")}
        return cls(**knobs, tiering=dataclasses.replace(tiering, **knobs),
                   **overrides)


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for the block (warnings where an op has none),
    uninitialized memory left unfilled; the previous settings restored."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


class _Store:
    """A placed tree's leaves on the device for the update: a REMOTE leaf
    is fetched through the engine and its new value written back into the
    same host tensor; a LOCAL leaf is used and replaced as it is."""

    def __init__(self, plan: PlacementPlan | None,
                 engine: HostFetchEngine | None):
        self.remote = frozenset(host_names(plan))
        self.engine = engine
        self.writes: list = []

    def get(self, name: str, leaf):
        if isinstance(leaf, QTensor):
            return QTensor(self.get(name + ".codes", leaf.codes),
                           self.get(name + ".scale", leaf.scale))
        if name not in self.remote:
            return leaf
        return self.engine.acquire(
            self.engine.fetch(name, {"x": leaf}, pace=False))["x"]

    def put(self, name: str, leaf, new):
        if isinstance(leaf, QTensor):
            return QTensor(self.put(name + ".codes", leaf.codes, new.codes),
                           self.put(name + ".scale", leaf.scale, new.scale))
        if name not in self.remote:
            return new
        self.writes.append(self.engine.write(name, {"x": new}, pace=False,
                                             into={"x": leaf}))
        return leaf

    def wait(self) -> None:
        """Every write-back has landed (and raised, had it failed)."""
        for fut in self.writes:
            fut.result()


#: Most elements of one leaf the update takes at once: a larger leaf (a
#: stacked layer weight) is updated in slices of whole rows of its last dim,
#: so AdamW's float32 temporaries stay this size (256 MB each) and not the
#: leaf's, nor one layer's (a stacked expert weight's layer can hold 470 M
#: elements). The math is elementwise, and an int8 moment's quantization
#: blocks lie within a row: the slices give the same bits.
UPDATE_SLICE = 1 << 26


def _row_slices(t: torch.Tensor) -> list[slice]:
    """Ranges of whole rows of ``t`` along dim 0 of at most
    :data:`UPDATE_SLICE` elements each (one row at least); one range for a
    leaf that small or 0-d. The update hands it a leaf of more than two
    dims as the matrix of its last dim's rows."""
    if t.ndim == 0 or t.numel() <= UPDATE_SLICE:
        return [slice(None)]
    rows = max(1, UPDATE_SLICE // (t.numel() // t.shape[0]))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _contiguous(t) -> bool:
    if isinstance(t, QTensor):
        return t.codes.is_contiguous() and t.scale.is_contiguous()
    return t.is_contiguous()


def _part(t, sl: slice):
    """Rows ``sl`` of ``t`` (an int8 moment's codes and scales alike)."""
    if isinstance(t, QTensor):
        return QTensor(t.codes[sl], t.scale[sl])
    return t[sl]


def _fresh(name: str, t, remote: frozenset):
    """What a leaf's updated slices are written into: a REMOTE leaf's own
    host tensor, or a new device tensor."""
    if isinstance(t, QTensor):
        return QTensor(_fresh(name + ".codes", t.codes, remote),
                       _fresh(name + ".scale", t.scale, remote))
    return t if name in remote else torch.empty_like(t)


def _write(store: "_Store", name: str, into, x) -> None:
    """One updated slice ``x`` into ``into`` (a slice of :func:`_fresh`'s
    tensor): written back through ``store`` when REMOTE, copied when
    LOCAL."""
    if isinstance(into, QTensor):
        _write(store, name + ".codes", into.codes, x.codes)
        _write(store, name + ".scale", into.scale, x.scale)
    elif name in store.remote:
        store.put(name, into, x)
    else:
        into.copy_(x)


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of ``batch``, microbatch i its i-th block of
    contiguous rows, as the reference's reshape makes them. A DTensor batch
    is gathered once and each microbatch laid out as the batch was: every
    rank keeps its share of that microbatch's rows (the batch's own local
    rows would interleave the global ones, which changes a loss that is
    not a plain mean over rows, the MoE's balance term)."""
    def parts(x):
        if not is_dtensor(x):
            return x.reshape(n, x.shape[0] // n, *x.shape[1:])
        whole = x.full_tensor()
        return [distribute_tensor(t, x.device_mesh, x.placements,
                                  src_data_rank=None)
                for t in whole.reshape(n, whole.shape[0] // n,
                                       *whole.shape[1:])]

    split = {k: parts(x) for k, x in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor (the loss, a metric) as a plain tensor."""
    return t.full_tensor() if is_dtensor(t) else t


def _grad_like(g: torch.Tensor | None, t: torch.Tensor,
               dev: torch.device) -> torch.Tensor:
    """A parameter's gradient with its placements (zeros if none arrived;
    a share summed over the ranks that hold it)."""
    if g is None:
        return like_global(torch.zeros(local_part(t).shape, dtype=t.dtype,
                                       device=dev), t)
    if is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _update_layout(p: DTensor) -> tuple:
    """The placements an int8 leaf is updated in: ``p``'s, unless a split
    of its last dim cuts a quantization block, which is then undone (each
    mesh dim splitting that dim made ``Replicate()``)."""
    d = p.ndim - 1
    split = math.prod(n for pl, n in zip(p.placements, p.device_mesh.shape)
                      if pl == Shard(d))
    if (p.shape[d] // split) % BLOCK == 0:
        return tuple(p.placements)
    return tuple(Replicate() if pl == Shard(d) else pl for pl in p.placements)


def _int8_update(opt_cfg, names, olds, g, s, store: "_Store") -> list:
    """One leaf's AdamW step under a mesh when its moments are int8
    (:class:`QTensor` of DTensors): the codes split as the parameter, each
    scale whole along the last dim.

    Each rank updates its local codes with the slice of the scales that
    covers them (its last-dim range over whole blocks, in the layout of
    :func:`_update_layout`), then the updated slices are gathered along
    the last dim, since every rank holds the scales whole there. Blocks
    and values are the unsharded step's; the math is elementwise but for
    each block's max, which a rank computes over a whole block."""
    p, m, v = olds
    mesh, d = p.device_mesh, p.ndim - 1
    lay = _update_layout(p)

    def laid(name: str, t: DTensor) -> DTensor:
        """``t`` fetched to the device (through ``store``) in ``lay``."""
        t = like_global(store.get(name, local_part(t)), t)
        return t if tuple(t.placements) == lay else t.redistribute(mesh, lay)

    shape, offset = local_shape_and_offset(p.shape, mesh, lay)
    b0, nb = offset[d] // BLOCK, shape[d] // BLOCK
    cur = [local_part(laid(names[0], p))]
    for name, q in zip(names[1:], (m, v)):
        scale = store.get(name + ".scale", local_part(q.scale))
        cur.append(QTensor(local_part(laid(name + ".codes", q.codes)),
                           scale[..., b0:b0 + nb]))
    # float32 moments out, quantized here: the shard may be smaller than
    # the size quantize() asks of a whole leaf
    p_new, m32, v32 = adamw.leaf_update(
        dataclasses.replace(opt_cfg, moment_style="f32"), cur[0],
        local_part(g if tuple(g.placements) == lay
                   else g.redistribute(mesh, lay)), cur[1], cur[2], s)
    new = [p_new, quantize_blocks(m32), quantize_blocks(v32)]

    def back(x: torch.Tensor, like: DTensor, name: str, old: torch.Tensor):
        """``x`` (a local shard in ``lay``) laid out as ``like`` and put
        through ``store`` over ``old``."""
        t = like_global(x, like, lay)
        if tuple(t.placements) != tuple(like.placements):
            t = t.redistribute(mesh, like.placements)
        return like_global(store.put(name, old, local_part(t)), like)

    out = [back(new[0], p, names[0], local_part(p))]
    for name, q, nq in zip(names[1:], (m, v), new[1:]):
        codes = back(nq.codes, q.codes, name + ".codes",
                     local_part(q.codes))
        # this rank's slice of the scales, split along the last dim where
        # lay splits it, gathered whole there as q.scale is laid out
        sl = tuple(pl if pl == Shard(d) else sp for pl, sp in
                   zip(lay, q.scale.placements))
        whole = DTensor.from_local(nq.scale, mesh, sl, run_check=False,
                                   shape=q.scale.shape,
                                   stride=q.scale.stride()).redistribute(
            mesh, q.scale.placements)
        scale = like_global(store.put(name + ".scale", local_part(q.scale),
                                      local_part(whole)), q.scale)
        out.append(QTensor(codes, scale))
    return out


def _error_feedback(g: torch.Tensor, r: torch.Tensor, block: int, store,
                    name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The error feedback of one gradient against its residual ``r``
    (fetched and written back through ``store``): on a DTensor gradient,
    over the gradient gathered whole, as the replicated buffer holds it,
    the compressed gradient then laid out as ``g`` was."""
    if not is_dtensor(g):
        q, e = error_feedback_leaf(g, store.get(name, r), block)
        return q, store.put(name, r, e)
    mesh = g.device_mesh
    whole = g.redistribute(mesh, [Replicate()] * mesh.ndim)
    q, e = error_feedback_leaf(local_part(whole), store.get(
        name, local_part(r)), block)
    q = like_global(q, whole).redistribute(mesh, g.placements)
    return q, like_global(store.put(name, local_part(r), e), r)


def make_value_and_grad(model_cfg: ModelConfig, step_cfg: TrainStepConfig,
                        *, plan: PlacementPlan | None = None):
    """Returns ``value_and_grad(params, batch, engine=None) -> (loss,
    metrics, grads)``, the train step's first half: ``grads`` maps each
    parameter's keystr to its gradient on the batch's device (float32 and
    averaged over the microbatches when there are several, as the
    reference's scan makes them). REMOTE parameters (under ``plan``) are
    fetched through ``engine``, one of its own if none is given."""
    model = get_model(model_cfg)
    n_mb = step_cfg.microbatches
    remote = remote_keys(plan, "params")

    def one(p_req, local, all_leaves, mb, engine, rg):
        if rg is not None:
            rg.reset()
        loss, metrics = model.loss_fn(
            p_req, mb, model_cfg, remat=step_cfg.remat,
            prefetch=step_cfg.prefetch,
            prefetch_under_remat=step_cfg.prefetch_under_remat,
            moe_groups=step_cfg.moe_groups, plan=plan, engine=engine,
            remote_grads=rg)
        inputs = list(local.values()) + ([rg.anchor] if rg else [])
        got = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = {}
        for (k, t), g in zip(local.items(), got):
            grads[k] = torch.zeros_like(t) if g is None else _grad_like(
                g, t, loss.device)
        for k in remote:
            t = all_leaves[k]
            g = rg.grads.get("params" + k)
            grads[k] = _grad_like(None if g is None else like_global(g, t),
                                  t, loss.device)
        return (_plain(loss.detach()),
                {k: _plain(v.detach()) for k, v in metrics.items()}, grads)

    def value_and_grad(params, batch, engine: HostFetchEngine | None = None):
        dev = batch["tokens"].device
        own = engine is None and bool(remote)
        if own:
            engine = HostFetchEngine(throttle=0.0, device=dev)
        try:
            with deterministic():
                return _value_and_grad(params, batch, engine, dev)
        finally:
            if own:
                engine.close()

    def _value_and_grad(params, batch, engine, dev):
        all_leaves = dict(leaves(params))
        local = {k: t.detach().requires_grad_(True)
                 for k, t in all_leaves.items() if k not in remote}
        p_req = unflatten(params, {**all_leaves, **local})
        rg = RemoteGrads(dev) if remote else None
        if n_mb == 1:
            return one(p_req, local, all_leaves, batch, engine, rg)
        # the reference's scan: float32 zeros, then the losses, metrics
        # and grads summed over the microbatches in order, scaled by 1/n
        acc_loss = acc_metrics = None
        acc = {k: like_global(torch.zeros(local_part(t).shape,
                                          dtype=torch.float32, device=dev), t)
               for k, t in all_leaves.items()}
        for mb in _split(batch, n_mb):
            loss, metrics, grads = one(p_req, local, all_leaves, mb,
                                       engine, rg)
            if acc_loss is None:
                acc_loss = torch.zeros((), dtype=torch.float32, device=dev)
                acc_metrics = {k: torch.zeros_like(v)
                               for k, v in metrics.items()}
            acc_loss = acc_loss + loss
            acc_metrics = {k: acc_metrics[k] + v
                           for k, v in metrics.items()}
            acc = {k: acc[k] + grads[k] for k in acc}
        inv = 1.0 / n_mb
        return (acc_loss * inv,
                {k: v * inv for k, v in acc_metrics.items()},
                {k: g * inv for k, g in acc.items()})

    return value_and_grad


def make_train_step(model_cfg: ModelConfig, step_cfg: TrainStepConfig,
                    opt_cfg: adamw.AdamWConfig, *,
                    plan: PlacementPlan | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the device of ``batch["tokens"]``.

    ``plan`` is the placement of ``params`` and ``opt_state``
    (:func:`~repro_torch.core.tiering.place_state`); without one every leaf
    is where it lies. REMOTE leaves are updated in place (the reference
    donates its buffers); LOCAL leaves come back as new tensors. Metrics:
    the loss function's, ``grad_norm``, ``lr`` and ``loss``.
    """
    value_and_grad = make_value_and_grad(model_cfg, step_cfg, plan=plan)

    # a slice's moments come back float32 and are encoded as the leaf's
    # were: an int8 moment by quantize_blocks, since a slice can be smaller
    # than the size quantize() asks of a whole leaf
    cfg32 = (dataclasses.replace(opt_cfg, moment_style="f32")
             if opt_cfg.moment_style == "int8" else opt_cfg)

    def update_leaf(names, olds, g, s, store: _Store) -> list:
        """One leaf's (p, m, v) -> the new ones through ``store``, in
        :func:`_row_slices`: a REMOTE leaf is fetched and written back
        slice by slice, a LOCAL one assembled into new tensors. An int8
        moment's codes and scales are cut by the same rows: a quantization
        block is 256 elements of one row of the last dim, so a slice of
        whole rows holds whole blocks and gives the whole leaf's bits."""
        if is_dtensor(olds[0]):
            if any(isinstance(t, QTensor) for t in olds):
                return _int8_update(opt_cfg, names, olds, g, s, store)
            news = update_leaf(names, [local_part(t) for t in olds],
                               local_part(g), s, store)
            return [like_global(x, t) for x, t in zip(news, olds)]
        # a leaf of more than two dims, or any with int8 moments (a 1-d
        # one's scales share no dim with its codes), as the matrix of its
        # last dim's rows; int8 moments that are not contiguous, whole
        quantized = isinstance(olds[1], QTensor)
        flat = all(_contiguous(t) for t in olds) and (
            olds[0].ndim > 2 or quantized)

        def rows(t):
            if isinstance(t, QTensor):
                return QTensor(rows(t.codes), rows(t.scale))
            return t.reshape(-1, t.shape[-1]) if flat else t

        parts = ([slice(None)] if quantized and not flat
                 else _row_slices(rows(olds[0])))
        if len(parts) == 1:
            cur = [store.get(n, t) for n, t in zip(names, olds)]
            new = adamw.leaf_update(opt_cfg, cur[0], g, cur[1], cur[2], s)
            return [store.put(n, t, x) for n, t, x in zip(names, olds, new)]
        outs = [_fresh(n, t, store.remote) for n, t in zip(names, olds)]
        g = rows(g)
        for sl in parts:
            cur = [store.get(n, _part(rows(t), sl))
                   for n, t in zip(names, olds)]
            p_new, m32, v32 = adamw.leaf_update(cfg32, cur[0], g[sl], cur[1],
                                                cur[2], s)
            new = [p_new] + ([quantize_blocks(m32), quantize_blocks(v32)]
                             if quantized else [m32, v32])
            for n, o, x in zip(names, outs, new):
                _write(store, n, _part(rows(o), sl), x)
        return outs

    def update(params, opt_state, grads, store: _Store):
        """AdamW (after the error feedback, when on) leaf by leaf on the
        device: :func:`adamw.update`'s math through ``store``. Each leaf's
        gradient is dropped once the leaf is updated."""
        new_opt = {}
        if step_cfg.compression.enabled:
            ef = {}
            for k, r in leaves(opt_state["ef"]):
                grads[k], ef[k] = _error_feedback(
                    grads[k], r, step_cfg.compression.block, store,
                    "opt['ef']" + k)
            new_opt["ef"] = unflatten(params, ef)
        step = store.get("opt['step']", local_part(opt_state["step"])) + 1
        gnorm = adamw.global_norm(unflatten(params, grads))
        s = adamw.step_scalars(opt_cfg, step, gnorm)
        m_of, v_of = dict(leaves(opt_state["m"])), dict(leaves(opt_state["v"]))
        new_p, new_m, new_v = {}, {}, {}
        for k, p in leaves(params):
            names = ("params" + k, "opt['m']" + k, "opt['v']" + k)
            new_p[k], new_m[k], new_v[k] = update_leaf(
                names, (p, m_of[k], v_of[k]), grads.pop(k), s, store)
        step = store.put("opt['step']", local_part(opt_state["step"]), step)
        new_opt.update(m=unflatten(params, new_m), v=unflatten(params, new_v),
                       step=like_global(step, opt_state["step"]))
        return (unflatten(params, new_p), new_opt,
                {"grad_norm": gnorm, "lr": s["lr"]})

    def train_step(params, opt_state, batch):
        dev = batch["tokens"].device
        engine = (HostFetchEngine(throttle=0.0, device=dev)
                  if host_names(plan) else None)
        store = _Store(plan, engine)
        try:
            with deterministic():
                loss, metrics, grads = value_and_grad(params, batch, engine)
                params, opt_state, opt_metrics = update(
                    params, opt_state, grads, store)
            store.wait()
        finally:
            if engine is not None:
                engine.close()
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def init_train_state(gen: torch.Generator, model_cfg: ModelConfig,
                     step_cfg: TrainStepConfig, opt_cfg: adamw.AdamWConfig, *,
                     device: str | torch.device = "cuda"):
    """(params, opt_state) on ``device``: random parameters drawn from
    ``gen``, zero moments (and the error-feedback buffer when compression
    is on)."""
    model = get_model(model_cfg)
    params = model.init_params(gen, model_cfg, device=resolve_device(device))
    opt_state = adamw.init(opt_cfg, params)
    if step_cfg.compression.enabled:
        opt_state["ef"] = init_error_feedback(params)
    return params, opt_state

