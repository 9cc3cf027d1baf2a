"""What each rank of ``test_torch_mesh.py``'s gloo world runs (not a test
module; imports the port only, so that the ranks never load JAX).

Each function builds its meshes over the world's ranks (``data``,
``model``), runs the port unsharded and sharded on the same inputs, and
returns numpy copies of what the test compares, on rank 0 (None on the
others: every rank joins each collective, one answers).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.core import tiering as T
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.tiering import place_state
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.sharding import (
    LOCAL_MAP_CALLS,
    batch_pspec_tree,
    distribute_tree,
    opt_pspec_tree,
    params_pspec_tree,
    sharding_tree,
    use_mesh,
)
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as adamw_init
from repro_torch.optim.adamw import unflatten
from repro_torch.train import step as step_mod
from repro_torch.train.step import TrainStepConfig

OPT = AdamWConfig(lr=1e-3, warmup_steps=0)


def mesh_of(shape):
    return make_smoke_mesh(shape, device="cpu")


def whole(t) -> np.ndarray:
    """A DTensor gathered (every rank joins), or a tensor, as float32
    numpy."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().float().numpy()


def flat(tree) -> dict[str, np.ndarray]:
    return {k: whole(t) for k, t in _leaves_with_keys(tree)}


def split_dims(t) -> list:
    """The tensor dim each mesh dim splits (None: replicated)."""
    return [pl.dim if pl.is_shard() else None for pl in t.placements]


def answer(value):
    return value if dist.get_rank() == 0 else None


def laid_out(cfg, params, opt, batch, mesh):
    specs = params_pspec_tree(params, expert_sharding=cfg.expert_sharding,
                              mesh=mesh)
    return (distribute_tree(params, specs, mesh),
            distribute_tree(opt, opt_pspec_tree(opt, specs, mesh), mesh),
            distribute_tree(batch, batch_pspec_tree(batch, mesh), mesh),
            specs)


def _given(grads: tuple, like: dict):
    """A stand-in for ``make_value_and_grad`` whose function gives
    ``grads``, a step's (loss, metrics, whole gradients by keystr), each
    gradient laid out as its parameter in ``like``."""
    loss, metrics, whole_grads = grads
    laid = {k: distribute_tensor(g, like[k].device_mesh, like[k].placements,
                                 src_data_rank=None)
            if hasattr(like[k], "device_mesh") else g
            for k, g in whole_grads.items()}
    return lambda *a, **k: (lambda p, b, engine=None: (
        loss, dict(metrics), dict(laid)))


def _step_given(make, grads, dp, do, db):
    """``make()``'s train step on ``(dp, do, db)`` with its gradients
    replaced by ``grads`` (see :func:`_given`)."""
    real = step_mod.make_value_and_grad
    step_mod.make_value_and_grad = _given(grads, dict(_leaves_with_keys(dp)))
    try:
        return make()(dp, do, db)
    finally:
        step_mod.make_value_and_grad = real


def step_case(cfg, params, batch, shape, microbatches: int = 1):
    """The unsharded step and the sharded one on ``shape``: loss, metrics
    and gradients of each; the updated state of each, the sharded update
    given the unsharded gradients; and how often the sharded run went
    through each ``local_map`` body."""
    step_cfg = TrainStepConfig(remat="full", microbatches=microbatches)
    opt = adamw_init(OPT, params)
    loss0, metrics0, grads0 = step_mod.make_value_and_grad(cfg, step_cfg)(
        params, batch)
    p1, o1, _ = step_mod.make_train_step(cfg, step_cfg, OPT)(
        params, opt, batch)
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        dp, do, db, _ = laid_out(cfg, params, opt, batch, mesh)
        LOCAL_MAP_CALLS.clear()
        loss, metrics, grads = step_mod.make_value_and_grad(cfg, step_cfg)(
            dp, db)
        calls = dict(LOCAL_MAP_CALLS)
        p2, o2, _ = _step_given(
            lambda: step_mod.make_train_step(cfg, step_cfg, OPT),
            (loss0, metrics0, grads0), dp, do, db)
    out = {
        "loss0": float(loss0), "loss": float(loss),
        "metrics0": {k: float(v) for k, v in metrics0.items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads0": {k: whole(g) for k, g in grads0.items()},
        "grads": {k: whole(g) for k, g in grads.items()},
        "old": flat(params), "new0": flat(p1), "new": flat(p2),
        "m0": flat(o1["m"]), "m": flat(o2["m"]), "v0": flat(o1["v"]),
        "v": flat(o2["v"]), "calls": calls}
    return answer(out)


def xent_case(logit, labels, shape):
    """``cross_entropy`` of (B, S, V) logits split by rows on ``data`` and
    by vocabulary on ``model``, against the unsharded: loss, gradient, the
    width of rank 0's vocabulary slice and of its gradient, and the calls
    through the loss's ``local_map`` body."""
    from repro_torch.models.layers import cross_entropy

    lg0 = logit.clone().requires_grad_()
    loss0 = cross_entropy(lg0, labels)
    g0, = torch.autograd.grad(loss0, lg0)
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        lg = distribute_tensor(logit, mesh, [Shard(0), Shard(2)])
        lg.requires_grad_()
        y = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
        LOCAL_MAP_CALLS.clear()
        loss = cross_entropy(lg, y)
        g, = torch.autograd.grad(loss, lg)
        calls = LOCAL_MAP_CALLS["xent"]
    return answer({"loss0": float(loss0), "loss": float(loss.full_tensor()),
                   "g0": whole(g0), "g": whole(g), "calls": calls,
                   "width": lg.to_local().shape[-1],
                   "grad_width": g.to_local().shape[-1]})


def loss_case(cfg, params, batch, shape):
    """``loss_fn``'s value, metrics and gradients sharded on ``shape``
    against unsharded, and the calls through the loss's ``local_map``
    body (the main head's and, with MTP, the MTP block's)."""
    step_cfg = TrainStepConfig(remat="full")
    loss0, metrics0, grads0 = step_mod.make_value_and_grad(cfg, step_cfg)(
        params, batch)
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        dp, _, db, _ = laid_out(cfg, params, adamw_init(OPT, params), batch,
                                mesh)
        LOCAL_MAP_CALLS.clear()
        loss, metrics, grads = step_mod.make_value_and_grad(cfg, step_cfg)(
            dp, db)
        calls = LOCAL_MAP_CALLS["xent"]
    return answer({
        "loss0": float(loss0), "loss": float(loss),
        "metrics0": {k: float(v) for k, v in metrics0.items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads0": {k: whole(g) for k, g in grads0.items()},
        "grads": {k: whole(g) for k, g in grads.items()}, "calls": calls})


def memory_case(cfg, params, batch, shape):
    """The trace analysis's memory tracker over rank 0's real train step
    on ``shape`` (float32 moments, remat full), its state laid out by the
    spec trees: ``measure_memory``'s dict."""
    from repro_torch.launch.hlo_analysis import measure_memory

    opt = adamw_init(OPT, params)
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        dp, do, db, _ = laid_out(cfg, params, opt, batch, mesh)
        step = step_mod.make_train_step(cfg, TrainStepConfig(remat="full"),
                                        OPT)
        return answer(measure_memory(step, dp, do, db))


def _planted_scatters():
    """The fault planted in fsdp_stream's backward: a broadcast layer's
    gradient given to the ranks that do not own it, an all-gathered one's
    part taken one shard over."""
    real_row, real_part = T._scatter_row, T._scatter_part
    T._scatter_row = lambda grad, g, j, owns: real_row(grad, g, j, not owns)
    T._scatter_part = lambda grad, g, i, d, r, c: real_part(
        grad, g, i, d, (r + 1) % (g.shape[d] // c), c)
    return real_row, real_part


def placed_step_case(cfg, params, batch, shape, tierings: dict,
                     oracle: str | None = None, plant: bool = False):
    """One train step per placement in ``tierings`` (name ->
    TieringConfig), sharded on ``shape`` (or, for a name starting with
    "no mesh", without one): loss, gradients, updated parameters and
    moments as numpy, which parameters the placement split over its
    ``fsdp_axis`` (the plan's ``peer_split``), and the collectives
    ``tiered_scan`` posted to gather them. With ``oracle`` (the name of a leg run first), every other leg
    also takes a step given the oracle's gradients (``"given"``: its
    parameters and moments), so that the update is held apart from the
    gradients. ``plant`` runs every leg with the fault of
    :func:`_planted_scatters`."""
    out, base = {}, None
    mesh = mesh_of(shape)
    real = _planted_scatters() if plant else None
    try:
        for name, tiering in tierings.items():
            step_cfg = TrainStepConfig.from_tiering(tiering, remat="full")
            on = None if name.startswith("no mesh") else mesh
            def placed():
                """The state laid out and placed anew (a step updates
                host leaves in place)."""
                if on is None:
                    dp, do, db = params, adamw_init(OPT, params), batch
                else:
                    dp, do, db, _ = laid_out(cfg, params,
                                             adamw_init(OPT, params), batch,
                                             mesh)
                return (*place_state(dp, do, tiering, device="cpu"), db)

            with use_mesh(on):
                dp, do, plan, db = placed()
                split = sorted(n[len("params"):] for n in (
                    plan.peer_split if plan else ()) if n.startswith("params"))
                T.GATHERS.clear()
                loss, metrics, grads = step_mod.make_value_and_grad(
                    cfg, step_cfg, plan=plan)(dp, db)
                gathers = dict(T.GATHERS)

                def make():
                    return step_mod.make_train_step(cfg, step_cfg, OPT,
                                                    plan=plan)

                p, o, step_metrics = make()(dp, do, db)
                row = {}
                if oracle is not None and name != oracle:
                    gp, go, _ = _step_given(make, base, *placed()[:2], db)
                    row["given"] = {"params": flat(gp), "m": flat(go["m"]),
                                    "v": flat(go["v"])}
                if name == oracle:
                    base = (loss, metrics, {k: g.full_tensor()
                                            if hasattr(g, "full_tensor")
                                            else g for k, g in grads.items()})
            out[name] = {"loss": float(step_metrics["loss"]),
                         "params": flat(p), "m": flat(o["m"]),
                         "v": flat(o["v"]), "split": split,
                         "gathers": gathers,
                         "grads": {k: whole(g) for k, g in grads.items()},
                         "n_remote": len(plan.remote_names()) if plan else 0,
                         **row}
    finally:
        if real is not None:
            T._scatter_row, T._scatter_part = real
    out["old"] = flat(params)
    return answer(out)


def ep_case(cfg, p, x, shape, drop_dx: bool = False):
    """``_moe_ffn_ep`` on ``shape`` and the dense path: outputs, aux and
    the gradients of sum(out) by p and x. ``drop_dx`` plants the fault:
    the all-reduce of x's gradient over ``model`` left out."""
    mesh = mesh_of(shape)

    def run(fn):
        leaves = {k: t.clone().requires_grad_(True)
                  for k, t in _leaves_with_keys(p)}
        xx = x.clone().requires_grad_(True)
        out, aux = fn(unflatten(p, leaves), xx)
        grads = torch.autograd.grad(out.sum(), [*leaves.values(), xx])
        return (out.detach().numpy(), float(aux),
                {k: g.numpy() for k, g in zip([*leaves, "x"], grads)})

    dense = run(lambda pp, xx: MOE._moe_ffn_dense(pp, xx, cfg))
    real = MOE._grad_sum
    if drop_dx:
        MOE._grad_sum = lambda t, g: (t if t.shape[-1] == cfg.d_model
                                      else real(t, g))
    try:
        ep = run(lambda pp, xx: MOE._moe_ffn_ep(pp, xx, cfg, mesh))
    finally:
        MOE._grad_sum = real
    return answer({"dense": dense, "ep": ep})


def ep_paging_case(cfg, p, x, shape, kind: str, arg=None):
    """The reference's EP cases of ``tests/test_expert_paging.py`` on the
    port: ``groups`` (dense and EP at ``arg`` groups), ``bad_groups`` (the
    ValueError messages), ``zero_rows`` (the EP output with every unrouted
    expert zeroed, beside the output)."""
    mesh = mesh_of(shape)
    if kind == "groups":
        dense = MOE._moe_ffn_dense(p, x, cfg, groups=arg)
        ep = MOE._moe_ffn_ep(p, x, cfg, mesh, groups=arg)
        return answer([(t.numpy(), float(a)) for t, a in (dense, ep)])
    if kind == "bad_groups":
        msgs = []
        for g in arg:
            try:
                MOE._moe_ffn_ep(p, x, cfg, mesh, groups=g)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        return answer(msgs)
    ref, _aux, (top_i, _top_p) = MOE._moe_ffn_ep(p, x, cfg, mesh,
                                                 return_routing=True)
    mask = torch.zeros((cfg.n_experts, 1, 1))
    mask[torch.unique(top_i).long()] = 1.0
    p2 = {**p, **{k: p[k] * mask for k in ("w_gate", "w_up", "w_down")}}
    out, _ = MOE._moe_ffn_ep(p2, x, cfg, mesh)
    return answer((ref.numpy(), out.numpy()))


def checkpoint_case(cfg, params, directory: str):
    """A state laid out on (2, 2) saved, then restored onto (1, 4)'s
    placements: the whole arrays before and after, and the placements
    the restore gave."""
    from repro_torch.checkpoint.manager import CheckpointManager

    opt = adamw_init(OPT, params)
    before = {}
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape)
        specs = params_pspec_tree(params, mesh=mesh)
        ospecs = opt_pspec_tree(opt, specs, mesh)
        if shape == (2, 2):
            dp = distribute_tree(params, specs, mesh)
            do = distribute_tree(opt, ospecs, mesh)
            mgr = CheckpointManager(directory)
            mgr.save(3, dp, do, blocking=True)
            before = {"params": flat(dp), "opt": flat(do)}
            dist.barrier()
        else:
            got = CheckpointManager(directory).restore(
                params, opt, shardings=(sharding_tree(specs, mesh),
                                        sharding_tree(ospecs, mesh)))
            wq = got["params"]["layers"]["attn"]["wq"]
            after = {"params": flat(got["params"]),
                     "opt": flat(got["opt_state"]), "step": got["step"],
                     "wq": split_dims(wq),
                     "wq_mesh": tuple(wq.device_mesh.shape)}
    return answer({"before": before, "after": after})


def put_case(cfg, shape):
    """``device_put_fn`` on one synthetic batch: each leaf's placements
    and its whole value beside ``to_device_fn``'s."""
    from repro_torch.data.pipeline import (
        SyntheticTokenDataset,
        device_put_fn,
        to_device_fn,
    )

    mesh = mesh_of(shape)
    host = SyntheticTokenDataset(cfg, 4, 16, seed=3).batch_at(5)
    put = device_put_fn(mesh, lambda b: batch_pspec_tree(b, mesh))(host)
    plain = to_device_fn("cpu")(host)
    return answer({k: (split_dims(t), whole(t), whole(plain[k]))
                   for k, t in put.items()})


def launcher_case(argv: list[str]):
    from repro_torch.launch import train as launch

    res = launch.main(argv)
    return answer(res.losses)


def moments_case(cfg, params, batch, shape, grads: dict):
    """Two train steps with int8 moments and gradient compression on, each
    given the whole gradients ``grads``: unsharded and on ``shape`` from
    the same state. Returns each run's parameters, moments (an int8 leaf
    as its ``.codes`` and ``.scale``) and error-feedback buffer after each
    step, and, for each int8 leaf, the mesh dims that split its codes'
    last dim."""
    from repro_torch.optim.compression import (
        CompressionConfig,
        init_error_feedback,
    )

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, moment_style="int8")
    step_cfg = TrainStepConfig(remat="full",
                               compression=CompressionConfig(enabled=True))
    loss = torch.zeros(())
    given = (loss, {}, grads)

    def init():
        opt = adamw_init(opt_cfg, params)
        opt["ef"] = init_error_feedback(params)
        return opt

    def two_steps(p, o, b):
        rows = []
        for _ in range(2):
            p, o, _ = _step_given(
                lambda: step_mod.make_train_step(cfg, step_cfg, opt_cfg),
                given, p, o, b)
            rows.append({"params": flat(p), "m": flat(o["m"]),
                         "v": flat(o["v"]), "ef": flat(o["ef"])})
        return rows, o

    want, _ = two_steps(params, init(), batch)
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        dp, do, db, _ = laid_out(cfg, params, init(), batch, mesh)
        got, o = two_steps(dp, do, db)
        split = {k: [i for i, pl in enumerate(q.codes.placements)
                     if pl.is_shard(q.codes.ndim - 1)]
                 for k, q in _qtensors(o["m"])}
    return answer({"want": want, "got": got, "split": split,
                   "quantized": sorted(k for k, _ in _qtensors(init()["m"]))})


def _qtensors(tree, key: str = ""):
    """(keystr, QTensor) of every int8 leaf of ``tree``."""
    from repro_torch.optim.quantized import QTensor

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{key}[{k!r}]")
    elif isinstance(tree, QTensor):
        yield key, tree


def decode_case(cfg, params, tokens, shape, moe_groups=None):
    """Decode steps over ``tokens`` (B, n) one token at a time from an
    empty cache of ``tokens.shape[1]`` slots, unsharded and on ``shape``
    (parameters, cache and tokens laid out by the spec trees): each
    step's logits, and the caches after the last step."""
    from repro_torch.models import get_model
    from repro_torch.models.sharding import cache_pspec_tree

    model = get_model(cfg)
    B, n = tokens.shape

    def run(p, cache, lay):
        logits = []
        for i in range(n):
            tok = lay({"t": tokens[:, i:i + 1]})["t"]
            out, cache = model.decode_step(p, cache, tok, cfg,
                                           moe_groups=moe_groups)
            logits.append(whole(out))
        return logits, flat(cache)

    want = run(params, model.init_decode_cache(cfg, B, n, device="cpu"),
               lambda t: t)
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        specs = params_pspec_tree(params, expert_sharding=cfg.expert_sharding,
                                  mesh=mesh)
        dp = distribute_tree(params, specs, mesh)
        cache = model.init_decode_cache(cfg, B, n, device="cpu")
        dc = distribute_tree(cache, cache_pspec_tree(cache, mesh), mesh)
        split = {k: split_dims(t) for k, t in _leaves_with_keys(dc)
                 if hasattr(t, "placements")}
        got = run(dp, dc, lambda b: distribute_tree(
            b, batch_pspec_tree(b, mesh), mesh))
    return answer({"want": want, "got": got, "split": split})
