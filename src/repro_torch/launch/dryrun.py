"""Multi-pod dry-run: trace every (arch x shape x mesh) cell per device.

The counterpart of ``repro.launch.dryrun``. For each cell this module:

  1. builds the production mesh (16x16 single-pod, 2x16x16 multi-pod) over
     a fake process group of 256 or 512 ranks (:func:`fake_process_group`:
     collectives post nothing; this process is rank 0), on ``cuda`` with a
     card and on ``cpu`` without;
  2. builds the parameters at full width as fake tensors (shapes, no
     storage) and runs DOLMA's placement decision (:func:`decide_tiering`)
     over the persistent objects to pick the sharding rules and the
     optimizer moments' form and tier;
  3. lays parameters, moments, batch and cache out as DTensors by the spec
     trees, each rank's shard a fake tensor of its own, and traces the
     train step, the prefill forward or the serve step on them
     (:func:`repro_torch.launch.hlo_analysis.analyze`): nothing is
     compiled, the kernels' ops stand in for their launches
     (:mod:`repro_torch.kernels.traced`);
  4. records the per-device FLOPs, bytes, collectives and memory.

The reference sets ``XLA_FLAGS`` to 512 host devices when it is imported;
this module sets nothing at import. The reference states the TPU's HBM as
a constant: here ``hbm_bytes`` is an argument, the card's memory by
default in the CLI (``--hbm-bytes`` without a card).

Record keys are the reference's, but for ``compile_s`` (nothing is
compiled) and ``xla_cost``, whose counterpart is ``flop_counter``:
``FlopCounterMode``'s count of the run, DTensor ops at their global shapes.
``lower_s`` is the time to build the abstract state and the decision,
``analyze_s`` the trace's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --cell train_4k --hbm-bytes 80e9
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --multi-pod
Results land in runs/dryrun/<arch>__<cell>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback
from typing import Any

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (
    SHAPE_CELLS,
    ModelConfig,
    ShapeCell,
    runnable_cells,
)
from repro_torch.core.metadata import Tier
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.tiering import (
    TieringConfig,
    _placed,
    supports_host_offload_spmd,
)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.hlo_analysis import Tracer, analyze
from repro_torch.models.api import batch_specs, get_model
from repro_torch.models.sharding import (
    _map_with_path,
    batch_pspec_tree,
    cache_pspec_tree,
    local_shape_and_offset,
    mesh_shape,
    opt_pspec_tree,
    params_pspec_tree,
    shard_factor,
    to_placements,
    use_mesh,
    use_rules,
)
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import init as adamw_init
from repro_torch.train.step import TrainStepConfig, make_train_step

HBM_BUDGET_FRACTION = 0.9

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun"


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks in which this process is
    rank 0 and every collective completes at once without moving data
    (torch's ``fake`` backend); destroyed on the way out."""
    import torch.distributed as dist
    # registers the "fake" backend's constructor
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a default process group "
                           "exists already")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves_and_specs(tree: Any, pspec_tree: Any) -> list[tuple]:
    specs: dict[tuple, Any] = {}
    _map_with_path(lambda path, s: specs.__setitem__(path, s), pspec_tree)
    pairs: list[tuple] = []
    _map_with_path(lambda path, leaf: pairs.append((leaf, specs[path])), tree)
    return pairs


def _tree_device_bytes(abstract_tree, pspec_tree, mesh) -> int:
    total = 0
    for leaf, spec in _leaves_and_specs(abstract_tree, pspec_tree):
        size = leaf.numel() * leaf.element_size()
        total += size // shard_factor(spec, mesh)
    return total


def decide_tiering(cfg: ModelConfig, cell: ShapeCell, mesh, params_abs, *,
                   hbm_bytes: float) -> dict:
    """DOLMA's quantitative placement decision at HBM granularity, for a
    device of ``hbm_bytes``.

    Persistent objects = params + optimizer moments. In placement-policy
    order (size desc, access asc, write-ratio desc) the moments are demoted
    first (1 access/step, write-heavy), then params are FSDP-streamed
    (= fetched per layer through the dual buffer). Returns rule overrides +
    flags + the byte accounting that justified the decision.
    """
    decision: dict[str, Any] = {
        "rules": {}, "offload_moments": False, "fsdp": False, "notes": [],
    }
    shape = mesh_shape(mesh)
    with use_mesh(mesh):
        pspecs = params_pspec_tree(
            params_abs, expert_sharding=cfg.expert_sharding, mesh=mesh
        )
        params_dev = _tree_device_bytes(params_abs, pspecs, mesh)
        decision["params_bytes_per_dev"] = params_dev

        if cell.kind != "train":
            if params_dev > HBM_BUDGET_FRACTION * hbm_bytes:
                decision["fsdp"] = True
                decision["rules"]["fsdp"] = "data"
                with use_rules(fsdp="data"):
                    pspecs = params_pspec_tree(
                        params_abs, expert_sharding=cfg.expert_sharding,
                        fsdp=True, mesh=mesh,
                    )
                decision["params_bytes_per_dev"] = _tree_device_bytes(
                    params_abs, pspecs, mesh
                )
                decision["notes"].append("inference params FSDP-sharded (over HBM)")
            return decision

        # training: decide moment placement down the ladder
        batch_shards = 1
        for ax in ("pod", "data"):
            if ax in shape:
                batch_shards *= shape[ax]
        b_loc = max(cell.global_batch // batch_shards, 1)
        sp = shape.get("model", 1)
        act_dev = cfg.n_layers * b_loc * cell.seq_len * cfg.d_model * 2 // sp
        act_dev = int(act_dev * 1.5) + int(2e9)  # carries + working set
        decision["act_bytes_per_dev_est"] = act_dev
        budget = HBM_BUDGET_FRACTION * hbm_bytes

        # moment bytes relative to bf16 param bytes: f32 pair = 4x, bf16 = 2x,
        # int8 blockwise = ~1.03x
        moment_factor = {"f32": 4.0, "bf16": 2.0, "int8": 1.03}
        offload_ok = supports_host_offload_spmd(mesh)
        decision["host_offload_supported"] = offload_ok
        moment_style = "f32"

        def projected(style, p_dev, offload):
            m = 0 if offload else p_dev * moment_factor[style]
            return p_dev + m + act_dev

        if projected(moment_style, params_dev, False) > budget and offload_ok:
            decision["offload_moments"] = True
            decision["notes"].append(
                "moments -> pinned_host (DOLMA rule: largest, 1 access/step, "
                "write-heavy)"
            )
        if projected(moment_style, params_dev,
                     decision["offload_moments"]) > budget:
            decision["fsdp"] = True
            decision["rules"]["fsdp"] = "data"
            with use_rules(fsdp="data"):
                pspecs2 = params_pspec_tree(
                    params_abs, expert_sharding=cfg.expert_sharding,
                    fsdp=True, mesh=mesh,
                )
            params_dev = _tree_device_bytes(params_abs, pspecs2, mesh)
            decision["params_bytes_per_dev"] = params_dev
            decision["notes"].append(
                "params FSDP-sharded + per-layer gather via dual-buffer scan"
            )
        for style in ("f32", "bf16", "int8"):
            moment_style = style
            if projected(style, params_dev, decision["offload_moments"]) <= budget:
                break
        if moment_style != "f32":
            decision["notes"].append(
                f"moments stored as {moment_style} (host offload "
                f"{'unsupported' if not offload_ok else 'insufficient'} on this "
                "backend)"
            )
        decision["moment_style"] = moment_style
        decision["moments_bytes_per_dev"] = int(
            0 if decision["offload_moments"]
            else params_dev * moment_factor[moment_style]
        )
        decision["projected_bytes_per_dev"] = int(
            projected(moment_style, params_dev, decision["offload_moments"])
        )
        return decision


def abstract_params(cfg: ModelConfig, tracer: Tracer, device: str) -> Any:
    """The parameters at full width as fake tensors of ``tracer`` (the
    port's ``jax.eval_shape`` of ``init_params``)."""
    with tracer:
        return get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          cfg, device=device)


def laid_out(tree: Any, pspec_tree: Any, mesh, tracer: Tracer) -> Any:
    """Every leaf of ``tree`` (whole, fake) as a DTensor on ``mesh`` with
    its spec's placements, its local shard (rank 0's) a fake tensor of its
    own: the memory a rank holds, not a view of the whole."""
    from torch.distributed.tensor import DTensor

    specs: dict[tuple, Any] = {}
    _map_with_path(lambda path, s: specs.__setitem__(path, s), pspec_tree)

    def put(path, leaf):
        placements = to_placements(specs[path], mesh)
        local, _ = local_shape_and_offset(leaf.shape, mesh, placements)
        with tracer:
            t = torch.empty(local, dtype=leaf.dtype, device=leaf.device)
            return DTensor.from_local(t, mesh, placements, run_check=False,
                                      shape=leaf.shape, stride=leaf.stride())

    return _map_with_path(put, tree)


def _moments_plan(params: Any, opt: Any) -> PlacementPlan:
    """The reference's ``offload_moments`` as a placement plan: every
    moment leaf REMOTE (host memory), the parameters and the step LOCAL."""
    from repro_torch.core.objects import _leaves_with_keys

    tiers, local, remote = {}, 0, 0
    for prefix, tree in (("params", params), ("opt", opt)):
        for k, t in _leaves_with_keys(tree):
            n = t.numel() * t.element_size()
            name = prefix + k
            if prefix == "opt" and name.startswith(("opt['m']", "opt['v']")):
                tiers[name], remote = Tier.REMOTE, remote + n
            else:
                tiers[name], local = Tier.LOCAL, local + n
    return PlacementPlan(tiers=tiers, local_bytes=local, remote_bytes=remote,
                         peak_bytes=local + remote, budget_bytes=local)


def run_cell(arch: str, cell_name: str, *, multi_pod: bool,
             rules_override: dict | None = None,
             remat: str = "full", prefetch: bool = True,
             microbatches: int = 1,
             offload_override: bool | None = None,
             fsdp_override: bool | None = None,
             hbm_bytes: float | None = None) -> dict:
    """One cell traced over a fake group of the production mesh's size
    (see the module's docstring), on ``cuda`` with a card, else ``cpu``.
    ``hbm_bytes`` defaults to the card's memory."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if hbm_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("run_cell: no card to size the budget by; pass "
                             "hbm_bytes")
        hbm_bytes = torch.cuda.get_device_properties(0).total_memory
    cfg = get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    model = get_model(cfg)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    record: dict[str, Any] = {
        "arch": arch, "cell": cell_name, "mesh": mesh_name,
        "kind": cell.kind, "remat": remat, "prefetch": prefetch,
        "microbatches": microbatches,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if cell_name not in runnable_cells(cfg):
        record["skipped"] = (
            "long_500k requires sub-quadratic attention; "
            f"{arch} is full-attention (DESIGN.md §Arch-applicability)"
        )
        return record

    world = 512 if multi_pod else 256
    with fake_process_group(world):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device=device)
        _trace_cell(record, cfg, cell, model, mesh, device, hbm_bytes,
                    rules_override=rules_override, remat=remat,
                    prefetch=prefetch, microbatches=microbatches,
                    offload_override=offload_override,
                    fsdp_override=fsdp_override)
    return record


def _trace_cell(record: dict, cfg: ModelConfig, cell: ShapeCell, model,
                mesh, device: str, hbm_bytes: float, *, rules_override,
                remat: str, prefetch: bool, microbatches: int,
                offload_override, fsdp_override) -> None:
    t0 = time.time()
    tracer = Tracer()
    params_abs = abstract_params(cfg, tracer, device)
    decision = decide_tiering(cfg, cell, mesh, params_abs,
                              hbm_bytes=hbm_bytes)
    if rules_override:
        decision["rules"].update(rules_override)
    if offload_override is not None:
        decision["offload_moments"] = offload_override
    if fsdp_override is not None:
        decision["fsdp"] = fsdp_override
        if fsdp_override and "fsdp" not in decision["rules"] and not (
            rules_override and "fsdp" in rules_override
        ):
            decision["rules"]["fsdp"] = "data"
    record["tiering"] = {k: v for k, v in decision.items()}

    moe_groups = None
    shape = mesh_shape(mesh)
    if cfg.is_moe and cell.kind == "decode":
        batch_shards = 1
        for ax in ("pod", "data"):
            if ax in shape:
                batch_shards *= shape[ax]
        moe_groups = max(min(cell.global_batch, batch_shards), 1)

    with use_mesh(mesh), use_rules(**decision["rules"]):
        pspecs = params_pspec_tree(
            params_abs, expert_sharding=cfg.expert_sharding,
            fsdp=decision["fsdp"], mesh=mesh,
        )
        params = laid_out(params_abs, pspecs, mesh, tracer)

        if cell.kind == "train":
            opt_cfg = AdamWConfig(moment_style=decision.get("moment_style", "f32"))
            with tracer:
                opt_abs = adamw_init(opt_cfg, params_abs)
            opt = laid_out(opt_abs, opt_pspec_tree(opt_abs, pspecs, mesh),
                           mesh, tracer)
            del opt_abs
            plan = None
            if decision["offload_moments"]:
                # 'step' and every parameter stay on the device
                plan = _moments_plan(params, opt)
                with tracer:
                    (params, opt), plan = _placed(
                        plan, TieringConfig(mode="host_offload"),
                        torch.device(device), params=params, opt=opt)
            step_cfg = TrainStepConfig(
                remat=remat, prefetch=prefetch, microbatches=microbatches,
                moe_groups=moe_groups,
            )
            train_step = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)
            batch = _fake_batch(cfg, cell, mesh, tracer, device)
            fn, args = train_step, (params, opt, batch)
        elif cell.kind == "prefill":
            def prefill_fn(params, batch):
                logits, _aux = model.forward(
                    params, batch, cfg, remat="none", prefetch=prefetch,
                    moe_groups=None,
                )
                return logits[:, -1:, :]

            batch = _fake_batch(cfg, cell, mesh, tracer, device)
            fn, args = prefill_fn, (params, batch)
        else:  # decode
            with tracer:
                cache_abs = model.init_decode_cache(
                    cfg, cell.global_batch, cell.seq_len, device=device)
                tok_abs = torch.zeros((cell.global_batch, 1),
                                      dtype=torch.int32, device=device)
            cache = laid_out(cache_abs, cache_pspec_tree(cache_abs, mesh),
                             mesh, tracer)
            tokens = laid_out({"t": tok_abs}, batch_pspec_tree(
                {"t": tok_abs}, mesh), mesh, tracer)["t"]
            del cache_abs

            def serve_step(params, cache, tokens):
                return model.decode_step(params, cache, tokens, cfg,
                                         moe_groups=moe_groups)

            fn, args = serve_step, (params, cache, tokens)
        del params_abs
        record["lower_s"] = round(time.time() - t0, 2)

        t2 = time.time()
        with torch.no_grad() if cell.kind != "train" else (
                contextlib.nullcontext()):
            analysis = analyze(fn, *args, device=device)
        record["memory"] = analysis.memory
        record["flop_counter"] = {"flops": analysis.global_flops}
        record["analysis"] = analysis.summary()
        record["launches"] = {
            op: analysis.launches(f"repro_torch.{op}")
            for op in ("b1_matmul", "b2_flash", "b3_scan")}
        # aggregate collectives by (op, group_size) for DCN/ICI attribution
        agg: dict[str, float] = {}
        for c in analysis.collectives:
            key = f"{c.op}@g{c.group_size}"
            agg[key] = agg.get(key, 0.0) + c.result_bytes * c.multiplier
        record["collectives_by_group"] = agg
        record["analyze_s"] = round(time.time() - t2, 2)


def _fake_batch(cfg: ModelConfig, cell: ShapeCell, mesh, tracer: Tracer,
                device: str) -> dict:
    """A train or prefill batch of ``cell`` laid out by its spec tree."""
    with tracer:
        batch_abs = {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
                     for k, t in batch_specs(cfg, cell).items()}
    return laid_out(batch_abs, batch_pspec_tree(batch_abs, mesh), mesh,
                    tracer)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--rules", default=None, help="JSON logical-rule overrides")
    ap.add_argument("--fsdp", action="store_true", help="force FSDP param naming")
    ap.add_argument("--tag", default=None, help="suffix for result files")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--hbm-bytes", type=float, default=None,
                    help="a device's memory for the decision (default: the "
                         "card's; required without one)")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the result files")
    args = ap.parse_args(argv)
    if args.hbm_bytes is None and not torch.cuda.is_available():
        ap.error("--hbm-bytes is required without a card")

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    cells = list(SHAPE_CELLS) if args.cell == "all" else [args.cell]
    rules = json.loads(args.rules) if args.rules else None
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    for arch in archs:
        for cell in cells:
            mesh_name = "2x16x16" if args.multi_pod else "16x16"
            tag = f"__{args.tag}" if args.tag else ""
            out = out_dir / f"{arch}__{cell}__{mesh_name}{tag}.json"
            if out.exists() and not args.force:
                print(f"[skip] {out.name} exists")
                continue
            print(f"[dryrun] {arch} x {cell} x {mesh_name} ...", flush=True)
            try:
                rec = run_cell(
                    arch, cell, multi_pod=args.multi_pod,
                    rules_override=rules, remat=args.remat,
                    prefetch=not args.no_prefetch,
                    microbatches=args.microbatches,
                    fsdp_override=True if args.fsdp else None,
                    hbm_bytes=args.hbm_bytes,
                )
            except Exception:  # noqa: BLE001
                rec = {
                    "arch": arch, "cell": cell, "mesh": mesh_name,
                    "error": traceback.format_exc(),
                }
                print(rec["error"], flush=True)
            out.write_text(json.dumps(rec, indent=1, default=str))
            status = "ERROR" if "error" in rec else (
                "SKIP" if "skipped" in rec else "ok"
            )
            print(f"[done] {out.name}: {status} "
                  f"(trace {rec.get('analyze_s', '-')}s)", flush=True)


if __name__ == "__main__":
    main()
