"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

A port of ``repro.launch.train``, with the same flags plus ``--device``
(``cuda`` by default; ``cpu`` runs the plain versions) and the placement
(``--tiering host_offload --local-fraction F``: parameters and optimizer
moments beyond the budget live in pinned host memory; ``fsdp_stream``:
split over the mesh's ``data`` axis and gathered layer by layer). The
reduced float32 config by default; ``--full`` takes the architecture's
real config.

``--mesh 'data,model[,pod]'`` runs the step over a device mesh of those
axis sizes (the reference's axis order), with ``--rules`` (JSON) over the
sharding rules. The mesh needs a process group of its size: the one
already running (a caller's), else with ``--distributed`` one from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), else, for a mesh of one, a one-process
group of its own; any other size raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import tempfile

# run-to-run equal cuBLAS results need this before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, reduced_config  # noqa: E402
from repro_torch.core.tiering import TieringConfig  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models.sharding import use_mesh, use_rules  # noqa: E402
from repro_torch.optim import AdamWConfig, CompressionConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, LoopResult, train  # noqa: E402
from repro_torch.train.step import TrainStepConfig  # noqa: E402


def main(argv: list[str] | None = None) -> LoopResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full config (accelerator-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="full",
                    help="none|full|full_flat|dots|dots_no_batch")
    ap.add_argument("--no-prefetch-under-remat", action="store_true",
                    help="no dual buffer inside the checkpointed blocks")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moment-style", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--tiering", default="none",
                    choices=["none", "host_offload", "fsdp_stream"])
    ap.add_argument("--local-fraction", type=float, default=1.0)
    ap.add_argument("--rules", default=None, help="JSON sharding-rule overrides")
    ap.add_argument("--mesh", default=None,
                    help="'data,model[,pod]' axis sizes, e.g. '4,2'")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun's environment "
                         "describes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg, dtype=torch.float32)

    tiering = TieringConfig(mode=args.tiering,
                            local_fraction=args.local_fraction,
                            prefetch_under_remat=not args.no_prefetch_under_remat)
    step_cfg = TrainStepConfig.from_tiering(
        tiering, remat=args.remat, microbatches=args.microbatches,
        compression=CompressionConfig(enabled=args.compress_grads))
    opt_cfg = AdamWConfig(lr=args.lr, moment_style=args.moment_style,
                          decay_steps=args.steps)
    loop_cfg = LoopConfig(
        steps=args.steps, batch=args.batch, seq=args.seq, seed=args.seed,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )

    rules = json.loads(args.rules) if args.rules else {}
    if args.distributed and not args.mesh:
        raise ValueError("--distributed: the ranks run one mesh; give its "
                         "axis sizes with --mesh")

    with contextlib.ExitStack() as stack:
        mesh = None
        if args.mesh:
            sizes = tuple(int(n) for n in args.mesh.split(","))
            axes = ("data", "model", "pod")[:len(sizes)]
            device = _join_group(math.prod(sizes), args, stack)
            mesh = make_smoke_mesh(sizes, axes, device=device.type)
            args.device = device
        print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
              f"device={args.device} tiering={args.tiering} "
              f"mesh={mesh and dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        with use_mesh(mesh), use_rules(**rules):
            res = train(cfg, step_cfg, opt_cfg, loop_cfg, device=args.device)
    print(f"done: step {res.final_step}, loss {res.losses[0]:.4f} -> "
          f"{res.losses[-1]:.4f}; stragglers={len(res.straggler_events)}"
          + (f"; resumed from {res.restored_from}" if res.restored_from else ""))
    return res


def _join_group(size: int, args, stack: contextlib.ExitStack) -> torch.device:
    """The process group for a mesh of ``size`` ranks, and this rank's
    device: a running group of that size, torchrun's (``--distributed``),
    or one of a single process started here (and ended on the way out)."""
    cuda = torch.device(args.device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if not dist.is_initialized():
        if args.distributed:
            if cuda:
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
        elif size == 1:
            store = os.path.join(stack.enter_context(
                tempfile.TemporaryDirectory()), "store")
            dist.init_process_group(backend, store=dist.FileStore(store, 1),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"--mesh {args.mesh}: {size} ranks need a process group; "
                f"start them with torchrun and pass --distributed")
        stack.callback(dist.destroy_process_group)
    if dist.get_world_size() != size:
        raise ValueError(f"--mesh {args.mesh}: {size} ranks, but the process "
                         f"group has {dist.get_world_size()}")
    if cuda:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


if __name__ == "__main__":
    main()
