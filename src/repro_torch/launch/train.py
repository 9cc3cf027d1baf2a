"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

A port of ``repro.launch.train``, with the same flags plus ``--device``
(``cuda`` by default; ``cpu`` runs the plain versions) and the placement
(``--tiering host_offload --local-fraction F``: parameters and optimizer
moments beyond the budget live in pinned host memory). The reduced float32
config by default; ``--full`` takes the architecture's real config.
``--mesh``, ``--rules`` and ``--distributed`` wait for the sharding slice
(ROADMAP A11).
"""
from __future__ import annotations

import argparse
import os

# run-to-run equal cuBLAS results need this before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, reduced_config  # noqa: E402
from repro_torch.core.tiering import TieringConfig  # noqa: E402
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
                    choices=["none", "host_offload"])
    ap.add_argument("--local-fraction", type=float, default=1.0)
    ap.add_argument("--rules", default=None, help="JSON sharding-rule overrides")
    ap.add_argument("--mesh", default=None,
                    help="'data,model[,pod]' axis sizes, e.g. '4,2'")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host initialisation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    for flag in ("mesh", "rules", "distributed"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag}: meshes, sharding rules and multi-host runs wait "
                f"for the sharding slice (ROADMAP A11)")

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

    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={args.device} tiering={args.tiering}")
    res = train(cfg, step_cfg, opt_cfg, loop_cfg, device=args.device)
    print(f"done: step {res.final_step}, loss {res.losses[0]:.4f} -> "
          f"{res.losses[-1]:.4f}; stragglers={len(res.straggler_events)}"
          + (f"; resumed from {res.restored_from}" if res.restored_from else ""))
    return res


if __name__ == "__main__":
    main()
