"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``.

Builds the DOLMA-aware batched engine (params + KV cache cataloged as data
objects; placement decided against the HBM budget) and runs a synthetic
request stream, reporting batched decode throughput. A port of
``repro.launch.serve``: it runs on the card (``--device cuda``, the
default) unless asked for the CPU, and draws its random weights from
``--seed`` on that device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core.exec import resolve_device
from repro_torch.models import get_model
from repro_torch.serving import EngineConfig, ServingEngine


def main(argv: list[str] | None = None) -> dict:
    """Serve ``--requests`` waves; returns the tokens served, the seconds
    they took and the batched tokens per second."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=2, help="request waves")
    ap.add_argument("--hbm-budget-gb", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg, dtype=torch.float32)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init_params(gen, cfg, device=dev)

    budget = int(args.hbm_budget_gb * 1e9) if args.hbm_budget_gb else None
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=args.batch, max_len=args.max_len, hbm_budget_bytes=budget,
    ))
    print(f"arch={cfg.name} device={dev} "
          f"placement={engine.stats()['placement']}")

    rng = np.random.default_rng(args.seed)
    total_toks = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the weights' draw is not served time
    t0 = time.perf_counter()
    for wave in range(args.requests):
        engine.reset()  # independent request waves
        prompts = rng.integers(
            0, cfg.vocab_size, (args.batch, args.prompt_len)
        ).astype(np.int32)
        out = engine.generate(prompts, max_new=args.new_tokens)
        total_toks += out.size
        print(f"wave {wave}: {out.shape[0]} requests x {out.shape[1]} tokens")
    dt = time.perf_counter() - t0
    print(f"{total_toks} tokens in {dt:.2f}s = {total_toks/dt:.1f} tok/s batched")
    return {"tokens": total_toks, "seconds": dt,
            "tokens_per_s": total_toks / dt}


if __name__ == "__main__":
    main()
