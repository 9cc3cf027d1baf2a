#!/usr/bin/env python3
"""Where a served model's time goes on the card: one forward and one decode
step at full width, under ``torch.profiler``.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 profile_models.py [--models granite-8b,zamba2-1.2b,mamba2-130m]

For each model the weights are drawn on the card from a seed, all local
(bf16); the MoE configurations are cut to the depth one card holds
(``DEPTH``, as ``chip_smoke.py``'s ``[moe]`` cuts them). After a warm-up,
one ``forward`` over 4 x 2048 tokens and one ``decode_step`` of 4 lanes
(after 8 steps of prompt; the MoE layers in one dispatch group, as the
serving engine runs them) are profiled. For each
it prints the wall time (host clock, ending in a synchronise), the device
time summed over kernels, the device's idle share (1 - device / wall), the
device time by category (the port's kernels B2 and B3, cuBLAS GEMMs,
copies, everything else) and the heaviest kernels. The kernels are built
from this checkout's sources first. It imports nothing of JAX or the
reference package ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import get_model, make_batch  # noqa: E402

# kernel name patterns, first match wins
CATEGORIES = [
    ("B2 flash (port)", re.compile(r"flash")),
    ("B3 SSD (port)", re.compile(r"ssd_")),
    ("GEMM (cuBLAS)", re.compile(r"gemm|nvjet|xmma|cutlass|sm90_", re.I)),
    ("copy", re.compile(r"memcpy|memset", re.I)),
    ("other (elementwise, norms, softmax, reductions)", re.compile(".")),
]
TOP = 10
# layers run of the configurations whose full depth one card cannot hold:
# deepseek-v3's 3 dense layers and 1 MoE layer (22.5 GB of routed experts
# in bf16), mixtral's first 4 layers
DEPTH = {"deepseek-v3-671b": 4, "mixtral-8x7b": 4}


def kernel_times(prof) -> dict[str, tuple[float, int]]:
    """Device ms and count of each kernel in the profile, by name."""
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def report(label: str, wall_ms: float, kernels: dict) -> None:
    busy = sum(ms for ms, _ in kernels.values())
    if not kernels:
        print(f"[profile] {label}: wall {wall_ms:.3f} ms; the profiler "
              f"recorded no device time")
        return
    launches = sum(n for _, n in kernels.values())
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device (sum of "
          f"kernels) {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.2%}, {launches} kernels")
    by_cat: dict[str, list[float]] = {}
    for name, (ms, n) in kernels.items():
        cat = next(c for c, pat in CATEGORIES if pat.search(name))
        acc = by_cat.setdefault(cat, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    for cat, (ms, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label}   {cat}: {ms:.3f} ms ({ms / busy:.1%} of "
              f"device time), {n} launches")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:TOP]:
        print(f"[profile] {label}     {ms:.3f} ms x{n} {name[:110]}")


def profiled(fn) -> tuple[float, dict]:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, kernel_times(prof)


def run(arch: str) -> None:
    cfg = get_config(arch)
    name = arch
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
        name = f"{arch} ({cfg.n_layers} layers)"
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, cfg)
    batch = make_batch(cfg, gen, 4, 2048)
    prompt = make_batch(cfg, gen, 4, 9)["tokens"]
    model.forward(params, batch, cfg)  # warm-up
    wall, kernels = profiled(lambda: model.forward(params, batch, cfg))
    report(f"{name} forward 4 x 2048", wall, kernels)
    cache = model.init_decode_cache(cfg, 4, 80)
    for t in range(8):
        _, cache = model.decode_step(params, cache, prompt[:, t:t + 1], cfg,
                                     moe_groups=1)
    wall, kernels = profiled(lambda: model.decode_step(
        params, cache, prompt[:, 8:9], cfg, moe_groups=1))
    report(f"{name} decode step (4 lanes, position 8)", wall, kernels)
    del params, batch, cache
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="granite-8b,zamba2-1.2b,mamba2-130m")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_models: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {smi}")
    _build.build_all()
    for arch in args.models.split(","):
        run(arch)


if __name__ == "__main__":
    main()
