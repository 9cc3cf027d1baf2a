#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failed check raises and exits non-zero):

  1. device: name, count, versions, ``nvidia-smi`` name and power limit;
  2. build: every kernel in ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once), with ptxas's register,
     shared-memory and spill report, and the count of tensor-core
     instructions (``HGMMA``, ``HMMA``) in each library's SASS
     (``cuobjdump -sass``): the matmul and flash libraries must hold HGMMA,
     the SSD library HGMMA or HMMA;
  3. kernels against their plain PyTorch versions on the card: the
     reference's kernel test cases (``tests/test_kernels.py``) in float32
     (the FFMA variants) and bf16 (the tensor-core variants), a bf16 shape
     of each that the variant rule sends to the FFMA kernel, then the main
     path's full-width shapes and the matmul's backward (dx, dw) at full
     width, within ``kernels.ref.tolerance_ratio``'s bound (the reference's
     tolerances, and for bf16 a bound scaled to each output row); then a
     planted fault at full width (one tile skipped) that the bound must
     fail;
     the bf16 backward of a product with K = 100 (ROADMAP C5: dx's N is
     100, computed padded to 104); B2 at the models' attention shapes;
     The SSD scan likewise: the reference's cases at 2e-4; at
     mamba2-130m's full shape each of its three kernels (chunk state, state
     passing, chunk output) against its plain stage, then the scan against
     the one-loop oracle; and two planted faults: a plain version that drops
     one chunk's carry update, and the oracle run in single-pass TF32;
     the three kernels and the scan at zamba2-1.2b's shape too;
  4. the streaming executor over 36-stage granite-8b-width matmul and
     attention chains (bf16) — untiered oracle, unpaced probe, balanced
     throttle, best of 3 runs with prefetch on and off, every output
     ``torch.equal`` to the oracle, the kernels' launch counters matching
     the stages run (every bf16 launch through the tensor-core variant),
     the mean stage compute beside the unpaced copy of one stage's bytes,
     then the simulator calibrated and replayed;
  5. the model paths at full width in bf16, through ``get_model``'s entry
     points: mamba2-130m (24 layers), granite-8b (``[dense]``: 36 layers,
     8.05 B parameters, B2 in every layer) and zamba2-1.2b (``[hybrid]``: 38
     Mamba2 layers and the shared attention block after every 6, so B3 and
     B2 in one forward). For each: the weights drawn on the card from a
     seed and kept on the host; ``forward`` over 4 x 2048 tokens with every
     weight on the card (the oracle), then placed by ``host_offload`` at
     local fractions 0.5 and 0.0, prefetch on and off, every logits tensor
     ``torch.equal`` to the oracle, best-of-3 ms, host ms, bytes and peak
     memory per placement; greedy serving of 4 prompts (all local through
     ``ServingEngine.generate``, at 0.5 through the hand loop ``greedy``
     over ``decode_step``; tokens equal); each kernel's
     launches equal to its count a forward times the forwards (granite-8b:
     36 B2; zamba2-1.2b: 6 B2 and 38 B3; mamba2-130m: 24 B3), every B2
     launch through wgmma and each SSD kernel once a scan. Then the path
     check: the same forward with the kernels' plain versions (the plain
     SSD, the models' plain flash), in bf16 printed beside its floor (the
     plain forward with one plain version's output nudged) and held to
     ``PATH_BOUND`` in float32 (granite-8b on 8 layers); and decode against
     forward in float32 over 512 tokens (granite-8b on 2 layers,
     zamba2-1.2b on 12). On granite-8b's weights, ``[engine]``: the port's
     serving layer at full width (below). Then ``[moe]`` (below):
     deepseek-v3-671b and mixtral-8x7b;
  6. kernel times at the main paths' shapes (CUDA events), per variant
     (the tensor-core kernel on the path and the FFMA kernel on the same
     bf16 inputs), beside the plain version's, one library call's (none for
     the SSD scan), and the card's bound (for the SSD scan at the rate of
     the instruction it uses, 3xTF32); the SSD scan's three kernels alone
     and ``ops.ssd_prep``, the prep in front of it; then B2 and B3 at the
     models' shapes (phase 3 checks them there too): B2 at granite-8b's,
     zamba2-1.2b's and deepseek-v3's MLA attention (D 192, Dv 128; both
     variants, and the backend SDPA picked) through the models' route, B3
     and ``ops.ssd_prep`` at zamba2-1.2b's scan;
  7. one JSON line ``{"kernels": [...]}``;
  8. the last line, ``{"ok": true, "device": {...}}``.

``[engine]`` (in phase 5, granite-8b at full width, bf16): two
``ServingEngine.generate`` waves (4 prompts of 64 tokens, 16 new, a
128-slot cache, ``reset`` between) with tokens equal to the hand loop's; an
engine whose HBM budget demotes the K and V caches into a 2-node pool with 2
replicas, tokens equal and each demoted tier's pool payload equal to the
cache's bf16 bytes, ``offload_memory_kind`` ``"pinned_host"``; a
``ContinuousScheduler`` over that engine in lane mode (two tenants, 6
requests joining in pairs, one tenant's lanes offloaded to its pool arena),
every request's tokens equal to it run alone through a fresh lane-mode
engine; the engine's and ``decode_lanes``' step latencies (median, min) and
their device time and kernels a step under ``torch.profiler``; then
``python -m repro_torch.launch.serve --full``'s tokens/s. Decode launches
none of the port's kernels, so this path's launches are 0.

``[moe]`` (after ``[hybrid]``): deepseek-v3-671b and mixtral-8x7b at full
width, their depth cut to what one card holds (``MOE_MODELS``; the script
prints the config's bytes at full depth and the cut): weights drawn on the
card; ``forward`` over 4 x 2048 tokens all local, then at host_offload 0.5
(which must demote the routed experts first), prefetch on and off, logits
``torch.equal``; B2 once a layer a forward, every launch on the tensor
cores (deepseek-v3's MLA at D 192, mixtral's GQA at D 128 with its 4096
window); ``ServingEngine.generate`` of 4 prompts (64 tokens, 16 new)
untiered, then with ``expert_paging`` at 4x oversubscription (resident 64
of 256, 2 of 8): tokens and every cache leaf equal, with the pager's hit
rate, misses, sync fetches, bytes over the copy stream, simulated
degradation, step times and peak memory printed; then in float32, at the
depth float32 weights fit, the forward against the models' plain flash
(B2's FFMA kernel) and decode against forward without drops.

Three checks ride along. ``[serving-bench]`` (after ``[hpc]``):
``benchmarks/fig_autoscale.py``'s and ``fig_serving_mt.py``'s loops through
the port, the reduced granite-8b engine in float32 on the card, must give
``BENCH_pr5.json``'s and ``BENCH_pr9.json``'s values exactly (``latency_us``
printed, not compared), with autoscaled tokens equal to untiered ones and
lanes to the sequential oracle. ``[hpc]`` (after the build): DOLMA's runtime and
its eight HPC workloads through the port, on this machine's Python and
numpy: ``benchmarks/run.py --bench-json``'s loop must give
``BENCH_pr3.json``'s simulated microseconds exactly (an InfiniBand-100G
fabric model on a simulated clock, not times taken on the card) and every
tiered checksum the oracle's, and the Fig 7 sweep the reference's average
memory saving at no more than 16 % slowdown. ``[c6]`` (in phase 5, on
granite-8b's weights): a decode step at and past the KV cache's length on
the card raises no device assert, a scalar step writes only the cache's
last slot, and a lane past the cache leaves its rows unchanged.

It imports nothing of JAX or the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from profile_models import profiled  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B  # noqa: E402
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M  # noqa: E402
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B  # noqa: E402
from repro_torch.core.tiering import (  # noqa: E402
    TieringConfig,
    map_leaves,
    place_params,
    plan_for_params,
)
from repro_torch.core.exec import (  # noqa: E402
    StreamingExecutor,
    attention_chain,
    balanced_throttle,
    matmul_chain,
    untiered_oracle,
)
from repro_torch.core.fabric import FabricResource, SimClock  # noqa: E402
from repro_torch.core.objects import _leaves_with_keys  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import streaming_matmul as sm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    NEG_INF,
    flash_ref,
    matmul_ref,
    outside_tolerance,
    reference_attention,
    tolerance_ratio,
)
from repro_torch.models import make_batch  # noqa: E402
from repro_torch.models import flash as mflash  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousScheduler,
    EngineConfig,
    ExpertPagingConfig,
    Request,
    SchedulerConfig,
    ServingEngine,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W); "tf32" is
# the tensor cores' TF32 rate, which the SSD kernels use in three passes
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
TF32_PASSES = 3
HBM_BYTES_PER_S = 3.35e12

# the reference's kernel tolerances (tests/test_kernels.py); bf16 is also
# held to a bound scaled to each output row (kernels.ref.tolerance_ratio)
MATMUL_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.5}
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
MATMUL_CASES = [(128, 256, 128), (256, 512, 256), (128, 1024, 384),
                (384, 256, 512)]
FLASH_CASES = [  # B, H, KV, Sq, Sk, D, Dv, causal, window
    (1, 4, 2, 128, 128, 32, 32, True, None),
    (2, 4, 1, 128, 128, 32, 16, True, 64),     # MQA + SWA + MLA-dv
    (1, 2, 2, 128, 256, 32, 32, False, None),  # cross attention
    (1, 8, 4, 256, 256, 64, 64, True, None),
]
# bf16 shapes that the variant rules send to the FFMA kernels: K % 8 != 0
# (matmul), D and Dv not multiples of 16 (flash)
MATMUL_FFMA_BF16 = [(128, 100, 128)]
# a bf16 product whose backward's dx has N = K = 100 (ROADMAP C5)
MATMUL_C5 = (256, 100, 256)
FLASH_FFMA_BF16 = [(1, 2, 2, 128, 128, 40, 40, True, None)]
# the tensor-core instructions counted in each library's SASS, and those
# each library must hold at least one of: HGMMA (wgmma) or HMMA (mma.sync)
SASS_OPS = ("HGMMA", "HMMA")
NEEDS_TENSOR_CORES = {"streaming_matmul": ("HGMMA",),
                      "flash_attention": ("HGMMA",),
                      "ssd_scan": ("HGMMA", "HMMA")}
# the reference's SSD tolerance (tests/test_kernels.py::TestSSDKernel);
# L, chunk, G with B 2, H 4, P 32, N 32, then one chunk and L < chunk
SSD_TOL = 2e-4
SSD_CASES = [(64, 32, 1), (64, 32, 2), (128, 32, 1), (128, 32, 2),
             (256, 64, 1), (256, 64, 2), (32, 32, 1), (16, 32, 2)]
# a ragged shape: Q = 48 fills neither a 64-row nor a 32-key tile, and P, N
# not multiples of 4 take the kernels' 4-byte copies
SSD_RAGGED = dict(B=1, H=2, L=96, P=30, N=20, chunk=48, G=1)
# mamba2-130m's chunk scan at the path's batch and prompt length
SSD_FULL = dict(B=4, H=24, L=2048, P=64, N=128, chunk=256, G=1)
# zamba2-1.2b's chunk scan, and B2 at the two models' attention shapes
# (causal, Dv = D), at the same batch and prompt length
SSD_ZAMBA = dict(B=4, H=64, L=2048, P=64, N=64, chunk=256, G=1)
FLASH_MODELS = {"granite-8b": dict(B=4, H=32, KV=8, S=2048, D=128),
                "zamba2-1.2b": dict(B=4, H=32, KV=32, S=2048, D=64),
                # deepseek-v3's MLA prefill: D = 128 nope + 64 rope, Dv 128,
                # v a slice of the (B, S, H, 128 + 128) up-projection
                "deepseek-v3-671b MLA": dict(B=4, H=128, KV=128, S=2048,
                                             D=192, Dv=128)}
BEST_OF = 3
# the float32 plain-SSD forward's bound, as a share of max(1, max|logits|),
# float32's bound for decode against forward; why the check is held in
# float32 is written where it is used (phase_mamba)
PATH_BOUND = 1e-3
# [engine]: granite-8b served through ServingEngine at full width: waves of 4
# prompts of 64 tokens and 16 new ones in a 128-slot cache; a budget of 32
# MiB demotes every parameter and then the K and V caches (37.7 MB each)
ENGINE = dict(max_batch=4, max_len=128)
ENGINE_NEW = 16
ENGINE_TIERED = dict(hbm_budget_bytes=32 << 20, pool_nodes=2,
                     pool_replication=2)
# the lanes: two tenants, 6 requests of 16-token prompts and 16 new tokens,
# joining in three pairs while earlier ones decode
LANE_PROMPT, LANE_NEW, LANE_REQUESTS = 16, 16, 6
# steps of a profiled engine wave (8 prompt tokens, 8 new) and of the timed
# and profiled lane steps
PROFILE_STEPS = 16
# [moe]: the two MoE configurations at full width, their depth cut to what
# one card holds (a deepseek-v3 MoE layer alone holds 256 x 3 x 7168 x 2048
# routed parameters, 22.5 GB in bf16; mixtral's 32 layers ~90 GB of
# experts): deepseek-v3's 3 first_k_dense MLA + MLP layers, 1 MoE layer and
# the mtp block, mixtral's first 4 layers. Paging oversubscribes the expert
# bytes 4x (resident 64 of 256, 2 of 8). The float32 checks run at the
# depth float32 weights fit (deepseek-v3: 1 dense + 1 MoE layer, 52 GB);
# decode against forward without drops (capacity factor 8, one dispatch
# group; deepseek-v3 on one lane: two lanes would share capacity 1)
MOE_MODELS = {
    "deepseek-v3-671b": dict(n_layers=4, resident=64, depth32=2, dense32=1,
                             lanes32=1, tokens32=64),
    "mixtral-8x7b": dict(n_layers=4, resident=2, depth32=4, dense32=0,
                         lanes32=2, tokens32=128),
}
MOE_PROMPT, MOE_NEW = 64, 16


def zero_counts() -> None:
    """Every kernel's launch counts, variants included, back to 0."""
    sm.reset_launches()
    fa.reset_launches()
    ssd.reset_launches()


def counts() -> dict:
    return {"streaming_matmul": sm.LAUNCHES, "flash_attention": fa.LAUNCHES,
            "ssd_scan": ssd.LAUNCHES}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def rand(rng, shape, dtype) -> torch.Tensor:
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype).cuda()


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float,
            what: str) -> float:
    """Largest |got - want|; fails unless every element is within
    ``tolerance_ratio``'s bound. Prints the worst element's share of it."""
    require(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    ratio = tolerance_ratio(got, want, tol)
    bad = int((~(ratio <= 1.0)).sum())
    worst = ratio.max().item()
    require(bad == 0, f"{what}: {bad} elements beyond the bound (worst "
                      f"{worst:.3g}x it)")
    err = (got.float() - want.float()).abs().max().item()
    print(f"[check] {what}: max|err| {err:.3g}, worst element at "
          f"{worst:.3f} of its bound")
    return err


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time in ms the card could take at ``peak`` FLOP/s, and what
    bounds it."""
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# -- 1. device ----------------------------------------------------------------
def phase_device() -> dict:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {kind} x{count}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"kind": kind, "count": count, "smi": smi}


# -- [hpc]: DOLMA's runtime and the eight HPC workloads ---------------------
def phase_hpc(dev: dict) -> None:
    """``benchmarks/run.py --bench-json``'s loop through the port must give
    ``BENCH_pr3.json``'s four simulated values for every workload (and
    every tiered checksum the oracle's: the loop asserts it), and the Fig 7
    sweep the reference's average saving. Host work, numpy; the numbers
    are simulated microseconds of the InfiniBand-100G fabric model."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_hpc_parity as H

    pkg = H.package("repro_torch")
    t0 = time.perf_counter()
    rows = H.bench_pr3(pkg)
    want = H.committed("BENCH_pr3")["workloads"]
    require(set(rows) == set(want),
            f"[hpc] workloads {sorted(rows)} != {sorted(want)}")
    for name, row in rows.items():
        print(f"[hpc] {name}: simulated oracle {row['oracle_elapsed_us']!r} "
              f"us, legacy {row['legacy_elapsed_us']!r} us, pipeline "
              f"{row['pipeline_elapsed_us']!r} us, speedup "
              f"{row['pipeline_speedup']!r}; checksum {row['checksum']!r} "
              f"(the oracle's on every leg)")
        for key in H.BENCH_KEYS:
            require(row[key] == want[name][key],
                    f"[hpc] {name} {key} {row[key]!r} != BENCH_pr3.json's "
                    f"{want[name][key]!r}")
    bench_s = time.perf_counter() - t0
    fig = H.fig7(pkg)
    avg = fig["avg_saving_at_16pct_slowdown"]
    require(avg == H.FIG7_AVG_SAVING,
            f"[hpc] Fig 7 average saving {avg!r} != {H.FIG7_AVG_SAVING!r}")
    print(f"[hpc] Fig 7: average memory saving at <= 16 % slowdown {avg!r} "
          f"(the reference's); per workload " + ", ".join(
              f"{s['workload']} {s['best_saving_at_16pct']:.4f}"
              for s in fig["summary"]))
    print(f"[hpc] BENCH_pr3.json reproduced exactly for {len(rows)} "
          f"workloads; wall {bench_s:.1f} s for the bench loop, "
          f"{time.perf_counter() - t0:.1f} s with Fig 7 (host, numpy "
          f"{np.__version__}); {dev['smi']}")


# -- 2. build -------------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {len(built)} kernels built in "
          f"{time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{n} {s:.1f} s' for n, s in built.items())})")
    for name, (_, log) in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if re.search(r"registers|spill|bytes stack|wgmma|setmaxnreg|"
                         r"warning", line):
                print(f"[build] {name}: {line.strip()}")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build._target(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        n = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        print(f"[build] {name}: SASS " + ", ".join(
            f"{op} {k}" for op, k in n.items()))
        ops_needed = NEEDS_TENSOR_CORES.get(name, ())
        require(not ops_needed or sum(n[op] for op in ops_needed) > 0,
                f"{name}: no {' or '.join(ops_needed)} in its SASS")


# -- 3. kernels against their plain versions --------------------------------
def phase_kernel_checks(mm_data, fa_data) -> dict:
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tol = MATMUL_TOL[dtype]
        for M, K, N in MATMUL_CASES + (MATMUL_FFMA_BF16 if bf16 else []):
            x, w = rand(rng, (M, K), dtype), rand(rng, (K, N), dtype)
            got = sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                      block_k=128)
            max_err(got, matmul_ref(x, w), tol, f"matmul {M}x{K}x{N} {dtype} "
                    f"{sm._variant(dtype, K, N)}")
        tol = FLASH_TOL[dtype]
        for B, H, KV, Sq, Sk, D, Dv, causal, window in FLASH_CASES + (
                FLASH_FFMA_BF16 if bf16 else []):
            q = rand(rng, (B, H, Sq, D), dtype)
            k = rand(rng, (B, KV, Sk, D), dtype)
            v = rand(rng, (B, KV, Sk, Dv), dtype)
            got = fa.flash_attention_gpu(q, k, v, causal=causal,
                                         window=window, block_q=64,
                                         block_k=64)
            want = flash_ref(q, k, v, causal=causal, window=window)
            case = (f"flash B{B} H{H} KV{KV} Sq{Sq} Sk{Sk} D{D} Dv{Dv} "
                    f"causal={causal} window={window} {dtype} "
                    f"{fa._variant(dtype, D, Dv)}")
            max_err(got, want, tol, case)
    # the main path's full-width shapes, on the chains' own data
    x, w = mm_data
    err_mm = max_err(sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                         block_k=128),
                     matmul_ref(x, w), MATMUL_TOL[x.dtype],
                     f"matmul full width {tuple(x.shape)}@{tuple(w.shape)} "
                     f"{x.dtype} {sm._variant(x.dtype, *w.shape)}")
    # the backward (the reference's custom VJP) at full width: dx = g w^T
    # and dw = x^T g through the same kernel, against the plain version
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    g = rand(rng, (x.shape[0], w.shape[1]), x.dtype)
    sm.streaming_matmul(xg, wg).backward(g)
    max_err(xg.grad, matmul_ref(g, w.t()), MATMUL_TOL[x.dtype],
            f"matmul backward dx = g @ w^T full width {x.dtype}")
    max_err(wg.grad, matmul_ref(x.t(), g), MATMUL_TOL[x.dtype],
            f"matmul backward dw = x^T @ g full width {x.dtype}")
    del xg, wg, g
    # ROADMAP C5: a bf16 product with K = 100. Its backward's dx = g @ w^T
    # has N = 100, which the kernels compute padded to 104 zero columns
    M, K, N = MATMUL_C5
    x5 = rand(rng, (M, K), torch.bfloat16).requires_grad_(True)
    w5 = rand(rng, (K, N), torch.bfloat16).requires_grad_(True)
    g5 = rand(rng, (M, N), torch.bfloat16)
    sm.streaming_matmul(x5, w5).backward(g5)
    Np = sm.padded_columns(K, torch.bfloat16)
    max_err(x5.grad, matmul_ref(g5, w5.detach().t()), MATMUL_TOL[x5.dtype],
            f"matmul backward dx = g @ w^T, x {M}x{K} w {K}x{N} bf16 (C5: "
            f"N {K} padded to {Np}) {sm._variant(x5.dtype, N, Np)}")
    max_err(w5.grad, matmul_ref(x5.detach().t(), g5), MATMUL_TOL[x5.dtype],
            f"matmul backward dw = x^T @ g, x {M}x{K} w {K}x{N} bf16 "
            f"{sm._variant(x5.dtype, M, N)}")
    del x5, w5, g5
    q, k, v = fa_data
    err_fa = max_err(fa.flash_attention_gpu(q, k, v, causal=True,
                                            block_q=128, block_k=128),
                     flash_ref(q, k, v, causal=True), FLASH_TOL[q.dtype],
                     f"flash full width q{tuple(q.shape)} k{tuple(k.shape)} "
                     f"causal {q.dtype} "
                     f"{fa._variant(q.dtype, q.shape[3], v.shape[3])}")
    torch.cuda.synchronize()
    return {"streaming_matmul": err_mm, "flash_attention": err_fa}


def attention_skipping(q, k, v, tile: slice) -> torch.Tensor:
    """flash_ref's causal attention with the keys in ``tile`` masked out:
    what a kernel that skipped that live KV tile would output."""
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s.to(q.dtype).float() * (1.0 / math.sqrt(q.shape[-1]))
    i = torch.arange(q.shape[2], device=q.device)
    live = i[None, :] <= i[:, None]
    live[:, tile] = False
    p = torch.softmax(s.masked_fill(~live, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkv->bhqv", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def phase_planted_faults(mm_data, fa_data) -> None:
    """The full-width bound fails a kernel that skips one 128-wide tile:
    the plain version with one K-tile of w (matmul), or one KV tile for the
    rows after it (flash), left out."""
    tile = slice(2048, 2048 + 128)
    x, w = mm_data
    w_skip = w.clone()
    w_skip[tile] = 0
    faults = {
        "matmul skipping K-tile 2048:2176": outside_tolerance(
            matmul_ref(x, w_skip), matmul_ref(x, w), MATMUL_TOL[x.dtype]),
    }
    q, k, v = fa_data
    faults["flash skipping KV tile 2048:2176"] = outside_tolerance(
        attention_skipping(q, k, v, tile), flash_ref(q, k, v, causal=True),
        FLASH_TOL[q.dtype])
    for what, bad in faults.items():
        n = int(bad.sum())
        require(n > 0, f"the bound passes a planted fault: {what}")
        print(f"[fault] {what}: {n} of {bad.numel()} elements beyond the "
              f"bound, rejected")


# -- 4. the main path -------------------------------------------------------
def drive_chain(label: str, stages, x0, kernel_mod) -> dict:
    """The executor's main path over one chain; returns its numbers."""
    n = len(stages)
    zero_counts()
    passes = 0
    oracle = untiered_oracle(stages, x0)
    passes += 1
    probe = StreamingExecutor(stages, throttle=0.0)
    probe.plan_tiers(0.0)
    probe.warmup(x0)
    probe_res = probe.run(x0)
    probe.engine.close()
    passes += 2
    require(torch.equal(probe_res.output, oracle), f"{label}: probe != oracle")
    throttle = balanced_throttle(stages, probe_res.stage_compute_us)
    # which sets the pace: a stage's compute or the real copy of its bytes
    # (the probe is unpaced, so its transfers are the copies alone)
    comp = list(probe_res.stage_compute_us.values())
    copy = [us for kind, _, us in probe.engine.measurements if kind == "read"]
    comp_ms, copy_ms = sum(comp) / len(comp) / 1e3, sum(copy) / len(copy) / 1e3
    print(f"[path] {label} pace (unpaced probe): mean stage compute "
          f"{comp_ms:.4f} ms, mean real copy of one stage's "
          f"{stages[0].nbytes / 2**20:.0f} MiB {copy_ms:.4f} ms over "
          f"{len(copy)} copies; copy / compute {copy_ms / comp_ms:.3f}")

    ex = StreamingExecutor(stages, prefetch=True, throttle=throttle)
    plan = ex.plan_tiers(0.0)
    ex.warmup(x0)
    on = [ex.run(x0) for _ in range(BEST_OF)]
    ex.prefetch = False
    off = [ex.run(x0) for _ in range(BEST_OF)]
    passes += 1 + 2 * BEST_OF
    launches = counts()
    variants = dict(kernel_mod.VARIANT_LAUNCHES)
    for res in on + off:
        require(torch.equal(res.output, oracle),
                f"{label}: prefetch={res.prefetch} output != untiered oracle")
    out = oracle.float()
    require(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    mine = kernel_mod.__name__.rsplit(".", 1)[-1]
    for name, count in launches.items():
        want = passes * n if name == mine else 0
        require(count == want,
                f"{label}: {name} launched {count} times, expected {want}")
    # the chains are bf16: every launch must have taken the tensor cores
    require(variants == {"wgmma": passes * n, "ffma": 0},
            f"{label}: variants {variants}, expected every one of "
            f"{passes * n} launches through wgmma")
    best_on = min(on, key=lambda r: r.elapsed_us)
    best_off = min(off, key=lambda r: r.elapsed_us)

    # sizes around the stages' own (16 and 32 MiB), so the fit prices the
    # operating point; the runs' paced fetches are samples too
    ex.engine.measure_sweep([1 << 20, 4 << 20, 16 << 20, 64 << 20],
                            repeats=3)
    by_size: dict[tuple[str, int], list[float]] = {}
    for kind, nbytes, us in ex.engine.measurements:
        by_size.setdefault((kind, nbytes), []).append(us)
    print(f"[calib] {label} throttle {throttle:.4g}: " + "; ".join(
        f"{kind} {nbytes >> 10} KiB n={len(v)} min {min(v):.0f} "
        f"median {sorted(v)[len(v) // 2]:.0f} max {max(v):.0f} us"
        for (kind, nbytes), v in sorted(by_size.items())))
    model = FabricResource(SimClock(), ex.engine.prediction_model()).calibrate(
        ex.engine.measurements)
    sim_err = {}
    for leg, res in (("on", best_on), ("off", best_off)):
        rep = ex.simulate(compute_us=res.stage_compute_us, fabric=model,
                          prefetch=res.prefetch)
        sim_err[leg] = rep.error_vs(res.elapsed_us)
        print(f"[path] {label} prefetch {leg:>3}: elapsed "
              f"{res.elapsed_us / 1e3:.3f} ms, stall {res.stall_us / 1e3:.3f} "
              f"ms, compute {res.compute_us / 1e3:.3f} ms; simulator "
              f"{rep.predicted_us / 1e3:.3f} ms, error {sim_err[leg]:.2%}")
    ex.engine.close()
    speedup = best_off.elapsed_us / best_on.elapsed_us
    print(f"[path] {label}: {n} stages, {len(plan.remote_names())} remote "
          f"({plan.remote_bytes / 2**20:.0f} MiB streamed per pass), "
          f"throttle {throttle:.4g}, overlap speedup {speedup:.3f}x, "
          f"launches {launches}, {mine} by variant {variants}, outputs "
          f"torch.equal to the untiered oracle")
    return {"launches": launches[mine], "speedup": speedup,
            "on_ms": best_on.elapsed_us / 1e3,
            "off_ms": best_off.elapsed_us / 1e3, "sim_err": sim_err}


# -- the SSD scan: inputs, checks, planted fault -----------------------------
def ssd_chunks(rng, *, B, H, L, P, N, chunk, G):
    """The reference test's distributions (x ~ N(0,1), B and C ~ N(0,1)/2,
    dt = softplus(N(0,1)), A = -exp(N(0,1)/2)), drawn with numpy and
    chunked on the card as ``ops.ssd`` chunks them: the kernel's five
    float32 inputs."""
    def draw(shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).cuda()

    xh, Bm, Cm = draw((B, L, H, P)), draw((B, L, G, N), 0.5), draw(
        (B, L, G, N), 0.5)
    dt = torch.nn.functional.softplus(draw((B, L, H)))
    A = -torch.exp(draw((H,), 0.5))
    Q = min(chunk, L)

    def chunked(t):
        t = t.reshape(B, L // Q, Q, *t.shape[2:]).movedim(3, 1)
        return t.float().contiguous()

    rep = H // G
    return (chunked(xh), chunked(Bm.repeat_interleave(rep, dim=2)),
            chunked(Cm.repeat_interleave(rep, dim=2)), chunked(dt),
            torch.cumsum(chunked(dt * A), dim=-1))


def phase_ssd_checks(full) -> float:
    """B3 against its plain versions: the reference's cases, then at the
    path's full shape each of the three kernels against its plain stage on
    the same inputs and the scan against the one-loop oracle, all held to
    the reference's tolerance ``2e-4 + 2e-4 * |want|``. Reason for keeping
    it at full width: the kernels sum in float32 on the tensor cores in
    split TF32 (3xTF32, each product to about 2^-22 of its size), at most
    256 + 128 products per output of size O(10), in one fixed order, so
    they differ from the plain versions by a few float32 units (~1e-5 at
    most), an order of magnitude inside it; a dropped carry moves the first
    rows of the next chunk by O(1), and one TF32 pass (2^-11 a product)
    leaves the bound (``phase_ssd_fault``)."""
    rng = np.random.default_rng(2)
    for L, chunk, G in SSD_CASES:
        args = ssd_chunks(rng, B=2, H=4, L=L, P=32, N=32, chunk=chunk, G=G)
        max_err(ssd.ssd_chunk_scan_gpu(*args),
                ssd.ssd_chunk_scan_plain(*args), SSD_TOL,
                f"ssd_scan B2 H4 L{L} chunk{chunk} G{G} P32 N32 float32")
    args = ssd_chunks(rng, **SSD_RAGGED)
    max_err(ssd.ssd_chunk_scan_gpu(*args), ssd.ssd_chunk_scan_plain(*args),
            SSD_TOL, "ssd_scan ragged " + " ".join(
                f"{k}{v}" for k, v in SSD_RAGGED.items()) + " float32")
    return check_ssd_full(full, SSD_FULL)


def check_ssd_full(full, dims: dict) -> float:
    """Each of B3's three kernels against its plain stage on the same
    inputs, then the scan against the one-loop oracle, at a path's full
    shape ``dims``; the scan's max|err|."""
    shape = " ".join(f"{k}{v}" for k, v in dims.items()) + " float32"
    xc, bc, cc, dtc, cum = full
    states = ssd.ssd_chunk_state_gpu(xc, bc, dtc, cum)
    max_err(states, ssd.ssd_chunk_state_plain(xc, bc, dtc, cum), SSD_TOL,
            f"ssd kernel 1 chunk_state full width {shape}")
    entering, final = ssd.ssd_state_passing_gpu(states, cum)
    want_in, want_final = ssd.ssd_state_passing_plain(states, cum)
    max_err(entering, want_in, SSD_TOL,
            f"ssd kernel 2 state_passing (entering states) full width {shape}")
    max_err(final, want_final, SSD_TOL,
            f"ssd kernel 2 state_passing (final state) full width {shape}")
    max_err(ssd.ssd_chunk_output_gpu(xc, bc, cc, dtc, cum, entering),
            ssd.ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering),
            SSD_TOL, f"ssd kernel 3 chunk_output full width {shape}")
    del states, entering, final, want_in, want_final
    err = max_err(ssd.ssd_chunk_scan_gpu(*full),
                  ssd.ssd_chunk_scan_plain(*full), SSD_TOL,
                  f"ssd_scan (three kernels) against the one-loop oracle, "
                  f"full width {shape}")
    torch.cuda.synchronize()
    return err


def ssd_dropping_carry(xc, bc, cc, dtc, cum, drop: int) -> torch.Tensor:
    """The plain chunk loop with chunk ``drop``'s carry update left out:
    what a kernel that lost one chunk's state write would output."""
    B, H, nc, Q, P = xc.shape
    state = torch.zeros((B, H, P, bc.shape[-1]), device=xc.device)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    ys = []
    for c in range(nc):
        x, bm, cm, dt, cu = (t[:, :, c] for t in (xc, bc, cc, dtc, cum))
        lmat = torch.where(causal, torch.exp(cu[..., :, None] - cu[..., None, :])
                           * dt[..., None, :], 0.0)
        y = torch.einsum("bhij,bhjp->bhip",
                         torch.einsum("bhin,bhjn->bhij", cm, bm) * lmat, x)
        y = y + torch.einsum("bhin,bhpn->bhip", cm, state) * torch.exp(
            cu)[..., None]
        ys.append(y)
        if c != drop:
            total = cu[..., -1:]
            w = (torch.exp(total - cu) * dt)[..., None] * bm
            state = torch.exp(total)[..., None] * state + torch.einsum(
                "bhjp,bhjn->bhpn", x, w)
    return torch.stack(ys, dim=2)


def phase_ssd_fault(full) -> None:
    """Two planted faults the SSD bound must reject at full width: a lost
    carry update, and the oracle's products in single-pass TF32 (what the
    kernels would give without the split)."""
    want = ssd.ssd_chunk_scan_plain(*full)
    drop = full[0].shape[2] // 2  # a chunk with chunks after it
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one_pass = ssd.ssd_chunk_scan_plain(*full)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    faults = {
        f"ssd_scan dropping chunk {drop}'s carry update":
            ssd_dropping_carry(*full, drop=drop),
        "ssd_scan one-loop oracle in single-pass TF32": one_pass,
    }
    for what, got in faults.items():
        ratio = tolerance_ratio(got, want, SSD_TOL)
        n = int((~(ratio <= 1.0)).sum())
        require(n > 0, f"the bound passes a planted fault: {what}")
        print(f"[fault] {what}: {n} of {ratio.numel()} elements beyond the "
              f"bound (worst {ratio.max().item():.3g}x it), rejected")


# -- 5. the model paths: mamba2-130m, granite-8b, zamba2-1.2b -----------------
def timed_ms(fn):
    """(result, ms, host ms) of one call that ends with the card idle; the
    host ms is how long ``fn`` took to return, before the synchronise (when
    it is far below ms, the host ran ahead of the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3


def greedy(params, cfg, prompts, n_new: int, plan=None,
           max_len: int | None = None):
    """The serving loop written by hand: prefill token by token through
    ``decode_step``, then ``n_new`` greedy tokens, in a cache of ``max_len``
    slots (the prompt and the new tokens by default). Returns the new
    tokens and, for each decode step, its ms and its host ms
    (``timed_ms``)."""
    cache = tf.init_decode_cache(cfg, prompts.shape[0],
                                 max_len or prompts.shape[1] + n_new)
    steps, out = [], []
    logits = None
    for t in range(prompts.shape[1]):
        (logits, cache), *ms = timed_ms(lambda: tf.decode_step(
            params, cache, prompts[:, t:t + 1], cfg, plan=plan))
        steps.append(ms)
    for _ in range(n_new):
        cur = logits[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
        out.append(cur)
        (logits, cache), *ms = timed_ms(lambda: tf.decode_step(
            params, cache, cur, cfg, plan=plan))
        steps.append(ms)
    return torch.cat(out, dim=1), steps


def forward_with(params, batch, cfg, *, scan=None, flash=None):
    """``forward``'s logits with ``ops.ssd``'s chunk scan replaced by
    ``scan`` and the models' flash route to B2 by ``flash``."""
    kernels = ops.ssd_chunk_scan_gpu, mflash._b2
    ops.ssd_chunk_scan_gpu = scan or kernels[0]
    mflash._b2 = flash or kernels[1]
    try:
        return tf.forward(params, batch, cfg)[0]
    finally:
        ops.ssd_chunk_scan_gpu, mflash._b2 = kernels


def logits_diff(got, want, V: int) -> tuple[float, float, float, float]:
    """max|got - want|, max|want|, mean|got - want| over the real vocabulary,
    and the share of positions whose greedy tokens agree."""
    got, want = got[..., :V].float(), want[..., :V].float()
    diff = (got - want).abs()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return (diff.max().item(), want.abs().max().item(), diff.mean().item(),
            agree)


def widened(params):
    """The parameter tree with every tensor in float32."""
    return map_leaves(lambda _k, t: t.float(), params)


def cut_depth(params, depth: int):
    """The parameter tree with only the first ``depth`` stacked layers."""
    return {**params, "layers": map_leaves(lambda _k, t: t[:depth],
                                           params["layers"])}


def n_bytes(params) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in _leaves_with_keys(params))


def drive_placements(tag: str, cfg, params, batch,
                     fractions=(1.0, 0.5, 0.0)) -> tuple:
    """``forward`` with every weight on the card (the oracle), then with
    the weights placed by ``host_offload`` at each of ``fractions`` below
    1.0, prefetch on and off; every logits tensor ``torch.equal`` to the
    oracle. Returns (the oracle on the host, per-placement rows, forwards
    run)."""
    oracle = None  # on the host, so that no placement's peak includes it
    rows, n_fwd = {}, 0
    for mode, frac in (("none" if f == 1.0 else "host_offload", f)
                       for f in fractions):
        placed, plan = place_params(params, TieringConfig(
            mode=mode, local_fraction=frac))
        for prefetch in ((True,) if mode == "none" else (True, False)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(1 + BEST_OF):  # the first is the warm-up
                (logits, _), ms, host_ms = timed_ms(lambda: tf.forward(
                    placed, batch, cfg, prefetch=prefetch, plan=plan))
                n_fwd += 1
                runs.append((ms, host_ms))
                logits = logits.cpu()
                if oracle is None:
                    oracle = logits
                require(torch.equal(logits, oracle),
                        f"{tag} {mode} {frac} prefetch={prefetch}: logits != "
                        f"the all-local oracle")
                del logits
            label = (mode if mode == "none" else
                     f"{mode} {frac} prefetch {'on' if prefetch else 'off'}")
            local = plan.local_bytes if plan else n_bytes(params)
            remote = plan.remote_bytes if plan else 0
            best, best_host = min(runs[1:])
            rows[label] = {"ms": best, "host_ms": best_host,
                           "local_bytes": local, "remote_bytes": remote,
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2**30}
            print(f"[{tag}] forward {label}: best of {BEST_OF} {best:.3f} ms "
                  f"({best_host:.3f} ms on the host before the synchronise; "
                  f"runs {', '.join(f'{m:.3f}' for m, _ in runs)}), local "
                  f"{local / 2**20:.1f} MiB, remote {remote / 2**20:.1f} MiB,"
                  f" peak {rows[label]['peak_gib']:.3f} GiB, logits "
                  f"torch.equal to the oracle")
        del placed
    require(bool(torch.isfinite(oracle).all()), f"{tag}: non-finite logits")
    return oracle, rows, n_fwd


def step_stats(step_us: list[float]) -> str:
    """Median and min of a wave's per-step latencies (µs) in ms."""
    ms = sorted(u / 1e3 for u in step_us)
    return f"median {ms[len(ms) // 2]:.3f} ms, min {ms[0]:.3f} ms"


def engine_wave(eng, prompts: np.ndarray, n_new: int) -> tuple[np.ndarray, str]:
    """One ``generate`` wave; its tokens and a line of its step latencies
    (the engine's own ``wave_step_us``) and wall ms a step."""
    toks, wall_ms, _ = timed_ms(lambda: eng.generate(prompts, n_new))
    n = len(eng.wave_step_us)
    return toks, (f"{n} steps, engine step {step_stats(eng.wave_step_us)}, "
                  f"wall {wall_ms / n:.3f} ms a step")


def serve(tag: str, cfg, params, prompts) -> int:
    """Greedy decode of 4 prompts: all local through the port's serving
    entry point (``ServingEngine.generate``), then at host_offload 0.5
    through the hand loop (``greedy(plan=)``: the engine, like the
    reference's, does not offload parameters); the tokens must agree.
    Returns the decode steps run."""
    n_new = 16
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=prompts.shape[0], max_len=prompts.shape[1] + n_new))
    local, line = engine_wave(eng, prompts.cpu().numpy(), n_new)
    n_steps = len(eng.wave_step_us)
    print(f"[serve] {cfg.name} local (ServingEngine.generate): 4 prompts x "
          f"{prompts.shape[1]} tokens prefilled token by token, {n_new} new "
          f"each; {line}; tokens {local[0, :8].tolist()}...")
    del eng
    placed, plan = place_params(params, TieringConfig(
        mode="host_offload", local_fraction=0.5))
    toks, steps = greedy(placed, cfg, prompts, n_new, plan=plan)
    steady = sorted(steps[1:])
    host = sorted(h for _, h in steps[1:])
    print(f"[serve] {cfg.name} host_offload 0.5 (greedy): decode step median "
          f"{steady[len(steady) // 2][0]:.3f} ms (host "
          f"{host[len(host) // 2]:.3f} ms before the synchronise), min "
          f"{steady[0][0]:.3f} ms over {len(steps)} steps")
    del placed
    require(np.array_equal(local, toks.cpu().numpy()),
            f"{tag}: offloaded greedy tokens != the engine's local tokens")
    return n_steps + len(steps)


def drive_model(tag: str, cfg, per_forward: dict[str, int]) -> dict:
    """The port's model path at ``cfg``'s full width: the weights drawn on
    the card from a seed and kept on the host (each placement then holds on
    the card only what it places there), ``forward`` over 4 x 2048 tokens
    per placement, then serving. The kernels' launches over the whole path
    must be ``per_forward`` times the forwards (decode runs no kernel of
    the reference's), every flash launch through the tensor cores, and each
    SSD kernel once a scan. Returns the path's numbers, the weights (now on
    the card), the batch and the oracle's logits."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg, device="cpu")
    batch = make_batch(cfg, gen, 4, 2048)
    prompts = make_batch(cfg, gen, 4, 64)["tokens"]
    n_params = sum(t.numel() for _, t in _leaves_with_keys(params))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B parameters ({cfg.dtype}, "
          f"{n_bytes(params) / 1e9:.2f} GB), batch "
          f"{tuple(batch['tokens'].shape)}, made in "
          f"{time.perf_counter() - t0:.1f} s")

    zero_counts()
    oracle, rows, n_fwd = drive_placements(tag, cfg, params, batch)
    params = place_params(params, TieringConfig())[0]
    n_steps = serve(tag, cfg, params, prompts)
    launches = counts()
    variants = dict(fa.VARIANT_LAUNCHES)
    stages = dict(ssd.STAGE_LAUNCHES)
    print(f"[{tag}] launches over {n_fwd} forwards and {n_steps} decode "
          f"steps: {launches}; flash by variant {variants}; SSD kernels "
          f"{stages}")
    want = {name: per_forward.get(name, 0) * n_fwd for name in launches}
    require(launches == want, f"{tag}: launches {launches}, expected {want} "
                              f"({per_forward} a forward)")
    require(variants["ffma"] == 0, f"{tag}: flash launches {variants}, "
                                   f"expected every one through wgmma")
    require(all(k == launches["ssd_scan"] for k in stages.values()),
            f"{tag}: SSD kernel launches {stages}, expected each "
            f"{launches['ssd_scan']}")
    return {"launches": launches, "forwards": n_fwd, "rows": rows,
            "params": params, "batch": batch, "oracle": oracle.cuda(),
            "prompts": prompts}


def path_check(tag: str, cfg, run: dict, plain: dict, nudged: dict,
               what: str, floor_what: str, depth32: int) -> None:
    """The model's kernel forward against the same forward through the
    kernels' plain versions (``plain``: ``forward_with``'s arguments).

    In bf16 the random-weight model is chaotic: an activation that rounds
    one bf16 unit apart is carried on through every layer by the bf16
    residual stream, so any kernel that is not bit-identical to its plain
    version moves the logits by several percent. The bf16 comparison is
    printed beside its floor -- the plain forward against itself with one
    kernel's output nudged (``nudged``) -- and the check is held in float32
    (the same weights widened, cut to ``depth32`` layers where the whole
    stack would not fit the time, the same tokens), where rounding does not
    grow: within ``PATH_BOUND`` of max(1, max|logits|)."""
    V = cfg.vocab_size
    params, batch = run["params"], run["batch"]
    want = forward_with(params, batch, cfg, **plain)
    floor = forward_with(params, batch, cfg, **nudged)
    for label, got, ref in ((f"kernel forward vs {what} forward",
                             run["oracle"], want),
                            (f"floor: {what} forward vs itself with "
                             f"{floor_what}", floor, want)):
        worst, scale, mean, agree = logits_diff(got, ref, V)
        print(f"[{tag}] bf16 {label}: max|diff| {worst:.4g} "
              f"({worst / max(scale, 1.0):.4g} of max|logits| {scale:.4g}), "
              f"mean|diff| {mean:.4g}, greedy tokens agree at {agree:.2%}")
    del want, floor
    depth32 = min(depth32, cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=depth32)
    p32 = widened(cut_depth(params, depth32))
    worst, scale, mean, agree = logits_diff(
        tf.forward(p32, batch, cfg32)[0],
        forward_with(p32, batch, cfg32, **plain), V)
    require(worst <= PATH_BOUND * max(scale, 1.0),
            f"{tag} f32: {what} forward differs by {worst:.4g} > "
            f"{PATH_BOUND} x max(1, {scale:.4g})")
    print(f"[{tag}] float32 kernel forward vs {what} forward, {depth32} of "
          f"{cfg.n_layers} layers: max|diff| {worst:.4g} "
          f"({worst / max(scale, 1.0):.4g} of max|logits| {scale:.4g}; bound "
          f"{PATH_BOUND}), mean|diff| {mean:.4g}, greedy tokens agree at "
          f"{agree:.2%}")


def nudged_kernels(seed: int = 5) -> dict:
    """Plain versions with their output perturbed, for the bf16 floors:
    the SSD scan's float32 y moved by relative noise of 2^-24 (float32's
    own rounding) before the model rounds it to bf16; the flash's bf16
    output moved by 2^-9 (a quarter to a half of a bf16 unit) and rounded
    again, so that some of its elements move by one unit."""
    noise = torch.Generator(device="cuda").manual_seed(seed)

    def scan(*chunks):
        y = ssd.ssd_chunk_scan_plain(*chunks)
        return y + y * (2.0 ** -24 * torch.randn(
            y.shape, generator=noise, device=y.device))

    def flash(q, k, v, **kw):
        o = mflash.blocked_flash(q, k, v, **kw)
        return (o.float() * (1.0 + 2.0 ** -9 * torch.randn(
            o.shape, generator=noise, device=o.device))).to(o.dtype)

    return {"scan": scan, "flash": flash}


def decode_vs_forward(tag: str, cfg, depth: int, n_tok: int = 512, *,
                      params=None, lanes: int = 2,
                      moe_groups: int | None = None) -> None:
    """The reference's decode-matches-forward contract at full width in
    float32, ``depth`` layers (a moe model keeps at least one MoE layer):
    token-by-token decode over ``lanes`` x ``n_tok`` tokens against the
    forward, max|diff| < 1e-3 x max(1, max|logits|). ``params`` are float32
    weights at that depth (drawn here when None); ``moe_groups`` the
    decode's MoE dispatch groups."""
    depth = min(depth, cfg.n_layers)
    cfg32 = dataclasses.replace(
        cfg, dtype=torch.float32, n_layers=depth,
        first_k_dense=min(cfg.first_k_dense, depth - 1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p32 = params if params is not None else tf.init_params(gen, cfg32)
    tok = make_batch(cfg32, gen, lanes, n_tok)["tokens"]
    full, _ = tf.forward(p32, {"tokens": tok}, cfg32)
    cache = tf.init_decode_cache(cfg32, lanes, n_tok)
    errs = torch.zeros((), device="cuda")
    for t in range(n_tok):
        lg, cache = tf.decode_step(p32, cache, tok[:, t:t + 1], cfg32,
                                   moe_groups=moe_groups)
        errs = torch.maximum(errs, (lg[:, 0] - full[:, t]).abs().max())
    scale = full[..., :cfg.vocab_size].abs().max().item()
    err = errs.item()
    require(err < PATH_BOUND * max(scale, 1.0),
            f"{tag} f32: decode drifts from forward by {err:.4g} (scale "
            f"{scale:.4g})")
    print(f"[{tag}] float32 decode vs forward, {depth} of {cfg.n_layers} "
          f"layers, over {lanes} x {n_tok} tokens: max|diff| {err:.4g} < "
          f"1e-3 x max(1, {scale:.4g})")


def decode_past_the_cache(tag: str, cfg, params, S: int = 16) -> None:
    """ROADMAP C6 on the card, at full width: fill a 4-lane cache of ``S``
    slots, then one scalar step at pos ``S`` (it must rewrite only slot
    ``S - 1``) and one per-lane step with lane 0 at ``S + 5`` (its rows
    must stay ``torch.equal`` to what they were, the other lanes write
    their slots). Each step is synchronised at once, so a device-side
    assert fails here."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    tok = make_batch(cfg, gen, 4, S + 2)["tokens"]
    cache = tf.init_decode_cache(cfg, 4, S)
    for t in range(S):
        _, cache = tf.decode_step(params, cache, tok[:, t:t + 1], cfg)
    torch.cuda.synchronize()
    before = {k: cache[k].clone() for k in ("k", "v")}
    logits, cache = tf.decode_step(params, cache, tok[:, S:S + 1], cfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    for k in ("k", "v"):
        require(torch.equal(cache[k][:, :, :S - 1], before[k][:, :, :S - 1]),
                f"{tag}: a scalar step at pos {S} wrote below slot {S - 1}")
        require(not torch.equal(cache[k][:, :, S - 1], before[k][:, :, S - 1]),
                f"{tag}: a scalar step at pos {S} left slot {S - 1} as it was")
    lanes = [S + 5, 3, 7, S - 1]
    cache["pos"] = torch.tensor(lanes, dtype=torch.int32, device="cuda")
    before = {k: cache[k].clone() for k in ("k", "v")}
    logits, cache = tf.decode_step(params, cache, tok[:, S + 1:S + 2], cfg)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    for k in ("k", "v"):
        require(torch.equal(cache[k][:, 0], before[k][:, 0]),
                f"{tag}: lane 0 at pos {S + 5} changed its cache rows")
        for b, pos in enumerate(lanes[1:], start=1):
            require(not torch.equal(cache[k][:, b, pos], before[k][:, b, pos]),
                    f"{tag}: lane {b} did not write slot {pos}")
    print(f"[{tag}] {cfg.name} decode past a {S}-slot cache on the card: a "
          f"scalar step at pos {S} wrote only slot {S - 1}; a per-lane step "
          f"at {lanes} left lane 0's rows torch.equal and wrote the others; "
          f"no device assert")


def as_bytes(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bytes on the host, as uint16."""
    return t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)


def device_per_step(label: str, fn, n_steps: int, step_ms: float) -> dict:
    """``fn`` (``n_steps`` decode steps) under ``torch.profiler``: the
    device time summed over kernels and the kernels, per step, beside the
    step's time measured without the profiler (``step_ms``, which the
    profiler would inflate); the host's share is 1 - device / step."""
    wall, kernels = profiled(fn)
    dev_ms = sum(ms for ms, _ in kernels.values()) / n_steps
    launches = sum(n for _, n in kernels.values()) / n_steps
    require(dev_ms > 0, f"[engine] {label}: the profiler recorded no device "
                        f"time")
    print(f"[engine] {label} under the profiler: device {dev_ms:.3f} ms a "
          f"step (sum of kernels), {launches:.1f} kernels a step, profiled "
          f"wall {wall / n_steps:.3f} ms a step; against the unprofiled "
          f"step of {step_ms:.3f} ms the host's share is "
          f"{max(0.0, 1 - dev_ms / step_ms):.2%}")
    return {"device_ms": dev_ms, "kernels": launches}


def phase_engine(cfg, params, prompts, smi: str) -> dict:
    """granite-8b at full width through the port's serving layer: two
    ``generate`` waves with a ``reset`` between, tokens equal to the hand
    loop's; an engine whose budget demotes the caches into a 2-node pool
    with 2 replicas, tokens equal and the pool's bf16 payloads the cache's
    bytes; a ``ContinuousScheduler`` in lane mode over that engine (two
    tenants, requests joining mid-stream), each request's tokens equal to
    it run alone through a fresh lane-mode engine; the steps timed and
    profiled; then ``launch.serve --full``. Returns each kernel's
    launches over the phase (decode runs none of them)."""
    zero_counts()
    P = prompts.shape[1]
    host_prompts = prompts.cpu().numpy()

    def hand_loop(turn: int) -> np.ndarray:
        toks, steps = greedy(params, cfg, prompts, ENGINE_NEW,
                             max_len=ENGINE["max_len"])
        ms = sorted(m for m, _ in steps)
        print(f"[engine] hand loop (greedy, synchronised each step), turn "
              f"{turn}: {len(ms)} steps, median {ms[len(ms) // 2]:.3f} ms, "
              f"min {ms[0]:.3f} ms")
        return toks.cpu().numpy()

    # in turns on one card: hand loop, engine, engine, hand loop
    want = hand_loop(0)
    eng = ServingEngine(cfg, params, EngineConfig(**ENGINE))
    steps_ms = []
    for wave in range(2):
        if wave:
            eng.reset()
        toks, line = engine_wave(eng, host_prompts, ENGINE_NEW)
        require(np.array_equal(toks, want),
                f"[engine] wave {wave}: tokens != the hand loop's")
        steps_ms += [u / 1e3 for u in eng.wave_step_us]
        print(f"[engine] {cfg.name} generate wave {wave} (max_batch "
              f"{ENGINE['max_batch']}, max_len {ENGINE['max_len']}): 4 "
              f"prompts x {P} + {ENGINE_NEW} new: {line}; tokens equal to "
              f"the hand loop's")
    require(np.array_equal(hand_loop(1), want),
            "[engine] the hand loop's tokens moved between turns")
    step_ms = sorted(steps_ms)[len(steps_ms) // 2]
    eng.reset()
    device_per_step(
        f"{cfg.name} generate", lambda: eng.generate(host_prompts[:, :8], 8),
        PROFILE_STEPS, step_ms)

    tiered = ServingEngine(cfg, params, EngineConfig(**ENGINE, **ENGINE_TIERED))
    demoted = tiered._demoted_cache_names()
    require({"cache['k']", "cache['v']"} <= set(demoted),
            f"[engine] the budget demoted {demoted}, not the K and V caches")
    toks, line = engine_wave(tiered, host_prompts, ENGINE_NEW)
    require(np.array_equal(toks, want), "[engine] tiered tokens != untiered")
    for key in ("k", "v"):
        got = tiered.pool.payload(f"cache['{key}']")
        require(got.dtype == np.uint16
                and np.array_equal(got, as_bytes(tiered.cache[key]))
                and bool(got.any()),
                f"[engine] the pool's cache['{key}'] != the cache's bf16 bytes")
    summary = tiered.placement_summary()
    require(summary["offload_memory_kind"] == "pinned_host",
            f"[engine] offload_memory_kind {summary['offload_memory_kind']}")
    pool = tiered.pool.stats()
    print(f"[engine] tiered (budget {ENGINE_TIERED['hbm_budget_bytes']} B, "
          f"pool 2 nodes x 2 replicas): {line}; tokens equal to the "
          f"untiered engine's; pool payloads of {demoted} equal to the bf16 "
          f"cache's bytes ({pool['bytes_written']} B written); "
          f"placement_summary {summary}")

    lanes = phase_lanes(cfg, params, tiered)
    out = launch_serve.main(["--arch", cfg.name, "--full"])
    print(f"[engine] launch.serve --arch {cfg.name} --full: "
          f"{out['tokens']} tokens in {out['seconds']:.3f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s batched; {smi}")
    launches = counts()
    require(all(n == 0 for n in launches.values()),
            f"[engine] launches {launches}: decode runs no kernel of the "
            f"reference's")
    return {"launches": launches, "step_ms": step_ms, **lanes}


def phase_lanes(cfg, params, eng) -> dict:
    """Continuous batching over ``eng`` (switched to lane mode): two
    tenants' requests join in pairs while earlier ones decode; mid-run one
    tenant's lanes are offloaded to its pool arena (bf16 bytes checked).
    Every request's tokens must equal the same request run alone through a
    fresh lane-mode engine with the same ``max_batch``. No admission pass
    runs (``readvise_every=0``): at this width the simulator replays 16 GB
    of objects a pass; ``[serving-bench]`` holds admission on the card."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompts = make_batch(cfg, gen, LANE_REQUESTS, LANE_PROMPT)["tokens"]
    reqs = [Request(tenant=("acme", "blue")[i % 2],
                    prompt=prompts[i].cpu().numpy(), max_new=LANE_NEW)
            for i in range(LANE_REQUESTS)]
    sched = ContinuousScheduler(eng, SchedulerConfig(readvise_every=0))
    ids = []
    for pair in range(LANE_REQUESTS // 2):
        ids += [sched.submit(dataclasses.replace(r))
                for r in reqs[2 * pair:2 * pair + 2]]
        for _ in range(5):
            sched.step()
        if pair == 1:
            held = sorted(sched.tenants["acme"].lanes)
            eng.offload_tenant_kv("acme", held)
            for key in ("k", "v"):
                got = eng.pool.payload(f"kv:acme:cache['{key}']")
                require(np.array_equal(
                    got, as_bytes(eng.cache[key][:, held])),
                    f"[engine] acme's pool cache['{key}'] != its lanes' bytes")
    sched.drain(max_steps=1000)
    got = {r["request_id"]: r["tokens"]
           for rs in sched.results().values() for r in rs}
    require(sorted(got) == sorted(ids), f"[engine] completed {sorted(got)}")

    oracle_eng = ServingEngine(cfg, params, EngineConfig(**ENGINE))
    oracle = ContinuousScheduler(oracle_eng, SchedulerConfig(readvise_every=0))
    for rid, req in zip(ids, reqs):
        one = oracle.submit(dataclasses.replace(req))
        oracle.drain(max_steps=1000)
        alone = oracle.tenants[req.tenant].completed[-1]["tokens"]
        require(np.array_equal(got[rid], alone),
                f"[engine] lane tokens of {rid} != the request alone ({one})")
    lat = sched.latency_stats()
    print(f"[engine] lanes: {LANE_REQUESTS} requests of 2 tenants "
          f"({LANE_PROMPT}-token prompts, {LANE_NEW} new) joining in pairs, "
          f"{sched._step_id} shared steps, acme's lanes {held} offloaded to "
          f"its pool arena (bytes equal); every request's tokens equal to "
          f"it alone through a fresh lane-mode engine; decode_lanes step "
          f"p50 " + ", ".join(f"{t} {s['p50_step_us'] / 1e3:.3f} ms"
                               for t, s in lat.items()))

    feed = np.zeros(ENGINE["max_batch"], np.int32)
    step_us = [oracle_eng.decode_lanes(feed)[1] for _ in range(PROFILE_STEPS)]
    step_ms = sorted(step_us)[len(step_us) // 2] / 1e3
    print(f"[engine] decode_lanes alone: {step_stats(step_us)} over "
          f"{PROFILE_STEPS} steps (its step_us ends with the host copy of "
          f"the tokens)")

    def lane_steps():
        for _ in range(PROFILE_STEPS):
            oracle_eng.decode_lanes(feed)

    prof = device_per_step("decode_lanes", lane_steps, PROFILE_STEPS, step_ms)
    return {"lane_step_ms": step_ms, "lane_device_ms": prof["device_ms"]}


def phase_serving_bench(dev: dict) -> None:
    """``benchmarks/fig_autoscale.py``'s and ``fig_serving_mt.py``'s loops
    through the port, the reduced granite-8b engine in float32 on the card:
    ``BENCH_pr5.json``'s and ``BENCH_pr9.json``'s values exactly (their
    wall-clock ``latency_us`` printed, not compared). The loops require
    autoscaled tokens equal to an untiered engine's and every lane's tokens
    equal to the sequential oracle's."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_serving_parity as S

    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    pkg = S.package("repro_torch")
    t0 = time.perf_counter()
    auto = S.fig_autoscale(pkg, cfg, params)["autoscale"]
    bad = S.bench_mismatches(auto, "BENCH_pr5")
    require(not bad, f"[serving-bench] BENCH_pr5.json differs at {bad}: "
                     f"{auto}")
    print(f"[serving-bench] fig_autoscale on the card: BENCH_pr5.json "
          f"exactly: nodes {auto['nodes_trajectory']}, max_degradation "
          f"{auto['max_degradation']!r}, mean_saving {auto['mean_saving']!r},"
          f" {auto['n_readvise']} re-advises, {auto['migrated_extents']} "
          f"migrated extents; tokens autoscaled == untiered; "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    mt = S.fig_serving_mt(pkg, cfg, params)["serving_mt"]
    bad = S.bench_mismatches(mt, "BENCH_pr9")
    require(not bad, f"[serving-bench] BENCH_pr9.json differs at {bad}: {mt}")
    print(f"[serving-bench] fig_serving_mt on the card: BENCH_pr9.json "
          f"exactly (latency_us aside): nodes {mt['nodes_trajectory']}, shed "
          f"{mt['shed_events']}, completed {mt['completed']}, "
          f"max_admitted_degradation {mt['max_admitted_degradation']!r}, "
          f"{mt['n_readvise']} admission passes, bit_identical "
          f"{mt['bit_identical']}; latency_us (wall clock, not compared) "
          f"{mt['latency_us']}; {time.perf_counter() - t1:.1f} s; "
          f"{dev['smi']}")


def phase_mamba() -> dict:
    """mamba2-130m, all 24 layers: 24 SSD scans a forward; the path checked
    against the plain SSD, and decode against forward at full depth."""
    cfg = MAMBA2_130M
    run = drive_model("mamba", cfg, {"ssd_scan": cfg.n_layers})
    nudged = nudged_kernels()
    path_check("mamba", cfg, run, {"scan": ssd.ssd_chunk_scan_plain},
               {"scan": nudged["scan"]}, "plain-SSD",
               "y nudged by 2^-24", cfg.n_layers)
    del run["params"], run["batch"], run["oracle"]
    decode_vs_forward("mamba", cfg, cfg.n_layers)
    return run


def phase_dense(smi: str) -> dict:
    """granite-8b at full width: 36 B2 launches a forward (B4 H32 KV8 S2048
    D128 causal); the path checked against the plain flash in float32 on 8
    layers, the serving layer driven at full width (``[engine]``), and
    decode against forward on 2 layers."""
    cfg = GRANITE_8B
    run = drive_model("dense", cfg, {"flash_attention": cfg.n_layers})
    path_check("dense", cfg, run, {"flash": mflash.blocked_flash},
               {"flash": nudged_kernels()["flash"]}, "plain-flash",
               "the attention output nudged by 2^-9", 8)
    decode_past_the_cache("c6", cfg, run["params"])
    run["engine"] = phase_engine(cfg, run["params"], run["prompts"], smi)
    del run["params"], run["batch"], run["oracle"]
    torch.cuda.empty_cache()
    decode_vs_forward("dense", cfg, 2)
    return run


def phase_hybrid() -> dict:
    """zamba2-1.2b at full width: 38 SSD scans (B4 H64 L2048 P64 N64) and 6
    B2 launches (B4 H32 KV32 S2048 D64 causal) a forward; the path checked
    against the plain flash and SSD in float32 on all 38 layers, and decode
    against forward on 12 (two passes through the shared block)."""
    cfg = ZAMBA2_1_2B
    run = drive_model("hybrid", cfg, {
        "ssd_scan": cfg.n_layers,
        "flash_attention": cfg.n_layers // cfg.hybrid_attn_every})
    nudged = nudged_kernels()
    path_check("hybrid", cfg, run,
               {"scan": ssd.ssd_chunk_scan_plain, "flash": mflash.blocked_flash},
               {"scan": nudged["scan"], "flash": mflash.blocked_flash},
               "plain-flash and plain-SSD", "the SSD's y nudged by 2^-24",
               cfg.n_layers)
    del run["params"], run["batch"], run["oracle"]
    torch.cuda.empty_cache()
    decode_vs_forward("hybrid", cfg, 2 * cfg.hybrid_attn_every)
    return run


# -- [moe]: deepseek-v3 and mixtral-8x7b -----------------------------------------
def mem_available_gb() -> float:
    """The host's ``MemAvailable`` (``/proc/meminfo``) in GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise SystemExit("chip_smoke FAILED: no MemAvailable in /proc/meminfo")


def release_memory() -> None:
    """Return freed device blocks and the pinned host blocks that
    PyTorch's host allocator caches (a paged full-width MoE layer pins
    22.5 GB) to the system."""
    gc.collect()
    torch.cuda.empty_cache()
    host_empty_cache = getattr(torch._C, "_host_emptyCache", None)
    if host_empty_cache is not None:
        host_empty_cache()


def is_expert_leaf(name: str) -> bool:
    return "['moe']['w_" in name


def moe_paged_wave(cfg, params, host_prompts, want, want_cache: dict,
                   resident: int, ecfg: dict) -> str:
    """One ``generate`` wave through an engine whose routed experts are
    paged (``resident`` of ``n_experts`` a layer in the assembled view);
    its tokens must equal ``want`` and every leaf of its cache
    ``want_cache``, the untiered engine's (every layer's K/V or latent at
    every position: the whole computation, where random weights may give
    few distinct tokens). Returns the report line."""
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, EngineConfig(
        **ecfg, expert_paging=ExpertPagingConfig(resident_max=resident)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    toks, line = engine_wave(eng, host_prompts, MOE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(np.array_equal(toks, want),
            f"[moe] {cfg.name}: paged tokens != the untiered engine's")
    for key, leaf in want_cache.items():
        require(torch.equal(eng.cache[key], leaf),
                f"[moe] {cfg.name}: the paged engine's cache['{key}'] != "
                f"the untiered engine's")
    store = eng.expert_store
    st = store.stats()
    store.close()
    out = (f"resident {resident} of {cfg.n_experts} a layer "
           f"({cfg.n_experts / resident:.0f}x oversubscribed), "
           f"{st['n_moe_layers'] * cfg.n_experts} slabs of "
           f"{st['slab_bytes'] / 1e6:.1f} MB in a 1-node pool (set-up "
           f"{setup_s:.1f} s: the pinned host copy and the pool's "
           f"registration); {line}; tokens and every cache leaf "
           f"({', '.join(sorted(want_cache))}) equal to the untiered "
           f"engine's; "
           f"hit rate {st['hit_rate']!r} ({st['hits']} hits, {st['misses']} "
           f"misses), {st['sync_fetches']} sync fetches (against "
           f"{st['misses']} misses), {st['prefetch_commits']} prefetch "
           f"commits, {st['bytes_fetched']} B fetched by the ledger and "
           f"{store.copy_bytes} B over the copy stream; simulated stall "
           f"{st['sim_stall_us']!r} us over compute {st['sim_compute_us']!r}"
           f" us = degradation {st['degradation']!r}; peak {peak:.3f} GiB")
    del eng, store
    gc.collect()
    return out


def drive_moe(name: str, spec: dict, smi: str) -> dict:
    """One MoE configuration at full width, depth cut to ``spec``: the
    weights drawn on the card; ``forward`` over 4 x 2048 tokens all local
    and at host_offload 0.5 (the routed experts demoted first), prefetch on
    and off, logits ``torch.equal``; B2 once a layer a forward, all on the
    tensor cores; serving 4 prompts of 64 tokens and 16 new through
    ``ServingEngine.generate`` untiered, then with the experts paged (tokens
    equal); then, in float32 at ``depth32``, the path check against the
    models' plain flash and decode against forward without drops."""
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
    n_moe = cfg.n_layers - cfg.first_k_dense
    expert_1 = full.n_experts * 3 * full.d_model * full.moe_d_ff
    attn = (f"MLA (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
            f"head dims {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, v "
            f"{cfg.v_head_dim})" if cfg.attention == "mla" else
            f"GQA {cfg.n_kv_heads} KV heads, window {cfg.sliding_window}")
    print(f"[moe] {name} at full width: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {attn}, {cfg.n_experts} routed experts "
          f"top-{cfg.top_k} of d_ff {cfg.moe_d_ff} + {cfg.n_shared_experts} "
          f"shared, dense d_ff {cfg.d_ff}, vocab {cfg.vocab_size}. The "
          f"config counts {full.param_count() / 1e9:.1f} B parameters, "
          f"{2 * full.param_count() / 1e9:.0f} GB in bf16, over "
          f"{full.n_layers} layers (one MoE layer's routed experts "
          f"{expert_1 / 1e9:.2f} B, {2 * expert_1 / 1e9:.1f} GB) against the "
          f"card's 80 GB, so the depth is cut to {cfg.n_layers} layers "
          f"({cfg.first_k_dense} dense + {n_moe} MoE"
          f"{' + the mtp block' if cfg.mtp_depth else ''}): "
          f"{cfg.param_count() / 1e9:.2f} B counted, "
          f"{2 * cfg.param_count() / 1e9:.1f} GB; host MemAvailable "
          f"{mem_available_gb():.1f} GB")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init_params(gen, cfg)
    batch = make_batch(cfg, gen, 4, 2048)
    prompts = make_batch(cfg, gen, 4, MOE_PROMPT)["tokens"]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves_with_keys(params))
    print(f"[moe] {name}: drew {n_params / 1e9:.4f} B parameters "
          f"({n_bytes(params) / 1e9:.2f} GB, {cfg.dtype}) on the card in "
          f"{time.perf_counter() - t0:.1f} s; batch "
          f"{tuple(batch['tokens'].shape)}")
    plan = plan_for_params(params, config=TieringConfig(
        mode="host_offload", local_fraction=0.5))
    remote = plan.remote_names()
    require(remote and all(is_expert_leaf(n) for n in remote),
            f"[moe] {name}: host_offload 0.5 demotes {remote}, not the "
            f"routed experts first")
    print(f"[moe] {name}: host_offload 0.5 demotes {remote} "
          f"({plan.remote_bytes / 1e9:.2f} GB), the routed experts first")

    zero_counts()
    _, rows, n_fwd = drive_placements(f"moe {name}", cfg, params, batch,
                                      fractions=(1.0, 0.5))
    host_prompts = prompts.cpu().numpy()
    ecfg = dict(max_batch=4, max_len=MOE_PROMPT + MOE_NEW)
    eng = ServingEngine(cfg, params, EngineConfig(**ecfg))
    torch.cuda.reset_peak_memory_stats()
    want, line = engine_wave(eng, host_prompts, MOE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_cache = eng.cache
    del eng
    print(f"[moe] {name} untiered ServingEngine.generate: 4 prompts x "
          f"{MOE_PROMPT} + {MOE_NEW} new: {line}; peak {peak:.3f} GiB; "
          f"tokens {want[0, :8].tolist()}...")
    print(f"[moe] {name} paged ServingEngine.generate: " + moe_paged_wave(
        cfg, params, host_prompts, want, want_cache, spec["resident"],
        ecfg))
    del want_cache
    launches = counts()
    variants = dict(fa.VARIANT_LAUNCHES)
    print(f"[moe] {name} launches over {n_fwd} forwards and 2 served "
          f"waves: {launches}; flash by variant {variants}")
    want_l = {k: (cfg.n_layers * n_fwd if k == "flash_attention" else 0)
              for k in launches}
    require(launches == want_l, f"[moe] {name}: launches {launches}, "
                                f"expected {want_l} (B2 once a layer)")
    require(variants["ffma"] == 0, f"[moe] {name}: flash launches "
                                   f"{variants}, expected all wgmma")
    del params, batch, prompts
    release_memory()

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                n_layers=spec["depth32"],
                                first_k_dense=spec["dense32"], mtp_depth=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = tf.init_params(gen, cfg32)
    batch32 = make_batch(cfg32, gen, 2, 2048)
    worst, scale, mean, agree = logits_diff(
        tf.forward(p32, batch32, cfg32)[0],
        forward_with(p32, batch32, cfg32, flash=mflash.blocked_flash),
        cfg.vocab_size)
    require(worst <= PATH_BOUND * max(scale, 1.0),
            f"[moe] {name} f32: plain-flash forward differs by {worst:.4g} "
            f"> {PATH_BOUND} x max(1, {scale:.4g})")
    print(f"[moe] {name} float32 kernel forward (B2's FFMA kernel) vs "
          f"plain-flash forward, 2 x 2048 tokens at {cfg32.n_layers} of "
          f"{full.n_layers} layers ({cfg32.first_k_dense} dense + "
          f"{cfg32.n_layers - cfg32.first_k_dense} MoE, "
          f"{n_bytes(p32) / 1e9:.1f} GB of float32 weights, the depth that "
          f"fits the card): max|diff| {worst:.4g} "
          f"({worst / max(scale, 1.0):.4g} of max|logits| {scale:.4g}; bound "
          f"{PATH_BOUND}), mean|diff| {mean:.4g}, greedy tokens agree at "
          f"{agree:.2%}")
    del batch32
    decode_vs_forward(f"moe {name}", dataclasses.replace(
        full, capacity_factor=8.0), spec["depth32"], spec["tokens32"],
        params=p32, lanes=spec["lanes32"], moe_groups=1)
    del p32
    release_memory()
    print(f"[moe] {name}: host MemAvailable {mem_available_gb():.1f} GB "
          f"after the phase")
    return {"launches": launches, "rows": rows, "forwards": n_fwd}


def phase_moe(smi: str) -> dict:
    """``[moe]``: each configuration of ``MOE_MODELS`` through
    :func:`drive_moe`; returns its numbers by name."""
    t0 = time.perf_counter()
    out = {name: drive_moe(name, spec, smi)
           for name, spec in MOE_MODELS.items()}
    print(f"[moe] wall {time.perf_counter() - t0:.1f} s; {smi}")
    return out


# -- 6. kernel times ----------------------------------------------------------
def phase_times(mm_data, fa_data, ssd_data) -> dict:
    x, w = mm_data
    M, K = x.shape
    N = w.shape[1]
    mm_bound, mm_by = bound(2.0 * M * N * K,
                            (M * K + K * N + M * N) * x.element_size(),
                            PEAK_FLOPS[x.dtype])
    mm = {
        "variant": sm._variant(x.dtype, K, N),
        "ms": time_ms(lambda: sm.streaming_matmul(
            x, w, block_m=128, block_n=128, block_k=128), 20),
        "ffma_ms": time_ms(lambda: sm._launch(x, w, variant="ffma"), 5),
        "plain_ms": time_ms(lambda: matmul_ref(x, w), 20),
        "library_ms": time_ms(lambda: torch.matmul(x, w), 20),
        "bound_ms": mm_bound, "bound_by": mm_by,
    }
    q, k, v = fa_data
    D, Dv = q.shape[3], v.shape[3]
    fa_bound, fa_by = flash_bound(q, k, v)
    k_rep, v_rep = gqa_repeated(q, k, v)  # outside the timed region
    fa_t = {
        "variant": fa._variant(q.dtype, D, Dv),
        "ms": time_ms(lambda: fa.flash_attention_gpu(
            q, k, v, causal=True, block_q=128, block_k=128), 10),
        "ffma_ms": time_ms(lambda: fa._launch(
            q, k, v, causal=True, window=None, scale=1.0 / math.sqrt(D),
            variant="ffma"), 3),
        "plain_ms": time_ms(lambda: flash_ref(q, k, v, causal=True), 3),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=True), 10),
        "bound_ms": fa_bound, "bound_by": fa_by,
    }
    xc, bc, cc, dtc, cum = ssd_data
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    ssd_t = ssd_times(ssd_data)
    ssd_flops, ssd_bytes = ssd_work(ssd_data)
    # the three kernels alone, on preallocated outputs and scratch
    dims = (B * H, nc, Q, P, N)
    states = torch.empty((B, H, nc, P, N), device="cuda")
    y = torch.empty_like(xc)

    def stage(entry, *tensors):
        return lambda: ssd._call(entry, tensors, dims, xc.device)

    stage_ms = {"chunk_state": time_ms(stage(
        "ssd_chunk_state", xc, bc, dtc, cum, states), 10)}
    # in place: each run passes the last one's entering states on again
    stage_ms["state_passing"] = time_ms(stage(
        "ssd_state_passing", states, cum, None), 10)
    stage("ssd_chunk_state", xc, bc, dtc, cum, states)()
    stage("ssd_state_passing", states, cum, None)()
    stage_ms["chunk_output"] = time_ms(stage(
        "ssd_chunk_output", xc, bc, cc, dtc, cum, states, y), 10)
    scratch = states.numel() * 4
    del states, y
    prep_ms = ssd_prep_ms(SSD_FULL)
    out = {"streaming_matmul": mm, "flash_attention": fa_t, "ssd_scan": ssd_t}
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        other = (f" (ffma on the same inputs {t['ffma_ms']:.4f})"
                 if "ffma_ms" in t else "")
        print(f"[time] {name}: kernel_ms {t['ms']:.4f} {t['variant']}{other}, "
              f"plain_ms {t['plain_ms']:.4f}, library_ms {lib}, "
              f"bound_ms {t['bound_ms']:.4f} ({t['bound_by']}), roofline "
              f"share {t['bound_ms'] / t['ms']:.2%}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[time] ssd_scan bound: {ssd_flops / 1e9:.2f} GFLOP; at the "
          f"instruction used (TF32 mma.sync, {TF32_PASSES} passes, "
          f"{PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s) "
          f"{TF32_PASSES * ssd_flops / PEAK_FLOPS['tf32'] * 1e3:.4f} ms; on "
          f"the CUDA cores' float32 ({PEAK_FLOPS[torch.float32] / 1e12:.0f} "
          f"TFLOP/s) {ssd_flops / PEAK_FLOPS[torch.float32] * 1e3:.4f} ms; "
          f"{ssd_bytes / 1e6:.1f} MB of inputs and output "
          f"{ssd_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; beside them the "
          f"scratch state, {scratch / 1e6:.1f} MB written, read and written, "
          f"read ({scratch * (3 + (nc - 1) / nc) / 1e6:.1f} MB, "
          f"{scratch * (3 + (nc - 1) / nc) / HBM_BYTES_PER_S * 1e3:.4f} ms); "
          f"blocks: chunk state {nc * B * H}, state passing "
          f"{-(-P * N // 256) * B * H}, chunk output "
          f"{-(-Q // 64) * nc * B * H}, on {sms} SMs")
    print(f"[time] ssd_scan kernels alone: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f" (sum {sum(stage_ms.values()):.4f})")
    print(f"[time] ssd prep (ops.ssd_prep, bf16 x/B/C of B{B} L{nc * Q} "
          f"H{H} P{P} G{SSD_FULL['G']} N{N}): {prep_ms:.4f} ms")
    return out


def flash_bound(q, k, v) -> tuple[float, str]:
    """B2's bound for causal self-attention over (B, H, S, D) q: the live
    (causal) pairs' two products at the card's rate for q's type, or each
    input read and the output written once."""
    B, H, S, D = q.shape
    Dv = v.shape[3]
    live_pairs = S * (S + 1) / 2          # causal, Sq == Sk
    return bound(B * H * live_pairs * 2.0 * (D + Dv),
                 (q.numel() + k.numel() + v.numel() + B * H * S * Dv)
                 * q.element_size(), PEAK_FLOPS[q.dtype])


def gqa_repeated(q, k, v):
    """k and v with each KV head repeated for its query heads, for SDPA."""
    G = q.shape[1] // k.shape[1]
    return k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)


def ssd_work(ssd_data) -> tuple[float, int]:
    """The SSD scan's operations and bytes: per (b, h, chunk) the causal
    half of C B^T and of its product with x, then C S^T and the carry
    x^T (w o B); the five float32 inputs read and y written once."""
    xc, bc = ssd_data[0], ssd_data[1]
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    live = Q * (Q + 1) / 2
    flops = B * H * nc * (2.0 * live * (N + P) + 4.0 * Q * N * P)
    return flops, sum(t.numel() for t in ssd_data + (xc,)) * 4


def ssd_times(ssd_data) -> dict:
    flops, nbytes = ssd_work(ssd_data)
    # at the rate of the instruction the kernels use: mma.sync in TF32,
    # three passes a product (3xTF32)
    ssd_bound, ssd_by = bound(TF32_PASSES * flops, nbytes, PEAK_FLOPS["tf32"])
    return {
        "variant": "mma_tf32x3",  # three kernels, mma.sync in split TF32
        "ms": time_ms(lambda: ssd.ssd_chunk_scan_gpu(*ssd_data), 10),
        "plain_ms": time_ms(lambda: ssd.ssd_chunk_scan_plain(*ssd_data), 3),
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "bound_ms": ssd_bound, "bound_by": ssd_by,
    }


def ssd_prep_ms(dims: dict) -> float:
    """``ops.ssd_prep``, the prep in front of the kernels, from a layer's
    own tensors at ``dims``: x, B and C in bf16, B and C repeated per head
    (G = 1)."""
    rng = torch.Generator(device="cuda").manual_seed(4)
    B, L, H, P, N, G = (dims[k] for k in ("B", "L", "H", "P", "N", "G"))
    xh = torch.randn((B, L, H, P), generator=rng, device="cuda").bfloat16()
    Bm, Cm = (torch.randn((B, L, G, N), generator=rng, device="cuda")
              .bfloat16() for _ in range(2))
    dt = torch.rand((B, L, H), generator=rng, device="cuda")
    A = -torch.rand((H,), generator=rng, device="cuda") - 0.5
    return time_ms(lambda: ops.ssd_prep(xh, Bm, Cm, dt, A,
                                        chunk=dims["chunk"]), 10)


# -- 6b. the kernels at the models' own shapes ---------------------------------
def model_flash_data(shape: dict) -> tuple:
    """Random bf16 q, k, v in the models' (B, S, H, D) layout, as
    ``gqa_attention`` hands them to ``flash_attention``; with a ``Dv``
    (MLA) v is the second half of a (B, S, KV, D' + Dv) tensor, strided as
    ``mla_attention`` slices it from its up-projection."""
    rng = np.random.default_rng(6)
    B, H, KV, S, D = (shape[k] for k in ("B", "H", "KV", "S", "D"))
    q = rand(rng, (B, S, H, D), torch.bfloat16)
    k = rand(rng, (B, S, KV, D), torch.bfloat16)
    if "Dv" not in shape:
        return q, k, rand(rng, (B, S, KV, D), torch.bfloat16)
    Dv = shape["Dv"]
    return q, k, rand(rng, (B, S, KV, 2 * Dv), torch.bfloat16)[..., Dv:]


def oracle_by_lane(q, k, v) -> torch.Tensor:
    """``reference_attention`` (causal) one batch element at a time: the
    dense oracle's (B, H, S, S) float32 scores at H 128 would take 8.6 GB."""
    return torch.cat([reference_attention(q[b:b + 1], k[b:b + 1],
                                          v[b:b + 1], causal=True)
                      for b in range(q.shape[0])])


def phase_model_shape_checks(fa_inputs: dict, ssd_inputs: dict) -> dict:
    """B2 at granite-8b's, zamba2-1.2b's and deepseek-v3's MLA attention
    shapes, through the models' route (``ops.attention`` on the strided
    (B, S, H, D) tensors), against the dense oracle within ``FLASH_TOL``'s
    bf16 bound (the tensor-core kernel), and at the MLA shape in float32
    too (the FFMA kernel, the float32 path check's); B3's three kernels and
    the scan at zamba2-1.2b's shape within ``SSD_TOL``. Returns each
    kernel's largest max|err|."""
    errs = {"flash_attention": 0.0}
    for label, (q, k, v) in fa_inputs.items():
        S = q.shape[1]
        B, _, H, D = q.shape
        Dv = v.shape[3]
        dtypes = ((torch.bfloat16, torch.float32) if D != Dv
                  else (torch.bfloat16,))
        for dt in dtypes:
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            got = ops.attention(qd, kd, vd, causal=True, block_q=S,
                                block_k=S)
            want = oracle_by_lane(qd, kd, vd)
            err = max_err(got, want, FLASH_TOL[dt],
                          f"flash at {label}'s shape B{B} H{H} "
                          f"KV{k.shape[2]} S{S} D{D} Dv{Dv} causal {dt} "
                          f"{fa._variant(dt, D, Dv)}, the models' strided "
                          f"layout")
            errs["flash_attention"] = max(errs["flash_attention"], err)
            del got, want, qd, kd, vd
    errs["ssd_scan"] = max(check_ssd_full(full, dims)
                           for full, dims in ssd_inputs.values())
    torch.cuda.synchronize()
    return errs


def sdpa_backend(q, k, v) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these
    inputs (causal)."""
    from torch.nn.attention import SDPBackend

    names = {int(b): n for n, b in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v, is_causal=True)),
                     "unknown")


def phase_model_shape_times(fa_inputs: dict, ssd_inputs: dict) -> dict:
    """``[time]`` lines for B2 and B3 at the models' shapes: the kernel,
    the models' plain version, the library call (SDPA for B2) and the
    bound; for B3 also ``ops.ssd_prep`` at that shape."""
    out = {}
    for label, (q, k, v) in fa_inputs.items():
        S = q.shape[1]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fa_bound, fa_by = flash_bound(qt, kt, vt)
        k_rep, v_rep = gqa_repeated(qt, kt, vt)
        row = {}
        if v.shape[3] != q.shape[3]:  # MLA: the FFMA kernel on the same
            row["ffma_ms"] = time_ms(lambda: fa._launch(  # bf16 inputs too
                qt, kt, vt, causal=True, window=None,
                scale=1.0 / math.sqrt(q.shape[3]), variant="ffma"), 3)
        row["sdpa_backend"] = sdpa_backend(qt, k_rep, v_rep)
        out[f"flash_attention {label}"] = {
            **row,
            "ms": time_ms(lambda: ops.attention(
                q, k, v, causal=True, block_q=S, block_k=S), 10),
            "plain_ms": time_ms(lambda: mflash.blocked_flash(
                q, k, v, causal=True), 3),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, k_rep, v_rep, is_causal=True), 10),
            "bound_ms": fa_bound, "bound_by": fa_by,
            "shape": f"B{q.shape[0]} H{q.shape[2]} KV{k.shape[2]} S{S} "
                     f"D{q.shape[3]} Dv{v.shape[3]} causal bf16"}
        del k_rep, v_rep
    for label, (full, dims) in ssd_inputs.items():
        t = ssd_times(full)
        t["prep_ms"] = ssd_prep_ms(dims)
        t["shape"] = " ".join(f"{k}{v}" for k, v in dims.items())
        out[f"ssd_scan {label}"] = t
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        prep = (f", ops.ssd_prep {t['prep_ms']:.4f} ms" if "prep_ms" in t
                else "")
        ffma = (f" (ffma on the same inputs {t['ffma_ms']:.4f})"
                if "ffma_ms" in t else "")
        sdpa = (f" ({t['sdpa_backend']})" if "sdpa_backend" in t else "")
        print(f"[time] {name} ({t['shape']}): kernel_ms {t['ms']:.4f}"
              f"{ffma}, plain_ms {t['plain_ms']:.4f}, library_ms {lib}{sdpa},"
              f" bound_ms {t['bound_ms']:.4f} ({t['bound_by']}), roofline "
              f"share {t['bound_ms'] / t['ms']:.2%}{prep}")
    return out


def main() -> None:
    dev = phase_device()
    t0 = time.perf_counter()
    phase_build()
    phase_hpc(dev)
    phase_serving_bench(dev)

    cfg = GRANITE_8B
    L, d, heads, kv, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim)
    seq = 4096
    mm_stages, mm_x0 = matmul_chain(L, m=seq, k=d, dtype=cfg.dtype, seed=0)
    at_stages, at_q0 = attention_chain(L, heads=heads, kv_heads=kv,
                                       head_dim=hd, seq=seq, batch=1,
                                       dtype=cfg.dtype, seed=0)
    print(f"[data] {cfg.name}: {L} matmul stages x0{tuple(mm_x0.shape)} "
          f"w{tuple(mm_stages[0].params['w'].shape)}, {L} attention stages "
          f"q{tuple(at_q0.shape)} k/v{tuple(at_stages[0].params['k'].shape)}, "
          f"{cfg.dtype}, drawn in {time.perf_counter() - t0:.1f} s")
    mm_data = (mm_x0.cuda(), mm_stages[0].params["w"].cuda())
    fa_data = tuple(t.cuda().transpose(1, 2) for t in
                    (at_q0, at_stages[0].params["k"], at_stages[0].params["v"]))

    errs = phase_kernel_checks(mm_data, fa_data)
    phase_planted_faults(mm_data, fa_data)
    ssd_data = ssd_chunks(np.random.default_rng(3), **SSD_FULL)
    errs["ssd_scan"] = phase_ssd_checks(ssd_data)
    phase_ssd_fault(ssd_data)
    fa_models = {name: model_flash_data(shape)
                 for name, shape in FLASH_MODELS.items()}
    ssd_models = {"zamba2-1.2b": (ssd_chunks(np.random.default_rng(7),
                                             **SSD_ZAMBA), SSD_ZAMBA)}
    for name, err in phase_model_shape_checks(fa_models, ssd_models).items():
        errs[name] = max(errs[name], err)

    torch.cuda.reset_peak_memory_stats()
    chains = {
        "streaming_matmul": drive_chain("matmul chain", mm_stages, mm_x0, sm),
        "flash_attention": drive_chain("attention chain", at_stages, at_q0,
                                       fa),
    }
    print(f"[path] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del mm_stages, at_stages
    # each kernel's launches on every path: the chains, then the models
    by_path = {name: {} for name in ("streaming_matmul", "flash_attention",
                                     "ssd_scan")}
    for name, chain in chains.items():
        by_path[name][f"{name.split('_')[-1]} chain"] = chain["launches"]
    for label, phase in (("mamba2-130m", phase_mamba),
                         ("granite-8b", lambda: phase_dense(dev["smi"])),
                         ("zamba2-1.2b", phase_hybrid)):
        run = phase()
        for name, n in run["launches"].items():
            if n:
                by_path[name][label] = n
        if "engine" in run:  # the serving layer's path: decode, no kernel
            for name, n in run["engine"]["launches"].items():
                by_path[name][f"{label} engine"] = n
    for label, run in phase_moe(dev["smi"]).items():
        for name, n in run["launches"].items():
            if n:
                by_path[name][label] = n
    for name, paths in by_path.items():
        print(f"[path] {name} launches by path: {paths}")
        require(sum(paths.values()) > 0, f"{name}: launched on no path")

    times = phase_times(mm_data, fa_data, ssd_data)
    model_times = phase_model_shape_times(fa_models, ssd_models)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase; "
          f"{dev['smi']}")
    replaces = {
        "streaming_matmul": "src/repro/kernels/streaming_matmul.py:34",
        "flash_attention": "src/repro/kernels/flash_attention.py:36",
        "ssd_scan": "src/repro/kernels/ssd_scan.py:24",
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces[name],
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": errs[name],
         **{k: v for k, v in times[name].items() if k != "ffma_ms"},
         "model_shapes": {k.split(" ", 1)[1]: v
                          for k, v in model_times.items()
                          if k.startswith(name)}}
        for name in ("streaming_matmul", "flash_attention", "ssd_scan")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
