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
     memory per placement; greedy serving of 4 prompts through
     ``decode_step`` (local and at 0.5, tokens equal); each kernel's
     launches equal to its count a forward times the forwards (granite-8b:
     36 B2; zamba2-1.2b: 6 B2 and 38 B3; mamba2-130m: 24 B3), every B2
     launch through wgmma and each SSD kernel once a scan. Then the path
     check: the same forward with the kernels' plain versions (the plain
     SSD, the models' plain flash), in bf16 printed beside its floor (the
     plain forward with one plain version's output nudged) and held to
     ``PATH_BOUND`` in float32 (granite-8b on 8 layers); and decode against
     forward in float32 over 512 tokens (granite-8b on 2 layers,
     zamba2-1.2b on 12);
  6. kernel times at the main paths' shapes (CUDA events), per variant
     (the tensor-core kernel on the path and the FFMA kernel on the same
     bf16 inputs), beside the plain version's, one library call's (none for
     the SSD scan), and the card's bound (for the SSD scan at the rate of
     the instruction it uses, 3xTF32); the SSD scan's three kernels alone
     and ``ops.ssd_prep``, the prep in front of it; then B2 and B3 at the
     models' shapes (phase 3 checks them there too): B2 at granite-8b's
     and zamba2-1.2b's attention through the models' route, B3 and
     ``ops.ssd_prep`` at zamba2-1.2b's scan;
  7. one JSON line ``{"kernels": [...]}``;
  8. the last line, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
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

from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B  # noqa: E402
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M  # noqa: E402
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B  # noqa: E402
from repro_torch.core.tiering import (  # noqa: E402
    TieringConfig,
    map_leaves,
    place_params,
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
                "zamba2-1.2b": dict(B=4, H=32, KV=32, S=2048, D=64)}
BEST_OF = 3
# the float32 plain-SSD forward's bound, as a share of max(1, max|logits|),
# float32's bound for decode against forward; why the check is held in
# float32 is written where it is used (phase_mamba)
PATH_BOUND = 1e-3


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


def greedy(params, cfg, prompts, n_new: int, plan=None):
    """The reference engine's serving loop: prefill token by token through
    ``decode_step``, then ``n_new`` greedy tokens. Returns the new tokens
    and, for each decode step, its ms and its host ms (``timed_ms``)."""
    cache = tf.init_decode_cache(cfg, prompts.shape[0],
                                 prompts.shape[1] + n_new)
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


def drive_placements(tag: str, cfg, params, batch) -> tuple:
    """``forward`` with every weight on the card (the oracle), then with
    the weights placed by ``host_offload`` at 0.5 and 0.0, prefetch on and
    off; every logits tensor ``torch.equal`` to the oracle. Returns (the
    oracle on the host, per-placement rows, forwards run)."""
    oracle = None  # on the host, so that no placement's peak includes it
    rows, n_fwd = {}, 0
    for mode, frac in (("none", 1.0), ("host_offload", 0.5),
                       ("host_offload", 0.0)):
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


def serve(tag: str, cfg, params, prompts) -> int:
    """Greedy decode of 4 prompts, all local and at host_offload 0.5; the
    tokens must agree. Returns the decode steps run."""
    served = {}
    for label, frac in (("local", None), ("host_offload 0.5", 0.5)):
        if frac is None:
            placed, plan = params, None
        else:
            placed, plan = place_params(params, TieringConfig(
                mode="host_offload", local_fraction=frac))
        toks, steps = greedy(placed, cfg, prompts, 16, plan=plan)
        served[label] = (toks, steps)
        steady = sorted(steps[1:])
        host = sorted(h for _, h in steps[1:])
        print(f"[serve] {cfg.name} {label}: 4 prompts x {prompts.shape[1]} "
              f"tokens prefilled token by token, 16 new each; decode step "
              f"median {steady[len(steady) // 2][0]:.3f} ms (host "
              f"{host[len(host) // 2]:.3f} ms before the synchronise), min "
              f"{steady[0][0]:.3f} ms over {len(steps)} steps; tokens "
              f"{toks[0, :8].tolist()}...")
        del placed
    require(torch.equal(served["local"][0], served["host_offload 0.5"][0]),
            f"{tag}: offloaded greedy tokens != local tokens")
    return sum(len(steps) for _, steps in served.values())


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
            "params": params, "batch": batch, "oracle": oracle.cuda()}


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


def decode_vs_forward(tag: str, cfg, depth: int, n_tok: int = 512) -> None:
    """The reference's decode-matches-forward contract at full width in
    float32, ``depth`` layers: token-by-token decode over 2 x ``n_tok``
    tokens against the forward, max|diff| < 1e-3 x max(1, max|logits|)."""
    depth = min(depth, cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=depth)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p32 = tf.init_params(gen, cfg32)
    tok = make_batch(cfg32, gen, 2, n_tok)["tokens"]
    full, _ = tf.forward(p32, {"tokens": tok}, cfg32)
    cache = tf.init_decode_cache(cfg32, 2, n_tok)
    errs = torch.zeros((), device="cuda")
    for t in range(n_tok):
        lg, cache = tf.decode_step(p32, cache, tok[:, t:t + 1], cfg32)
        errs = torch.maximum(errs, (lg[:, 0] - full[:, t]).abs().max())
    scale = full[..., :cfg.vocab_size].abs().max().item()
    err = errs.item()
    require(err < PATH_BOUND * max(scale, 1.0),
            f"{tag} f32: decode drifts from forward by {err:.4g} (scale "
            f"{scale:.4g})")
    print(f"[{tag}] float32 decode vs forward, {depth} of {cfg.n_layers} "
          f"layers, over 2 x {n_tok} tokens: max|diff| {err:.4g} < 1e-3 x "
          f"max(1, {scale:.4g})")


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


def phase_dense() -> dict:
    """granite-8b at full width: 36 B2 launches a forward (B4 H32 KV8 S2048
    D128 causal); the path checked against the plain flash in float32 on 8
    layers, and decode against forward on 2."""
    cfg = GRANITE_8B
    run = drive_model("dense", cfg, {"flash_attention": cfg.n_layers})
    path_check("dense", cfg, run, {"flash": mflash.blocked_flash},
               {"flash": nudged_kernels()["flash"]}, "plain-flash",
               "the attention output nudged by 2^-9", 8)
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
    ``gqa_attention`` hands them to ``flash_attention``."""
    rng = np.random.default_rng(6)
    B, H, KV, S, D = (shape[k] for k in ("B", "H", "KV", "S", "D"))
    return (rand(rng, (B, S, H, D), torch.bfloat16),
            rand(rng, (B, S, KV, D), torch.bfloat16),
            rand(rng, (B, S, KV, D), torch.bfloat16))


def phase_model_shape_checks(fa_inputs: dict, ssd_inputs: dict) -> dict:
    """B2 at granite-8b's and zamba2-1.2b's attention shapes, through the
    models' route (``ops.attention`` on the strided (B, S, H, D) tensors),
    against the dense oracle within ``FLASH_TOL``'s bf16 bound; B3's three
    kernels and the scan at zamba2-1.2b's shape within ``SSD_TOL``. Returns
    each kernel's largest max|err|."""
    errs = {"flash_attention": 0.0}
    for label, (q, k, v) in fa_inputs.items():
        S = q.shape[1]
        got = ops.attention(q, k, v, causal=True, block_q=S, block_k=S)
        want = reference_attention(q, k, v, causal=True)
        B, _, H, D = q.shape
        err = max_err(got, want, FLASH_TOL[q.dtype],
                      f"flash at {label}'s shape B{B} H{H} KV{k.shape[2]} "
                      f"S{S} D{D} causal bf16 "
                      f"{fa._variant(q.dtype, D, v.shape[3])}, the models' "
                      f"strided layout")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        del got, want
    errs["ssd_scan"] = max(check_ssd_full(full, dims)
                           for full, dims in ssd_inputs.values())
    torch.cuda.synchronize()
    return errs


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
        out[f"flash_attention {label}"] = {
            "ms": time_ms(lambda: ops.attention(
                q, k, v, causal=True, block_q=S, block_k=S), 10),
            "plain_ms": time_ms(lambda: mflash.blocked_flash(
                q, k, v, causal=True), 3),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, k_rep, v_rep, is_causal=True), 10),
            "bound_ms": fa_bound, "bound_by": fa_by,
            "shape": f"B{q.shape[0]} H{q.shape[2]} KV{k.shape[2]} S{S} "
                     f"D{q.shape[3]} causal bf16"}
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
        print(f"[time] {name} ({t['shape']}): kernel_ms {t['ms']:.4f}, "
              f"plain_ms {t['plain_ms']:.4f}, library_ms {lib}, bound_ms "
              f"{t['bound_ms']:.4f} ({t['bound_by']}), roofline share "
              f"{t['bound_ms'] / t['ms']:.2%}{prep}")
    return out


def main() -> None:
    dev = phase_device()
    t0 = time.perf_counter()
    phase_build()

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
                         ("granite-8b", phase_dense),
                         ("zamba2-1.2b", phase_hybrid)):
        for name, n in phase()["launches"].items():
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
