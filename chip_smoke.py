#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failed check raises and exits non-zero):

  1. device: name, count, versions, ``nvidia-smi`` name and power limit;
  2. build: every kernel in ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once), with ptxas's register,
     shared-memory and spill report;
  3. kernels against their plain PyTorch versions on the card: the
     reference's kernel test cases (``tests/test_kernels.py``) in float32
     and bf16, then the main path's full-width shapes, within
     ``kernels.ref.tolerance_ratio``'s bound (the reference's tolerances,
     and for bf16 a bound scaled to each output row); then a planted fault
     at full width (one tile skipped) that the bound must fail;
  4. the main path: the streaming executor over 36-stage granite-8b-width
     matmul and attention chains (bf16) — untiered oracle, unpaced probe,
     balanced throttle, best of 3 runs with prefetch on and off, every
     output ``torch.equal`` to the oracle, the kernels' launch counters
     matching the stages run, then the simulator calibrated and replayed;
  5. kernel times at the main path's shapes (CUDA events) beside the plain
     version's, one library call's, and the card's bound;
  6. one JSON line ``{"kernels": [...]}``;
  7. the last line, ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or the reference package ``repro``.
"""
from __future__ import annotations

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
from repro_torch.core.exec import (  # noqa: E402
    StreamingExecutor,
    attention_chain,
    balanced_throttle,
    matmul_chain,
    untiered_oracle,
)
from repro_torch.core.fabric import FabricResource, SimClock  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import streaming_matmul as sm  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    NEG_INF,
    flash_ref,
    matmul_ref,
    outside_tolerance,
    tolerance_ratio,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
BEST_OF = 3


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


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time in ms the card could take, and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
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
            if re.search(r"registers|spill|bytes stack", line):
                print(f"[build] {name}: {line.strip()}")


# -- 3. kernels against their plain versions --------------------------------
def phase_kernel_checks(mm_data, fa_data) -> dict:
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        tol = MATMUL_TOL[dtype]
        for M, K, N in MATMUL_CASES:
            x, w = rand(rng, (M, K), dtype), rand(rng, (K, N), dtype)
            got = sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                      block_k=128)
            max_err(got, matmul_ref(x, w), tol, f"matmul {M}x{K}x{N} {dtype}")
        tol = FLASH_TOL[dtype]
        for B, H, KV, Sq, Sk, D, Dv, causal, window in FLASH_CASES:
            q = rand(rng, (B, H, Sq, D), dtype)
            k = rand(rng, (B, KV, Sk, D), dtype)
            v = rand(rng, (B, KV, Sk, Dv), dtype)
            got = fa.flash_attention_gpu(q, k, v, causal=causal,
                                         window=window, block_q=64,
                                         block_k=64)
            want = flash_ref(q, k, v, causal=causal, window=window)
            case = (f"flash B{B} H{H} KV{KV} Sq{Sq} Sk{Sk} D{D} Dv{Dv} "
                    f"causal={causal} window={window} {dtype}")
            max_err(got, want, tol, case)
    # the main path's full-width shapes, on the chains' own data
    x, w = mm_data
    err_mm = max_err(sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                         block_k=128),
                     matmul_ref(x, w), MATMUL_TOL[x.dtype],
                     f"matmul full width {tuple(x.shape)}@{tuple(w.shape)} "
                     f"{x.dtype}")
    q, k, v = fa_data
    err_fa = max_err(fa.flash_attention_gpu(q, k, v, causal=True,
                                            block_q=128, block_k=128),
                     flash_ref(q, k, v, causal=True), FLASH_TOL[q.dtype],
                     f"flash full width q{tuple(q.shape)} k{tuple(k.shape)} "
                     f"causal {q.dtype}")
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
    sm.LAUNCHES = 0
    fa.LAUNCHES = 0
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

    ex = StreamingExecutor(stages, prefetch=True, throttle=throttle)
    plan = ex.plan_tiers(0.0)
    ex.warmup(x0)
    on = [ex.run(x0) for _ in range(BEST_OF)]
    ex.prefetch = False
    off = [ex.run(x0) for _ in range(BEST_OF)]
    passes += 1 + 2 * BEST_OF
    launches = {"streaming_matmul": sm.LAUNCHES, "flash_attention": fa.LAUNCHES}
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
          f"launches {launches}, outputs torch.equal to the untiered oracle")
    return {"launches": launches[mine], "speedup": speedup,
            "on_ms": best_on.elapsed_us / 1e3,
            "off_ms": best_off.elapsed_us / 1e3, "sim_err": sim_err}


# -- 5. kernel times ----------------------------------------------------------
def phase_times(mm_data, fa_data) -> dict:
    x, w = mm_data
    M, K = x.shape
    N = w.shape[1]
    mm_bound, mm_by = bound(2.0 * M * N * K,
                            (M * K + K * N + M * N) * x.element_size(),
                            x.dtype)
    mm = {
        "ms": time_ms(lambda: sm.streaming_matmul(
            x, w, block_m=128, block_n=128, block_k=128), 20),
        "plain_ms": time_ms(lambda: matmul_ref(x, w), 20),
        "library_ms": time_ms(lambda: torch.matmul(x, w), 20),
        "bound_ms": mm_bound, "bound_by": mm_by,
    }
    q, k, v = fa_data
    B, H, S, D = q.shape
    Dv = v.shape[3]
    live_pairs = S * (S + 1) / 2          # causal, Sq == Sk
    fa_bound, fa_by = bound(
        B * H * live_pairs * 2.0 * (D + Dv),
        (q.numel() + k.numel() + v.numel() + B * H * S * Dv)
        * q.element_size(), q.dtype)
    G = H // k.shape[1]
    k_rep = k.repeat_interleave(G, dim=1)  # outside the timed region
    v_rep = v.repeat_interleave(G, dim=1)
    fa_t = {
        "ms": time_ms(lambda: fa.flash_attention_gpu(
            q, k, v, causal=True, block_q=128, block_k=128), 10),
        "plain_ms": time_ms(lambda: flash_ref(q, k, v, causal=True), 3),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=True), 10),
        "bound_ms": fa_bound, "bound_by": fa_by,
    }
    for name, t in (("streaming_matmul", mm), ("flash_attention", fa_t)):
        print(f"[time] {name}: kernel_ms {t['ms']:.4f}, plain_ms "
              f"{t['plain_ms']:.4f}, library_ms {t['library_ms']:.4f}, "
              f"bound_ms {t['bound_ms']:.4f} ({t['bound_by']}), roofline "
              f"share {t['bound_ms'] / t['ms']:.2%}")
    return {"streaming_matmul": mm, "flash_attention": fa_t}


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

    torch.cuda.reset_peak_memory_stats()
    paths = {
        "streaming_matmul": drive_chain("matmul chain", mm_stages, mm_x0, sm),
        "flash_attention": drive_chain("attention chain", at_stages, at_q0,
                                       fa),
    }
    print(f"[path] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    times = phase_times(mm_data, fa_data)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device phase; "
          f"{dev['smi']}")
    replaces = {
        "streaming_matmul": "src/repro/kernels/streaming_matmul.py:34",
        "flash_attention": "src/repro/kernels/flash_attention.py:36",
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": replaces[name], "launches": paths[name]["launches"],
         "max_abs_err": errs[name], **times[name]}
        for name in ("streaming_matmul", "flash_attention")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
