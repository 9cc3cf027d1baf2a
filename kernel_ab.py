#!/usr/bin/env python3
"""Time the kernels of several CUDA source trees on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 kernel_ab.py [--kernels B1,B2,B3] TREE [TREE ...]

Each TREE is a directory of kernel sources: this checkout's
``src/repro_torch/kernels/csrc``, or the same directory of another commit
unpacked with ``git archive`` into a git-ignored directory. B1 and B2 need
this checkout's C interface (``streaming_matmul_wgmma``,
``flash_attention_wgmma`` with its ``lse`` pointer: a tree whose B2 entry
points take no lse pointer fails B2's check); B3 takes either SSD interface a tree exports,
the three-kernel ``ssd_chunk_scan_staged`` (with its state scratch) or the
single sequential ``ssd_chunk_scan`` of earlier trees. Each tree is built
into its own library (the build names it after the sources' hash), held
against the plain PyTorch versions, then timed in turns — the trees in
order, then in reverse, three times — so that every tree meets the same
card state. It prints, per tree, the median and every run of each kernel
asked for (all three by default): B1 (x @ w at 4096³, bf16), B2 (causal
flash attention, B1 H32 KV8 S4096 D128, bf16, q/k/v strided as the executor
passes them) and B3 (the SSD chunk scan at mamba2-130m's B4 H24 L2048 P64
N128 chunk 256, float32), then ``torch.matmul`` and SDPA on B1's and B2's
inputs. It exits non-zero if a tree's kernel misses the bound or ptxas
serialised a tree's wgmma (warning C7514).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import streaming_matmul as sm  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    flash_ref,
    matmul_ref,
    outside_tolerance,
)

ROUNDS = 3
ITERS = 20


def time_ms(fn) -> float:
    """Mean device time of ``fn`` over ``ITERS`` back-to-back launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def use(tree: Path) -> None:
    """Point the kernel wrappers at ``tree``'s libraries."""
    _build.CSRC = tree
    _build._libs.clear()


def ssd_scan(xc, bc, cc, dtc, cum) -> torch.Tensor:
    """B3 through the current tree's library, by the interface it exports."""
    lib = _build.load("ssd_scan")
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    y = torch.empty_like(xc)
    tensors = [xc, bc, cc, dtc, cum]
    if hasattr(lib, "ssd_chunk_scan_staged"):
        fn = lib.ssd_chunk_scan_staged
        tensors.append(xc.new_empty((B, H, nc, P, N)))  # the state scratch
    else:
        fn = lib.ssd_chunk_scan
    tensors.append(y)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    code = fn(*(t.data_ptr() for t in tensors), B * H, nc, Q, P, N,
              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "ssd scan")
    return y


def main(trees: list[Path], kernels: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    x, w = draw(4096, 4096), draw(4096, 4096) * 4096 ** -0.5
    q, k, v = (draw(1, 4096, h, 128).transpose(1, 2) for h in (32, 8, 8))
    # the reference test's SSD distributions at mamba2-130m's shape
    B, L, H, P, N = 4, 2048, 24, 64, 128
    f32 = torch.float32
    chunks = ops.ssd_prep(
        draw(B, L, H, P, dtype=f32), draw(B, L, 1, N, dtype=f32) * 0.5,
        draw(B, L, 1, N, dtype=f32) * 0.5,
        torch.nn.functional.softplus(draw(B, L, H, dtype=f32)),
        -torch.exp(draw(H, dtype=f32) * 0.5), chunk=256)
    runs = {
        "B1": lambda: sm.streaming_matmul(x, w),
        "B2": lambda: fa.flash_attention_gpu(q, k, v, causal=True),
        "B3": lambda: ssd_scan(*chunks),
    }
    want = {"B1": (lambda: matmul_ref(x, w), 0.5),
            "B2": (lambda: flash_ref(q, k, v, causal=True), 3e-2),
            "B3": (lambda: ssd.ssd_chunk_scan_plain(*chunks), 2e-4)}
    runs = {name: fn for name, fn in runs.items() if name in kernels}
    want = {name: (ref(), tol) for name, (ref, tol) in want.items()
            if name in runs}
    failed = False
    for tree in trees:
        use(tree)
        _build.BUILD_LOG.clear()
        _build.build_all()
        for name, (_, log) in _build.BUILD_LOG.items():
            if "C7514" in log:
                print(f"{tree}: ptxas serialised the wgmma of {name}")
                failed = True
        for kernel, fn in runs.items():
            ref, tol = want[kernel]
            bad = int(outside_tolerance(fn(), ref, tol).sum())
            print(f"{tree}: {kernel} {bad} elements beyond the bound")
            failed |= bad > 0
    times = {(t, kn): [] for t in trees for kn in runs}
    for _ in range(ROUNDS):
        for tree in trees + trees[::-1]:
            use(tree)
            for kernel, fn in runs.items():
                times[tree, kernel].append(time_ms(fn))
    for (tree, kernel), ms in times.items():
        print(f"{tree}: {kernel} median {statistics.median(ms):.4f} ms, runs "
              + ", ".join(f"{t:.4f}" for t in ms))
    k_rep, v_rep = (t.repeat_interleave(4, dim=1) for t in (k, v))
    print(f"torch.matmul {time_ms(lambda: torch.matmul(x, w)):.4f} ms, SDPA "
          f"{time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k_rep, v_rep, is_causal=True)):.4f} ms")  # noqa: E501
    return int(failed)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--kernels", default="B1,B2,B3",
                        help="comma-separated, of B1, B2, B3")
    args = parser.parse_args()
    raise SystemExit(main([t.resolve() for t in args.trees],
                          args.kernels.split(",")))
