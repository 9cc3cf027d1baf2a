#!/usr/bin/env python3
"""Time the kernels of several CUDA source trees on one card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 kernel_ab.py [--kernels B1,B2,B3,B2bwd,B3bwd] [--rounds R]
                         TREE [TREE ...]

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
inputs. ``B2bwd`` (asked for by name) adds B2's backward kernels
(``flash_attention_bwd``, bf16) at the train steps' attention shapes,
``BWD_SHAPES`` (MLA's D 192, Dv 128 among them, and the three short dk/dv
grids of internvl2-1b, glm4-9b and granite-34b, where this tree splits each
group's heads and a tree from before the split, called through its own C
interface, does not): each tree's dq, dk and dv held against ``_plain_bwd`` on
the same o, lse and dO, and two launches required ``torch.equal``; then
SDPA's backward alone at each shape. ``B3bwd`` (by name) adds B3's
backward kernels (``ssd_chunk_scan_bwd``, float32) at the train steps' two
scans, ``chip_smoke.py``'s ``B3_VJP`` (mamba2-130m's and zamba2-1.2b's):
each tree's five gradients held to ``ssd_bwd_staged_plain`` within
``chip_smoke.b3_grad_ratio``'s bound and two launches required
``torch.equal``, and each tree's launches timed one by one under
``torch.profiler``. ``--rounds
0`` checks and profiles without the timed turns. It exits non-zero if a
tree's kernel misses the bound, is not deterministic, or ptxas serialised a
tree's wgmma (its "wgmma.mma_async instructions are serialized" notes,
C7512 to C7518).
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
    flash_dq_rounding_bound,
    flash_ref,
    matmul_ref,
    outside_tolerance,
    ssd_grad_ratio,
)

ROUNDS = 3
ITERS = 20
# B2's backward at the attention shapes the train steps run, in bf16
BWD_SHAPES = {
    "granite-8b": dict(B=2, H=32, KV=8, Sq=2048, Sk=2048, D=128,
                       causal=True),
    "zamba2-1.2b": dict(B=2, H=32, KV=32, Sq=2048, Sk=2048, D=64,
                        causal=True),
    "seamless-m4t-medium cross": dict(B=2, H=16, KV=16, Sq=512, Sk=1024,
                                      D=64, causal=False),
    "deepseek-v3-671b MLA": dict(B=2, H=128, KV=128, Sq=2048, Sk=2048,
                                 D=192, Dv=128, causal=True),
    # the short dk/dv grids, where a tree may split each group's heads
    "internvl2-1b": dict(B=2, H=14, KV=2, Sq=2304, Sk=2304, D=64,
                         causal=True),
    "glm4-9b": dict(B=2, H=32, KV=2, Sq=2048, Sk=2048, D=128, causal=True),
    "granite-34b": dict(B=2, H=48, KV=1, Sq=2048, Sk=2048, D=128,
                        causal=True),
}
_CALL_BWD = fa._call_bwd


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
    """Point the kernel wrappers at ``tree``'s libraries, B2's backward
    through the C interface ``tree`` exports."""
    _build.CSRC = tree
    _build._libs.clear()
    split = "int parts, float* part" in (
        tree / "flash_attention_bwd.cu").read_text()
    fa._call_bwd = _CALL_BWD if split else call_bwd_whole_groups


def call_bwd_whole_groups(variant: str, tensors, B, H, KV, Sq, Sk, D, Dv,
                          parts, part, *, causal, window, scale) -> None:
    """``flash_attention._call_bwd`` for a tree from before the split of
    a group's heads, whose ``flash_attention_bwd`` takes no part count and
    no scratch: its one part."""
    q, k, v, o, do, lse, delta, dq, dk, dv = tensors
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i, i] + [p] * 10 + [i] * 7 + [ll] * 24 + [
        ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    strides = [x for t in (q, k, v, o, do, dq, dk, dv) for x in t.stride()[:3]]
    code = fn(int(variant == "wgmma"), fa._DTYPE_CODE[q.dtype],
              *(t.data_ptr() for t in tensors), B, H, KV, Sq, Sk, D, Dv,
              *strides, float(scale), int(causal), int(window is not None),
              int(window or 0), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, f"flash_attention backward ({variant})")


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


def ssd_bwd(chunks, dy) -> list[torch.Tensor]:
    """B3's backward through the current tree's library (the states and
    their gradients, and the chunk total's terms, as scratch). Returns the
    five gradients."""
    lib = _build.load("ssd_scan")
    xc, bc = chunks[0], chunks[1]
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    states = xc.new_empty((B, H, nc, P, N))
    scratch = [states, torch.empty_like(states), torch.empty_like(chunks[4]),
               chunks[4].new_empty((B, H, nc))]
    grads = [torch.empty_like(t) for t in chunks]
    ints = [B * H, nc, Q, P, N]
    tensors = [*chunks, dy, *scratch, *grads]
    fn = lib.ssd_chunk_scan_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    code = fn(*(t.data_ptr() for t in tensors), *ints,
              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "ssd backward")
    return grads


def ssd_bwd_case(dims: dict):
    """B3's backward at one train scan ``dims`` (``B3_VJP``'s): the
    chunks as ``chip_smoke.ssd_chunks`` draws them, a dy, and the plain
    staged backward's five gradients."""
    import numpy as np

    from chip_smoke import ssd_chunks

    chunks = ssd_chunks(np.random.default_rng(13), **dims)
    dy = torch.randn(chunks[0].shape, generator=torch.Generator(
        device="cuda").manual_seed(14), device="cuda")
    want = ssd.ssd_bwd_staged_plain(*chunks, dy)
    return (lambda: ssd_bwd(chunks, dy)), want


def b3_beyond(got, want) -> int:
    """Elements of B3bwd's five gradients beyond ``chip_smoke``'s
    ``b3_grad_ratio`` bound (the reference's SSD tolerance scaled to each
    gradient); NaN and inf always miss."""
    from chip_smoke import SSD_TOL

    return sum(int((~(ssd_grad_ratio(g, w, SSD_TOL) <= 1.0)).sum())
               for g, w in zip(got, want))


def bwd_case(draw, sh: dict):
    """B2's backward at shape ``sh``: the launch, its plain version's
    (dq, dk, dv) with each bound's extra term, and SDPA's backward alone
    on the same inputs. q, k, v and dO are drawn in the models' (B, S, H,
    D) layout and passed transposed, o and lse come from B2's forward."""
    B, H, KV, Sq, Sk, D = (sh[k] for k in ("B", "H", "KV", "Sq", "Sk", "D"))
    causal, scale, Dv = sh["causal"], D ** -0.5, sh.get("Dv", D)
    q, do = draw(B, Sq, H, D), draw(B, Sq, H, Dv)
    k, v = draw(B, Sk, KV, D), draw(B, Sk, KV, Dv)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o, lse = fa._launch(qt, kt, vt, causal=causal, window=None, scale=scale,
                        with_lse=True)
    kw = dict(causal=causal, window=None, scale=scale)
    want = fa._plain_bwd(qt, kt, vt, o, lse, dot, **kw)
    # dq also carries delta's float32 sums, taken in another order
    extra = flash_dq_rounding_bound(q, k, o.transpose(1, 2), do,
                                    causal=causal, scale=scale)
    extras = ((extra * 2.0 ** -8).transpose(1, 2), None, None)
    G = H // KV
    q_req = qt.detach().requires_grad_(True)
    k_rep, v_rep = (t.repeat_interleave(G, dim=1).detach().requires_grad_(
        True) for t in (kt, vt))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(
        q_req, k_rep, v_rep, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, [q_req, k_rep, v_rep], dot,
                                   retain_graph=True)

    return (lambda: fa._launch_bwd(qt, kt, vt, o, lse, dot, **kw),
            (want, extras), sdpa_bwd)


def beyond(got, want, tol: float) -> int:
    """Elements of ``got`` (a tensor, or B2bwd's three) beyond the bound."""
    if isinstance(got, torch.Tensor):
        return int(outside_tolerance(got, want, tol).sum())
    (ref, extras) = want
    return sum(int(outside_tolerance(g, w, tol, e).sum())
               for g, w, e in zip(got, ref, extras))


def main(trees: list[Path], kernels: list[str], rounds: int = ROUNDS) -> int:
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
    sdpa_bwd = {}
    if "B2bwd" in kernels:
        use(trees[0])
        for label, sh in BWD_SHAPES.items():
            fn, ref, sdpa_bwd[label] = bwd_case(draw, sh)
            runs[f"B2bwd {label}"] = fn
            want[f"B2bwd {label}"] = (lambda ref=ref: ref, 3e-2)
    if "B3bwd" in kernels:
        from chip_smoke import B3_VJP

        for label, dims in B3_VJP.items():
            fn, ref = ssd_bwd_case(dims)
            runs[f"B3bwd {label}"] = fn
            want[f"B3bwd {label}"] = (lambda ref=ref: ref, None)
    runs = {name: fn for name, fn in runs.items()
            if name.split(" ")[0] in kernels}
    want = {name: (ref(), tol) for name, (ref, tol) in want.items()
            if name in runs}
    failed = False
    for tree in trees:
        use(tree)
        _build.BUILD_LOG.clear()
        _build.build_all()
        for name, (_, log) in _build.BUILD_LOG.items():
            if "wgmma.mma_async instructions are serialized" in log:
                print(f"{tree}: ptxas serialised the wgmma of {name}")
                failed = True
        if "B3bwd" in kernels and "ssd_scan" in _build.BUILD_LOG:
            # registers, spills and stack of each kernel
            for line in _build.BUILD_LOG["ssd_scan"][1].splitlines():
                if "Compiling entry" in line or "Used" in line or "spill" in line:
                    print(f"{tree}: ssd_scan {line.strip()}")
        for kernel, fn in runs.items():
            ref, tol = want[kernel]
            got = fn()
            bad = (b3_beyond(got, ref) if kernel.startswith("B3bwd")
                   else beyond(got, ref, tol))
            print(f"{tree}: {kernel} {bad} elements beyond the bound")
            failed |= bad > 0
            if kernel.startswith(("B2bwd", "B3bwd")):
                same = all(torch.equal(a, b) for a, b in zip(got, fn()))
                print(f"{tree}: {kernel} two launches torch.equal: {same}")
                failed |= not same
            if kernel.startswith("B3bwd"):
                from chip_smoke import kernel_name, launch_times

                per = launch_times(fn)
                print(f"{tree}: {kernel} launches (torch.profiler, ms a "
                      f"launch and launches a call): " + "; ".join(
                          f"{kernel_name(name)} {ms:.4f} x{n:g}"
                          for name, (ms, n) in per.items()))
            del got
    times = {(t, kn): [] for t in trees for kn in runs}
    for _ in range(rounds):
        for tree in trees + trees[::-1]:
            use(tree)
            for kernel, fn in runs.items():
                times[tree, kernel].append(time_ms(fn))
    for (tree, kernel), ms in times.items():
        if not ms:
            continue
        print(f"{tree}: {kernel} median {statistics.median(ms):.4f} ms, runs "
              + ", ".join(f"{t:.4f}" for t in ms))
    if rounds == 0:
        return int(failed)
    k_rep, v_rep = (t.repeat_interleave(4, dim=1) for t in (k, v))
    print(f"torch.matmul {time_ms(lambda: torch.matmul(x, w)):.4f} ms, SDPA "
          f"{time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k_rep, v_rep, is_causal=True)):.4f} ms")  # noqa: E501
    for label, fn in sdpa_bwd.items():
        print(f"SDPA backward alone at {label}: {time_ms(fn):.4f} ms")
    return int(failed)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--kernels", default="B1,B2,B3",
                        help="comma-separated, of B1, B2, B3, B2bwd, B3bwd")
    parser.add_argument("--rounds", type=int, default=ROUNDS,
                        help="timed turns over the trees (0: check only)")
    args = parser.parse_args()
    raise SystemExit(main([t.resolve() for t in args.trees],
                          args.kernels.split(","), args.rounds))
