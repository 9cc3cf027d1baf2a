"""The work each kernel call does: its operations and the bytes it must move.

A frozen copy of the program's own count (``repro_torch/kernels/work.py``
as of the benchmark's first version), so that the benchmark's rooflines
read the same whatever implements a kernel. The counts depend only on the
shapes a call is given. The bytes are each input read once and each output
written once.
"""
from __future__ import annotations

import numpy as np


def matmul_work(M: int, N: int, K: int, itemsize: int) -> tuple[float, int]:
    """B1, an (M, K) @ (K, N) product: ``2·M·N·K`` operations; x and w
    read, the (M, N) result written."""
    return 2.0 * M * N * K, (M * K + K * N + M * N) * itemsize


def live_pairs(Sq: int, Sk: int, causal: bool,
               window: int | None = None) -> float:
    """The (query, key) pairs attention computes, B2's masks: query row i
    sees key j when ``j <= i`` (causal; rows and keys aligned at 0) and
    ``j > i - window`` (a sliding window). The causal half of a square is
    ``Sq·(Sq + 1)/2``; with no mask every pair."""
    if window is None:
        if not causal:
            return float(Sq * Sk)
        if Sq <= Sk:
            return Sq * (Sq + 1) / 2
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return float(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B: int, H: int, Sq: int, Sk: int, KV: int, D: int, Dv: int,
               *, causal: bool, window: int | None,
               itemsize: int) -> tuple[float, int]:
    """B2 over (B, H, Sq, D) queries and (B, KV, Sk, ·) keys and values:
    the live pairs' two products, ``2·(D + Dv)`` operations a pair and
    head; q, k and v read, o written."""
    flops = B * H * live_pairs(Sq, Sk, causal, window) * 2.0 * (D + Dv)
    nbytes = (B * H * Sq * D + B * KV * Sk * (D + Dv) + B * H * Sq * Dv)
    return flops, nbytes * itemsize


def flash_bwd_work(B: int, H: int, Sq: int, Sk: int, KV: int, D: int,
                   Dv: int, *, causal: bool, window: int | None,
                   itemsize: int) -> tuple[float, int]:
    """B2's backward: five products over the live pairs, ``2·(3D + 2Dv)``
    operations a pair and head: S = q kᵀ recomputed, dQ = dS k and dK =
    dSᵀ q over D; dP = dO vᵀ and dV = Pᵀ dO over Dv (2.5 x the forward's
    at D = Dv); q, k, v, o, do and the float32 lse read, dq, dk and dv
    written."""
    flops = (B * H * live_pairs(Sq, Sk, causal, window)
             * 2.0 * (3 * D + 2 * Dv))
    elems = 2 * (B * H * Sq * D + B * KV * Sk * (D + Dv) + B * H * Sq * Dv)
    return flops, elems * itemsize + B * H * Sq * 4


def ssd_work(B: int, H: int, nc: int, Q: int, P: int,
             N: int) -> tuple[float, int]:
    """B3's scan over (B, H, nc, Q, ·) float32 chunks: per (b, h, chunk)
    the causal half of C Bᵀ and of its product with x, then C Sᵀ and the
    carry xᵀ (w o B); the five inputs read and y written once."""
    live = Q * (Q + 1) / 2
    flops = B * H * nc * (2.0 * live * (N + P) + 4.0 * Q * N * P)
    elems = B * H * nc * Q * (2 * P + 2 * N + 2)
    return flops, elems * 4


def ssd_bwd_work(B: int, H: int, nc: int, Q: int, P: int,
                 N: int) -> tuple[float, int]:
    """B3's backward: per (b, h, chunk) over the causal half the scores C
    Bᵀ and g xᵀ and the products giving dx, dB and dC, ``2·(3N + 2P)`` a
    pair; six (P x N) products over the chunk (the carry recomputed,
    dS_in, D Bᵀ, xᵀ D, C S_inᵀ and g S_in); the five inputs and dy read,
    the five gradients written once."""
    live = Q * (Q + 1) / 2
    flops = B * H * nc * (2.0 * live * (3 * N + 2 * P) + 12.0 * Q * N * P)
    elems = B * H * nc * Q * (3 * P + 4 * N + 4)
    return flops, elems * 4
