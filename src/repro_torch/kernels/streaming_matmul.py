"""``x @ w`` with ``w`` streamed through a two-slot shared-memory ring.

The port of ``repro.kernels.streaming_matmul``. On a CUDA tensor it launches
the hand-written kernel in ``csrc/streaming_matmul.cu`` (see the note there
for its design and bound); on a CPU tensor it computes the plain version,
:func:`repro_torch.kernels.ref.matmul_ref`. Which one runs is decided by the
tensors' device alone.

The block arguments keep the reference's contract: each is clamped to its
dim, and a dim that its block does not divide raises a :class:`ValueError`
naming it. The CUDA kernel tiles internally at its own sizes. The backward
pass (the reference's custom VJP) waits for the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref

#: Launches of the CUDA kernel in this process (the CPU path never counts).
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _validate_tiles(where: str, **dims: tuple[int, int]) -> None:
    """Raise a ValueError naming the first dim not divisible by its block."""
    for dim, (size, block) in dims.items():
        if block <= 0:
            raise ValueError(f"{where}: block for {dim} must be > 0, got {block}")
        if size % block != 0:
            raise ValueError(
                f"{where}: {dim}={size} is not divisible by its block size "
                f"{block}; pad {dim} to a multiple of {block} or pass a "
                f"divisor block"
            )


def _signature(lib: ctypes.CDLL):
    fn = lib.streaming_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"streaming_matmul: CUDA kernel takes float32 or bfloat16 with "
            f"x.dtype == w.dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("streaming_matmul: x and w must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    vec = 16 // w.element_size()
    if N % vec or w.data_ptr() % 16:
        raise ValueError(
            f"streaming_matmul: the CUDA kernel streams w in 16-byte vectors; "
            f"N={N} must be a multiple of {vec} and w 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load("streaming_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _signature(lib)(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                           out.data_ptr(), M, N, K, stream)
    _build.check(lib, code, "streaming_matmul")
    LAUNCHES += 1
    return out


def streaming_matmul(
    x: torch.Tensor,            # (M, K)
    w: torch.Tensor,            # (K, N)
    *,
    block_m: int = 256,
    block_n: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """``x @ w`` in float32 accumulation, cast to ``x.dtype``.

    ``block_m``, ``block_n`` and ``block_k`` only validate the shapes (the
    reference's contract): the CUDA kernel tiles at its own fixed sizes,
    and no block argument changes what it computes or how.
    """
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(
            f"streaming_matmul: expected 2-D x and w, got {tuple(x.shape)} "
            f"and {tuple(w.shape)}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(
            f"streaming_matmul: contracting dims disagree, x has K={K}, "
            f"w has K={K2}")
    _validate_tiles("streaming_matmul", M=(M, min(block_m, M)),
                    N=(N, min(block_n, N)), K=(K, min(block_k, K)))
    if w.device != x.device:
        raise ValueError(f"streaming_matmul: x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"streaming_matmul: no kernel for device {x.device}")
    return _launch(x, w)
