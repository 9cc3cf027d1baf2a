"""``x @ w`` with ``w`` streamed through a shared-memory ring.

The port of ``repro.kernels.streaming_matmul``. On a CUDA tensor it launches
a hand-written kernel in ``csrc/streaming_matmul.cu`` (see the note there
for its design and bound); on a CPU tensor it computes the plain version,
:func:`repro_torch.kernels.ref.matmul_ref`. Which one runs is decided by the
tensors' device alone, and which CUDA kernel by :func:`_variant`, a plain
rule on dtype and shape: bf16 with K a multiple of 8 takes the tensor-core
kernel (``"wgmma"``), everything else the CUDA-core one (``"ffma"``). Both
kernels read w's rows in 16-byte units, so :func:`_launch` first pads w
with zero columns to :func:`padded_columns` and drops them from the result:
exact, because each output column reads its own column of w alone.

The block arguments keep the reference's contract: each is clamped to its
dim, and a dim that its block does not divide raises a :class:`ValueError`
naming it. The CUDA kernels tile internally at their own sizes.

A traced tensor (a fake tensor, or one on the ``meta`` device) takes the
card's route on any device, up to the launch, where
:mod:`repro_torch.kernels.traced`'s op stands in for the C entry point.

The backward pass mirrors the reference's custom VJP (``_matmul_bwd``):
``dx = g @ wᵀ`` and ``dw = xᵀ @ g`` through the same kernel (or, on the CPU,
the same plain version), cast to x's and w's types. The transposed operands
are made contiguous first: the kernel reads x K-major and w MN-major, and a
contiguous copy is all the backward needs of it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref
from repro_torch.kernels.traced import is_traced

#: Launches of the CUDA kernels in this process (the CPU path never counts).
LAUNCHES = 0
#: The same launches by variant (see :func:`_variant`).
VARIANT_LAUNCHES = {"wgmma": 0, "ffma": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    """Set :data:`LAUNCHES` and every :data:`VARIANT_LAUNCHES` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    VARIANT_LAUNCHES.update(dict.fromkeys(VARIANT_LAUNCHES, 0))


def _variant(dtype: torch.dtype, K: int, N: int) -> str:
    """Which CUDA kernel computes an (M, K) @ (K, N) product of ``dtype``:
    ``"wgmma"`` (tensor cores, TMA) for bf16 whose row strides are whole
    16-byte units, i.e. K and N multiples of 8; ``"ffma"`` (CUDA cores)
    for the rest, float32 included (TF32 would miss the reference's
    float32 tolerance). :func:`_launch` asks with N already padded
    (:func:`padded_columns`)."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0:
        return "wgmma"
    return "ffma"


def padded_columns(N: int, dtype: torch.dtype) -> int:
    """The column count the CUDA kernels compute for a w with ``N`` columns
    of ``dtype``: N rounded up to whole 16-byte units of a row (8 bf16 or
    4 float32 elements). The FFMA kernel streams w in 16-byte vectors and
    the wgmma kernel's TMA map needs 16-byte row strides."""
    vec = 16 // dtype.itemsize
    return -(-N // vec) * vec


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


def _signature(lib: ctypes.CDLL, variant: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if variant == "wgmma":
        fn = lib.streaming_matmul_wgmma
        fn.argtypes = [p, p, p, i, i, i, p]
    else:
        fn = lib.streaming_matmul
        fn.argtypes = [i, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor,
            variant: str | None = None) -> torch.Tensor:
    """Launch the kernel :func:`_variant` picks, or ``variant`` where a
    measurement names one (to time both kernels on the same inputs)."""
    global LAUNCHES
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"streaming_matmul: CUDA kernel takes float32 or bfloat16 with "
            f"x.dtype == w.dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("streaming_matmul: x and w must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    Np = padded_columns(N, w.dtype)
    if Np != N:  # zero columns, dropped from the result below
        w = torch.nn.functional.pad(w, (0, Np - N))
    variant = variant or _variant(x.dtype, K, Np)
    if is_traced(x, w):  # shapes only: the op in the kernel's place
        out = torch.empty((M, Np), dtype=x.dtype, device=x.device)
        torch.ops.repro_torch.b1_matmul(x, w, out)
        # the copy below, through aten: a CPU build's Python indexing
        # refuses a fake CUDA tensor
        return out if Np == N else torch.ops.aten.clone(
            torch.ops.aten.slice(out, 1, 0, N),
            memory_format=torch.contiguous_format)
    if w.data_ptr() % 16:
        raise ValueError("streaming_matmul: the CUDA kernel streams w in "
                         "16-byte vectors; w must be 16-byte aligned")
    if variant == "wgmma" and x.data_ptr() % 16:
        raise ValueError("streaming_matmul: TMA needs x 16-byte aligned")
    out = torch.empty((M, Np), dtype=x.dtype, device=x.device)
    lib = _build.load("streaming_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _signature(lib, variant)
    if variant == "wgmma":
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, Np, K,
                  stream)
    else:
        code = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), M, Np, K, stream)
    _build.check(lib, code, f"streaming_matmul ({variant})")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return out if Np == N else out[:, :N].contiguous()


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product on ``x``'s device: the plain version on the CPU, a kernel
    on a card, an error anywhere else."""
    if w.device != x.device:
        raise ValueError(f"streaming_matmul: x on {x.device}, w on {w.device}")
    if is_traced(x, w):
        return _launch(x, w)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"streaming_matmul: no kernel for device {x.device}")
    return _launch(x, w)


class _StreamingMatmul(torch.autograd.Function):
    """The reference's ``_matmul_vjp``: forward and backward through the
    same kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _matmul(g, w.t().contiguous()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _matmul(x.t().contiguous(), g).to(w.dtype)
        return dx, dw


def streaming_matmul(
    x: torch.Tensor,            # (M, K)
    w: torch.Tensor,            # (K, N)
    *,
    block_m: int = 256,
    block_n: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """``x @ w`` in float32 accumulation, cast to ``x.dtype``;
    differentiable in both arguments.

    ``block_m``, ``block_n`` and ``block_k`` only validate the shapes (the
    reference's contract): the CUDA kernels tile at their own fixed sizes,
    and no block argument changes what they compute or how.
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
    if x.device.type not in ("cpu", "cuda") and not is_traced(x, w):
        raise ValueError(f"streaming_matmul: no kernel for device {x.device}")
    return _StreamingMatmul.apply(x, w)
