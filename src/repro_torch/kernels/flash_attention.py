"""Forward flash attention (blockwise online softmax).

The port of ``repro.kernels.flash_attention``. On CUDA tensors it launches
a hand-written kernel in ``csrc/flash_attention.cu`` (see the note there
for its design and bound); on CPU tensors it computes the plain version,
:func:`repro_torch.kernels.ref.flash_ref`. Which one runs is decided by the
tensors' device alone, and which CUDA kernel by :func:`_variant`, a plain
rule on dtype and head dims: bf16 with D and Dv multiples of 16, D at
most 192 and Dv at most 128, takes the tensor-core kernel (``"wgmma"``),
everything else the CUDA-core one (``"ffma"``).

It supports what the reference kernel does: GQA (K/V head ``h // G``),
causal and sliding-window masks, a value dim ``Dv`` other than ``D`` (MLA),
and cross attention (``Sq != Sk``). The kernel reads q, k and v through
their strides (the last dim contiguous), so the (B,S,H,D) tensors of
:func:`repro_torch.kernels.ops.attention` need no transposed copy; the
tensor-core kernel reads them through TMA maps, which need every stride a
whole number of 16-byte units and 16-byte aligned tensors (checked here).
The backward pass waits for the training slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_ref
from repro_torch.kernels.streaming_matmul import _validate_tiles

#: Launches of the CUDA kernels in this process (the CPU path never counts).
LAUNCHES = 0
#: The same launches by variant (see :func:`_variant`).
VARIANT_LAUNCHES = {"wgmma": 0, "ffma": 0}

#: Largest q/k head dim D the CUDA kernels hold in their tiles: three
#: 64-column boxes (MLA's 128 + 64), and q staged whole for the FFMA kernel.
MAX_D = 192
#: Largest v head dim Dv: the output accumulator held in registers.
MAX_DV = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    """Set :data:`LAUNCHES` and every :data:`VARIANT_LAUNCHES` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    VARIANT_LAUNCHES.update(dict.fromkeys(VARIANT_LAUNCHES, 0))


def _variant(dtype: torch.dtype, D: int, Dv: int) -> str:
    """Which CUDA kernel computes attention with head dims ``D`` (q, k) and
    ``Dv`` (v): ``"wgmma"`` (tensor cores, TMA) for bf16 with both a
    multiple of 16 (one wgmma k-step), D at most :data:`MAX_D` and Dv at
    most :data:`MAX_DV`;
    ``"ffma"`` (CUDA cores) for the rest, float32 included (TF32 would miss
    the reference's float32 tolerance). The ffma kernel raises on what it
    does not take either."""
    if (dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0
            and D <= MAX_D and Dv <= MAX_DV):
        return "wgmma"
    return "ffma"


def _signature(lib: ctypes.CDLL, variant: str):
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    tail = [i] * 7 + [ll] * 12 + [ctypes.c_float, i, i, i, p]
    if variant == "wgmma":
        fn = lib.flash_attention_wgmma
        fn.argtypes = [p, p, p, p] + tail
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [i, p, p, p, p] + tail
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, *, causal, window, scale,
            variant: str | None = None) -> torch.Tensor:
    """Launch the kernel :func:`_variant` picks, or ``variant`` where a
    measurement names one (to time both kernels on the same inputs)."""
    global LAUNCHES
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"flash_attention: CUDA kernel takes float32 or bfloat16 with one "
            f"dtype for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if D % 4 or D > MAX_D or Dv > MAX_DV:
        raise ValueError(
            f"flash_attention: CUDA kernel needs D % 4 == 0, D <= {MAX_D} "
            f"and Dv <= {MAX_DV}; got D={D}, Dv={Dv}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    variant = variant or _variant(q.dtype, D, Dv)
    if variant == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(d) % 8 for d in range(3)):
                raise ValueError(
                    f"flash_attention: TMA needs {name} 16-byte aligned with "
                    f"strides that are multiples of 8 elements; got strides "
                    f"{tuple(t.stride())}")
    # the (B,H,Sq,Dv) result is laid out as (B,Sq,H,Dv) in memory, so the
    # layout wrapper's transpose back is contiguous
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(d) for t in (q, k, v, o) for d in range(3)]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV,
            Sq, Sk, D, Dv, *strides, scale, int(causal),
            int(window is not None), int(window or 0), stream)
    if variant == "ffma":
        args = (_DTYPE_CODE[q.dtype], *args)
    code = _signature(lib, variant)(*args)
    _build.check(lib, code, f"flash_attention ({variant})")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return o


def flash_attention_gpu(
    q: torch.Tensor,    # (B, H, Sq, D)
    k: torch.Tensor,    # (B, KV, Sk, D)
    v: torch.Tensor,    # (B, KV, Sk, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Blockwise flash attention -> (B, H, Sq, Dv); counterpart of
    ``repro.kernels.flash_attention.flash_attention_tpu``.

    ``block_q`` and ``block_k`` only validate the shapes (the reference's
    contract): the CUDA kernels tile at their own fixed sizes (128 query
    rows and 128 keys for wgmma, 64 and 32 for ffma), and no block argument
    changes what they compute or how.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            "flash_attention: expected 4-D (B, H, S, D) tensors, got "
            f"q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or v.shape[0] != B:
        raise ValueError(
            f"flash_attention: batch dims disagree, q={B} k={k.shape[0]} "
            f"v={v.shape[0]}")
    if v.shape[1] != KV or v.shape[2] != Sk:
        raise ValueError(
            f"flash_attention: k has (KV={KV}, Sk={Sk}) but v has "
            f"(KV={v.shape[1]}, Sk={v.shape[2]})")
    if k.shape[3] != D:
        raise ValueError(
            f"flash_attention: head dim D={D} (q) != {k.shape[3]} (k)")
    if H % KV != 0:
        raise ValueError(
            f"flash_attention: H={H} query heads not divisible by KV={KV} "
            f"key/value heads (GQA group size must be integral)")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    _validate_tiles("flash_attention", Sq=(Sq, min(block_q, Sq)),
                    Sk=(Sk, min(block_k, Sk)))
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal=causal, window=window, scale=scale)
