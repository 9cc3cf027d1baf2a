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

A traced tensor (a fake tensor, or one on the ``meta`` device) takes the
card's route on any device, up to the launch, where
:mod:`repro_torch.kernels.traced`'s op stands in for the C entry point.

The backward is the reference's ``_flash_vjp``: :class:`_B2Function`
launches the kernel, which then also writes each row's log-sum-exp, and
its backward launches the backward kernels of
``csrc/flash_attention_bwd.cu`` (:func:`_launch_bwd`, its variant by
:func:`_bwd_variant`) from the saved (q, k, v, o, lse). Their plain
version is :func:`_plain_bwd`, the blocked backward
(:func:`repro_torch.models.flash._flash_bwd`), as the reference's is its
blocked jnp flash's VJP: the backward of CPU tensors. Where the wgmma
dk/dv grid (a CTA per KV head, 128 keys and batch row) would leave the
card short of CTAs, :func:`_bwd_parts` splits each GQA group's heads into
parts whose float32 sums a reduce kernel adds up in order.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_ref
from repro_torch.kernels.streaming_matmul import _validate_tiles
from repro_torch.kernels.traced import is_traced

#: Launches of the CUDA kernels in this process (the CPU path never counts).
LAUNCHES = 0
#: The same launches by variant (see :func:`_variant`).
VARIANT_LAUNCHES = {"wgmma": 0, "ffma": 0}
#: Launches of the backward kernels, one per backward (its delta pre-pass,
#: dk/dv and dq kernels together), and by variant (:func:`_bwd_variant`).
BWD_LAUNCHES = 0
BWD_VARIANT_LAUNCHES = {"wgmma": 0, "ffma": 0}

#: Largest q/k head dim D the CUDA kernels hold in their tiles: three
#: 64-column boxes (MLA's 128 + 64), and q staged whole for the FFMA kernel.
MAX_D = 192
#: Largest v head dim Dv: the output accumulator held in registers.
MAX_DV = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    """Set :data:`LAUNCHES`, :data:`BWD_LAUNCHES` and every count by
    variant to 0."""
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0
    VARIANT_LAUNCHES.update(dict.fromkeys(VARIANT_LAUNCHES, 0))
    BWD_VARIANT_LAUNCHES.update(dict.fromkeys(BWD_VARIANT_LAUNCHES, 0))


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


#: Which backward kernels compute the gradients: the forward's rule. At D
#: past 128 (MLA's 192) the dk/dv kernel's two warpgroups split the products.
_bwd_variant = _variant

#: Keys of a dk/dv CTA of the wgmma backward at D <= 128.
BWD_KEYS = 128


def _bwd_parts(B: int, KV: int, Sk: int, G: int, sms: int, D: int) -> int:
    """Into how many parts the wgmma dk/dv kernel (D <= 128) splits each
    GQA group's ``G`` query heads. Its grid is a CTA per (KV head, 128
    keys, batch row), each streaming the whole group; with few KV heads
    that leaves SMs idle (granite-34b's one KV head at a train batch of 2
    and 2048 keys: 32 CTAs over 48 heads each on ``sms`` = 132). Where the
    grid fills less than two thirds of the SMs the group is cut into
    ``round(2 sms / CTAs)`` parts (about two CTAs an SM), at most ``G``;
    else 1, and the kernel runs as it would unsplit (no scratch, no
    reduce). The D > 128 kernel takes 1, as do the FFMA kernels (the
    wrapper asks this rule for the wgmma variant alone)."""
    ctas = B * KV * -(-Sk // BWD_KEYS)
    if D > 128 or G == 1 or 3 * ctas >= 2 * sms:
        return 1
    return min(G, max(2, round(2 * sms / ctas)))


def part_heads(G: int, parts: int) -> list[range]:
    """The heads of a group of ``G`` that each part's dk/dv CTA streams,
    as ``flash_bwd_dkdv_wgmma`` computes them: part p takes heads
    ``p G / parts`` up to ``(p + 1) G / parts`` (integer division), so the
    parts differ by at most one head."""
    return [range(p * G // parts, (p + 1) * G // parts)
            for p in range(parts)]


def _sm_count(t: torch.Tensor) -> int:
    """The streaming multiprocessors of ``t``'s card, or of the card the
    dry-run models (``launch/mesh.py``'s constants) for a traced tensor."""
    if is_traced(t):
        from repro_torch.launch.mesh import SMS
        return SMS
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _signature(lib: ctypes.CDLL, variant: str):
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    # q, k, v, o and the lse (None passes NULL: no lse written)
    args = [p] * 5 + [i] * 7 + [ll] * 12 + [ctypes.c_float, i, i, i, p]
    if variant == "wgmma":
        fn = lib.flash_attention_wgmma
        fn.argtypes = args
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [i] + args
    fn.restype = ctypes.c_int
    return fn


def _tma_ready(name: str, t: torch.Tensor, traced: bool) -> None:
    """Raise unless TMA can read ``t``: 16-byte aligned, the last dim
    contiguous and the other strides multiples of 8 elements."""
    st = t.stride()
    if (st[3] != 1 or (not traced and t.data_ptr() % 16)
            or any(x % 8 for x in st[:3])):
        raise ValueError(
            f"flash_attention: TMA needs {name} 16-byte aligned with the "
            f"head dim contiguous and strides that are multiples of 8 "
            f"elements; got strides {st}")


def _launch(q, k, v, *, causal, window, scale, variant: str | None = None,
            with_lse: bool = False):
    """Launch the kernel :func:`_variant` picks, or ``variant`` where a
    measurement names one (to time both kernels on the same inputs).
    Returns o, or (o, lse) with ``with_lse``: lse (B, H, Sq) float32, each
    row's log-sum-exp of its scaled scores, as ``_fwd_all`` returns it."""
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
    traced = is_traced(q, k, v)
    if variant == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            _tma_ready(name, t, traced)
    # the (B,H,Sq,Dv) result is laid out as (B,Sq,H,Dv) in memory, so the
    # layout wrapper's transpose back is contiguous
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if traced:  # shapes only: the op in the kernel's place
        torch.ops.repro_torch.b2_flash(q, k, v, o, lse, bool(causal), window,
                                       float(scale))
        return (o, lse) if with_lse else o
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(d) for t in (q, k, v, o) for d in range(3)]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None]
    args = (*ptrs, B, H, KV, Sq, Sk, D, Dv, *strides, scale, int(causal),
            int(window is not None), int(window or 0), stream)
    if variant == "ffma":
        args = (_DTYPE_CODE[q.dtype], *args)
    code = _signature(lib, variant)(*args)
    _build.check(lib, code, f"flash_attention ({variant})")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return (o, lse) if with_lse else o


def _launch_bwd(q, k, v, o, lse, do, *, causal, window, scale,
                variant: str | None = None, parts: int | None = None):
    """Launch the backward kernels on the forward's saved (q, k, v, o,
    lse) and the output's gradient ``do``, the variant
    :func:`_bwd_variant` picks, or ``variant`` where a measurement names
    one (to time both on the same inputs), each group's query heads split
    into the parts :func:`_bwd_parts` picks, or ``parts`` where a
    measurement names them (above 1, a float32 scratch (parts, B, Sk, KV,
    D + Dv) holds the parts' sums). Returns (dq, dk, dv) in the inputs'
    type and layout. ``do`` is copied to a contiguous tensor first where
    its layout does not suit the kernels (autograd may hand over an
    expanded gradient)."""
    global BWD_LAUNCHES
    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype) or (
            q.dtype not in _DTYPE_CODE):
        raise TypeError(
            f"flash_attention backward: the kernels take float32 or bfloat16 "
            f"with one dtype for q, k, v, o and do; got {q.dtype}, {k.dtype}, "
            f"{v.dtype}, {o.dtype}, {do.dtype}")
    if D % 4 or D > MAX_D or Dv > MAX_DV:
        raise ValueError(
            f"flash_attention backward: the kernels need D % 4 == 0, D <= "
            f"{MAX_D} and Dv <= {MAX_DV}; got D={D}, Dv={Dv}")
    if tuple(do.shape) != tuple(o.shape) or tuple(lse.shape) != (B, H, Sq) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(
            f"flash_attention backward: do must be o's shape "
            f"{tuple(o.shape)} and lse (B, H, Sq) float32 contiguous; got "
            f"{tuple(do.shape)} and {tuple(lse.shape)} {lse.dtype}")
    traced = is_traced(q, k, v, o, do)
    variant = variant or _bwd_variant(q.dtype, D, Dv)
    st = do.stride()
    if st[3] != 1 or variant == "wgmma" and (
            any(x % 8 for x in st[:3]) or not traced and do.data_ptr() % 16):
        do = do.contiguous()
    if any(t.stride()[3] != 1 for t in (q, k, v, o)):
        raise ValueError("flash_attention backward: the head dim must be "
                         "contiguous")
    if variant == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            _tma_ready(name, t, traced)
    # each gradient laid out as (B, S, heads, ·) in memory, as o is
    dq, dk, dv = (torch.empty((t.shape[0], t.shape[2], t.shape[1],
                               t.shape[3]), dtype=t.dtype,
                              device=t.device).transpose(1, 2)
                  for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if parts is None:
        parts = (_bwd_parts(B, KV, Sk, H // KV, _sm_count(q), D)
                 if variant == "wgmma" else 1)
    part = (torch.empty((parts, B, Sk, KV, D + Dv), dtype=torch.float32,
                        device=q.device) if parts > 1 else None)
    if traced:  # shapes only: the op in the kernels' place
        torch.ops.repro_torch.b2_flash_bwd(q, k, v, o, lse, do, delta, dq,
                                           dk, dv, bool(causal), window,
                                           float(scale), part)
        return dq, dk, dv
    _call_bwd(variant, (q, k, v, o, do, lse, delta, dq, dk, dv), B, H, KV,
              Sq, Sk, D, Dv, parts, part, causal=causal, window=window,
              scale=scale)
    BWD_LAUNCHES += 1
    BWD_VARIANT_LAUNCHES[variant] += 1
    return dq, dk, dv


def _call_bwd(variant: str, tensors, B, H, KV, Sq, Sk, D, Dv, parts, part,
              *, causal, window, scale) -> None:
    """The C entry point ``flash_attention_bwd`` on (q, k, v, o, do, lse,
    delta, dq, dk, dv), each group's heads in ``parts`` parts summed in the
    scratch ``part`` (None at one part); raises on a CUDA error."""
    q, k, v, o, do, lse, delta, dq, dk, dv = tensors
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [i, i] + [p] * 10 + [i] * 7 + [ll] * 24 + [
        ctypes.c_float, i, i, i, i, p, p]
    fn.restype = ctypes.c_int
    strides = [x for t in (q, k, v, o, do, dq, dk, dv) for x in t.stride()[:3]]
    code = fn(int(variant == "wgmma"), _DTYPE_CODE[q.dtype],
              *(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk,
                                       dv)),
              B, H, KV, Sq, Sk, D, Dv, *strides, float(scale), int(causal),
              int(window is not None), int(window or 0), int(parts),
              None if part is None else part.data_ptr(),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, f"flash_attention backward ({variant})")


def _kernel_route(t: torch.Tensor) -> bool:
    """Whether a backward on ``t`` takes the kernels' route: a CUDA or a
    traced tensor; a CPU tensor takes the plain version."""
    return is_traced(t) or t.device.type == "cuda"


def _plain_bwd(q, k, v, o, lse, do, *, causal, window, scale):
    """The backward of B2 on (B,H,Sq,D) tensors from its saved output and
    lse: the models' blocked ``_flash_bwd`` on the (B,KV,G,Sq,D) layout,
    with K/V padded to whole blocks as :func:`blocked_flash
    <repro_torch.models.flash.blocked_flash>` pads them, the scores
    recomputed in float32 as B2 computes them. Returns (dq, dk, dv) in the
    inputs' types."""
    # lazy, as the reference imports its jnp flash inside _flash_bwd
    from repro_torch.models.flash import (DEFAULT_BLOCK_K, DEFAULT_STRIPS,
                                          MaskSpec, _flash_bwd)

    B, H, Sq, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    block_k = min(DEFAULT_BLOCK_K, Sk)
    pad = (-Sk) % block_k
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad)) if pad else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad)) if pad else v
    spec = MaskSpec(causal=causal, window=window,
                    kv_len=Sk if pad else None)
    res = (q.reshape(B, KV, G, Sq, D), kp, vp, o.reshape(B, KV, G, Sq, Dv),
           lse.reshape(B, KV, G, Sq))
    # B2's lse is of its float32 scores: recompute them so (C2)
    dq, dk, dv = _flash_bwd(spec, scale, block_k, DEFAULT_STRIPS, res,
                            do.reshape(B, KV, G, Sq, Dv), exact_scores=True)
    return dq.reshape(B, H, Sq, D), dk[:, :, :Sk], dv[:, :, :Sk]


class _B2Function(torch.autograd.Function):
    """The counterpart of the reference's ``_flash_vjp``: the forward
    launches B2 (writing the lse too), the backward launches the backward
    kernels (:func:`_launch_bwd`) from the saved (q, k, v, o, lse), or on
    CPU tensors computes their plain version :func:`_plain_bwd`.
    :data:`LAUNCHES` counts one launch per forward, :data:`BWD_LAUNCHES`
    one per backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _launch(q, k, v, causal=causal, window=window, scale=scale,
                         with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        bwd = _launch_bwd if _kernel_route(q) else _plain_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=causal, window=window,
                         scale=scale)
        return dq, dk, dv, None, None, None


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
    traced = is_traced(q, k, v)
    if q.device.type == "cpu" and not traced:
        return flash_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda" and not traced:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _B2Function.apply(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal=causal, window=window, scale=scale)
