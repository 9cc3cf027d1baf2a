"""Each kernel as a registered op, for tensors that hold no data.

A trace of the card's path (:mod:`repro_torch.launch.hlo_analysis`) runs on
fake tensors (``FakeTensorMode``) or on the ``meta`` device: shapes, types
and devices, no storage. The kernels launch through ctypes on
``data_ptr()``, which such a tensor lacks. So each wrapper, given a traced
tensor on any device, allocates what its launch allocates (the output, the
lse, the scratch) and then calls the kernel's op here instead of the C
entry point: the op writes into those tensors, as the entry point does,
and its fake impl writes nothing. Each op registers its operation count
from :mod:`repro_torch.kernels.work` with ``torch.utils.flop_counter``, so
a trace counts the kernels' FLOPs from the same count as the kernels'
bounds in ``chip_smoke.py``. A real tensor never reaches these ops.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import work


def is_traced(*tensors: torch.Tensor) -> bool:
    """Whether any of ``tensors`` is a fake tensor or on the ``meta``
    device: a trace, with no data to launch a kernel on."""
    return any(isinstance(t, FakeTensor) or t.device.type == "meta"
               for t in tensors if t is not None)


@torch.library.custom_op("repro_torch::b1_matmul", mutates_args=("out",))
def b1_matmul(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """B1 (``csrc/streaming_matmul.cu``): ``out = x @ w``, w already
    padded to ``out``'s columns."""
    raise RuntimeError("b1_matmul: a traced op; real tensors launch the "
                       "kernel through streaming_matmul._launch")


@b1_matmul.register_fake
def _(x, w, out) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.b1_matmul)
def _b1_flops(x_shape, w_shape, out_shape_arg, *, out_shape=None,
              **_kw) -> float:
    M, K = x_shape
    return work.matmul_work(M, w_shape[1], K, 1)[0]


@torch.library.custom_op("repro_torch::b2_flash", mutates_args=("o", "lse"))
def b2_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor | None, causal: bool,
             window: int | None, scale: float) -> None:
    """B2 (``csrc/flash_attention.cu``): o (and the lse, when given) of
    (B, H, Sq, D) q over (B, KV, Sk, ·) k and v."""
    raise RuntimeError("b2_flash: a traced op; real tensors launch the "
                       "kernel through flash_attention._launch")


@b2_flash.register_fake
def _(q, k, v, o, lse, causal, window, scale) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.b2_flash)
def _b2_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, causal, window,
              scale, *, out_shape=None, **_kw) -> float:
    B, H, Sq, D = q_shape
    KV, Sk, Dv = k_shape[1], k_shape[2], v_shape[3]
    return work.flash_work(B, H, Sq, Sk, KV, D, Dv, causal=causal,
                           window=window, itemsize=1)[0]


@torch.library.custom_op("repro_torch::b2_flash_bwd",
                         mutates_args=("delta", "dq", "dk", "dv", "part"))
def b2_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 delta: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                 dv: torch.Tensor, causal: bool, window: int | None,
                 scale: float, part: torch.Tensor | None) -> None:
    """B2's backward (``csrc/flash_attention_bwd.cu``): dq, dk, dv (and
    the delta scratch, and where a group's heads are split the parts'
    scratch ``part``, None at one part) from the forward's (q, k, v, o,
    lse) and do. ``part`` has no default: a dispatcher that drops a
    trailing argument equal to its default (torch 2.11's) would leave the
    mutated-argument bookkeeping an argument short."""
    raise RuntimeError("b2_flash_bwd: a traced op; real tensors launch the "
                       "kernels through flash_attention._launch_bwd")


@b2_flash_bwd.register_fake
def _(q, k, v, o, lse, do, delta, dq, dk, dv, causal, window, scale,
      part) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.b2_flash_bwd)
def _b2_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
                  delta_shape, dq_shape, dk_shape, dv_shape, causal, window,
                  scale, part_shape, *, out_shape=None, **_kw) -> float:
    B, H, Sq, D = q_shape
    KV, Sk, Dv = k_shape[1], k_shape[2], v_shape[3]
    return work.flash_bwd_work(B, H, Sq, Sk, KV, D, Dv, causal=causal,
                               window=window, itemsize=1)[0]


@torch.library.custom_op("repro_torch::b3_scan",
                         mutates_args=("states", "y"))
def b3_scan(xc: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor,
            dtc: torch.Tensor, cum: torch.Tensor, states: torch.Tensor,
            y: torch.Tensor) -> None:
    """B3 (``csrc/ssd_scan.cu``, its three kernels from one entry point):
    y of the (B, H, nc, Q, ·) chunks, ``states`` its scratch."""
    raise RuntimeError("b3_scan: a traced op; real tensors launch the "
                       "kernels through ssd_scan._launch")


@b3_scan.register_fake
def _(xc, bc, cc, dtc, cum, states, y) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.b3_scan)
def _b3_flops(xc_shape, bc_shape, *_shapes, out_shape=None,
              **_kw) -> float:
    return work.ssd_work(*xc_shape, bc_shape[-1])[0]


@torch.library.custom_op("repro_torch::b3_scan_bwd",
                         mutates_args=("states", "dstates", "tw", "lam_dot",
                                       "dx", "db", "dc", "ddt", "dcum"))
def b3_scan_bwd(xc: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor,
                dtc: torch.Tensor, cum: torch.Tensor, dy: torch.Tensor,
                states: torch.Tensor, dstates: torch.Tensor, tw: torch.Tensor,
                lam_dot: torch.Tensor, dx: torch.Tensor, db: torch.Tensor,
                dc: torch.Tensor, ddt: torch.Tensor,
                dcum: torch.Tensor) -> None:
    """B3's backward (``csrc/ssd_scan.cu``'s ``ssd_chunk_scan_bwd``): the
    five inputs' gradients from dy, with its scratch."""
    raise RuntimeError("b3_scan_bwd: a traced op; real tensors launch the "
                       "kernels through ssd_scan._launch_bwd")


@b3_scan_bwd.register_fake
def _(xc, bc, cc, dtc, cum, dy, states, dstates, tw, lam_dot, dx, db, dc,
      ddt, dcum) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.b3_scan_bwd)
def _b3_bwd_flops(xc_shape, bc_shape, *_shapes, out_shape=None,
                  **_kw) -> float:
    return work.ssd_bwd_work(*xc_shape, bc_shape[-1])[0]
