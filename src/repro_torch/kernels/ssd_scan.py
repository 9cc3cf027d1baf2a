"""Mamba2 SSD chunk scan (state-space duality) over precomputed chunk tensors.

The port of ``repro.kernels.ssd_scan``. On CUDA tensors it launches the
hand-written kernel in ``csrc/ssd_scan.cu`` (see the note there for its
design and bound); on CPU tensors it computes the plain version,
:func:`ssd_chunk_scan_plain`. Which one runs is decided by the tensors'
device alone. The chunking and cumsum prep lives in
:func:`repro_torch.kernels.ops.ssd`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: Launches of the CUDA kernel in this process (the CPU path never counts).
LAUNCHES = 0

#: Largest head dim and state dim the CUDA kernel's thread layout covers
#: (mamba2-130m: 64 and 128).
MAX_HEADDIM = 64
MAX_STATE = 128


def ssd_chunk_scan_plain(xc, bc, cc, dtc, cum) -> torch.Tensor:
    """What the TPU kernel computes, as a torch loop over the chunks.

    Shapes as :func:`ssd_chunk_scan_gpu`. The (P, N) state is carried from
    chunk to chunk in float32; the causal mask selects (``torch.where``), so
    the overflowing ``exp(cum_i - cum_j)`` of j > i never meets a zero.
    """
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=xc.device)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    ys = []
    for c in range(nc):
        x, bm, cm, dt, cu = (t[:, :, c].float() for t in (xc, bc, cc, dtc, cum))
        total = cu[..., -1:]                                        # (B,H,1)
        scores = torch.einsum("bhin,bhjn->bhij", cm, bm)
        lmat = torch.exp(cu[..., :, None] - cu[..., None, :]) * dt[..., None, :]
        lmat = torch.where(causal, lmat, 0.0)
        y_intra = torch.einsum("bhij,bhjp->bhip", scores * lmat, x)
        y_inter = torch.einsum("bhin,bhpn->bhip", cm, state) * torch.exp(
            cu)[..., None]
        decay_out = (torch.exp(total - cu) * dt)[..., None] * bm     # (B,H,Q,N)
        s_local = torch.einsum("bhjp,bhjn->bhpn", x, decay_out)
        state = torch.exp(total)[..., None] * state + s_local
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=2)


def _validate(xc, bc, cc, dtc, cum) -> None:
    if xc.ndim != 5 or bc.ndim != 5:
        raise ValueError(
            f"ssd_chunk_scan: expected xc (B,H,nc,Q,P) and bc/cc (B,H,nc,Q,N), "
            f"got {tuple(xc.shape)} and {tuple(bc.shape)}")
    lead = tuple(xc.shape[:4])
    if tuple(bc.shape[:4]) != lead or tuple(cc.shape) != tuple(bc.shape):
        raise ValueError(
            f"ssd_chunk_scan: bc {tuple(bc.shape)} and cc {tuple(cc.shape)} "
            f"must both be (B,H,nc,Q,N) with (B,H,nc,Q) = {lead}")
    for name, t in (("dtc", dtc), ("cum", cum)):
        if tuple(t.shape) != lead:
            raise ValueError(
                f"ssd_chunk_scan: {name} must be (B,H,nc,Q) = {lead}, got "
                f"{tuple(t.shape)}")
    if min(xc.shape) < 1 or bc.shape[-1] < 1:
        raise ValueError(f"ssd_chunk_scan: empty input {tuple(xc.shape)}")
    for name, t in (("xc", xc), ("bc", bc), ("cc", cc), ("dtc", dtc),
                    ("cum", cum)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"ssd_chunk_scan: {name} must be float32 (ops.ssd casts the "
                f"chunk tensors), got {t.dtype}")
        if t.device != xc.device:
            raise ValueError(
                f"ssd_chunk_scan: xc on {xc.device}, {name} on {t.device}")


def _signature(lib: ctypes.CDLL):
    fn = lib.ssd_chunk_scan
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 5 + [p]
    return fn


def _launch(xc, bc, cc, dtc, cum) -> torch.Tensor:
    global LAUNCHES
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    if P > MAX_HEADDIM or N > MAX_STATE:
        raise ValueError(
            f"ssd_chunk_scan: the CUDA kernel takes P <= {MAX_HEADDIM} and "
            f"N <= {MAX_STATE}, got P={P}, N={N}")
    if not all(t.is_contiguous() for t in (xc, bc, cc, dtc, cum)):
        raise ValueError("ssd_chunk_scan: the CUDA kernel takes contiguous "
                         "inputs")
    y = torch.empty_like(xc)
    lib = _build.load("ssd_scan")
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    code = _signature(lib)(xc.data_ptr(), bc.data_ptr(), cc.data_ptr(),
                           dtc.data_ptr(), cum.data_ptr(), y.data_ptr(),
                           B * H, nc, Q, P, N, stream)
    _build.check(lib, code, "ssd_chunk_scan")
    LAUNCHES += 1
    return y


def ssd_chunk_scan_gpu(
    xc: torch.Tensor,    # (B, H, nc, Q, P)
    bc: torch.Tensor,    # (B, H, nc, Q, N)  (per-head broadcast B)
    cc: torch.Tensor,    # (B, H, nc, Q, N)
    dtc: torch.Tensor,   # (B, H, nc, Q)     softplus'd dt
    cum: torch.Tensor,   # (B, H, nc, Q)     inclusive cumsum of dt*A
) -> torch.Tensor:
    """SSD chunk scan -> y (B, H, nc, Q, P), all float32, the state starting
    at zero in each (batch, head)."""
    _validate(xc, bc, cc, dtc, cum)
    if xc.device.type == "cpu":
        return ssd_chunk_scan_plain(xc, bc, cc, dtc, cum)
    if xc.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: no kernel for device {xc.device}")
    return _launch(xc, bc, cc, dtc, cum)
