"""Mamba2 SSD chunk scan (state-space duality) over precomputed chunk tensors.

The port of ``repro.kernels.ssd_scan``, in three stages laid out as the
reference's plain ``_ssd_scan``: the chunk states (parallel over chunks),
the state passing (in order over chunks), and the chunk output (parallel
over query tiles and chunks). On CUDA tensors each stage is a hand-written
kernel in ``csrc/ssd_scan.cu`` (see the note there for their design and
bound), and :func:`ssd_chunk_scan_gpu` launches all three from one C entry
point; on CPU tensors it composes the stages' plain versions. Which one runs
is decided by the tensors' device alone. :func:`ssd_chunk_scan_plain`, the
one-loop version of what the TPU kernel computes, is the oracle of both. The
chunking and cumsum prep lives in :func:`repro_torch.kernels.ops.ssd_prep`.
A traced tensor (a fake tensor, or one on the ``meta`` device) takes the
card's route on any device, up to the launch, where
:mod:`repro_torch.kernels.traced`'s op stands in for the C entry point.
On a card the scan is differentiable through :class:`_B3Function`: the
kernels forward, and backward the chunk-parallel kernels of the same file
(:func:`_launch_bwd`), whose stage-by-stage plain version is
:func:`ssd_bwd_staged_plain`; on CPU tensors the backward is the plain
staged scan's VJP.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.traced import is_traced

#: Scans run through the CUDA kernels in this process, one per call (the
#: CPU path never counts).
LAUNCHES = 0
#: Launches of each of the three CUDA kernels.
STAGE_LAUNCHES = {"chunk_state": 0, "state_passing": 0, "chunk_output": 0}
#: Backward passes run through the CUDA kernels, one per call of
#: ``ssd_chunk_scan_bwd`` (its four kernels together).
BWD_LAUNCHES = 0

#: Largest head dim and state dim the CUDA kernels' tiles cover
#: (mamba2-130m: 64 and 128).
MAX_HEADDIM = 64
MAX_STATE = 128


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0
    for stage in STAGE_LAUNCHES:
        STAGE_LAUNCHES[stage] = 0


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


def ssd_chunk_state_plain(xc, bc, dtc, cum) -> torch.Tensor:
    """Stage 1: each chunk's own contribution to the carried state,
    ``x^T (w o B)`` with ``w_j = exp(total - cum_j) dt_j``, as
    (B, H, nc, P, N) float32."""
    w = torch.exp(cum[..., -1:] - cum) * dtc                   # (B,H,nc,Q)
    return torch.einsum("bhcjp,bhcjn->bhcpn", xc, w[..., None] * bc)


def ssd_state_passing_plain(states, cum) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: from the chunk states, the state entering each chunk (zero
    for the first) and the state after the last, in order over the chunks:
    ``S <- exp(total_c) S + states[c]``."""
    lam = torch.exp(cum[..., -1])                                # (B,H,nc)
    S = torch.zeros_like(states[:, :, 0])
    entering = torch.empty_like(states)
    for c in range(states.shape[2]):
        entering[:, :, c] = S
        S = lam[:, :, c, None, None] * S + states[:, :, c]
    return entering, S


def ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering) -> torch.Tensor:
    """Stage 3: y of every chunk from its inputs and the state entering it,
    ``(C B^T o L) x + (C S_in^T) o exp(cum)``.

    The causal mask selects *before* the exp: ``exp(cum_i - cum_j)`` of
    j > i overflows once a chunk's decay passes e^88 (a chunk of 256
    reaches it at the reference test's distributions), and the exp's VJP
    would then take 0 x inf. The reference's chunked scan masks after the
    exp and its gradients are NaN there (ROADMAP C7); the values are the
    same bits either way, and so are the gradients wherever the
    reference's are finite."""
    Q = xc.shape[3]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    seg = torch.where(causal, cum[..., :, None] - cum[..., None, :],
                      -torch.inf)
    lmat = torch.exp(seg) * dtc[..., None, :]
    scores = torch.einsum("bhcin,bhcjn->bhcij", cc, bc)
    y_intra = torch.einsum("bhcij,bhcjp->bhcip", scores * lmat, xc)
    y_inter = torch.einsum("bhcin,bhcpn->bhcip", cc, entering)
    return y_intra + y_inter * torch.exp(cum)[..., None]


def ssd_staged_plain(xc, bc, cc, dtc, cum) -> torch.Tensor:
    """The three plain stages composed: what the CUDA kernels compute."""
    entering, _ = ssd_state_passing_plain(
        ssd_chunk_state_plain(xc, bc, dtc, cum), cum)
    return ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering)


def ssd_state_passing_bwd_plain(ds_in, cum) -> torch.Tensor:
    """The state passing in reverse over the chunks. From ``ds_in[c]``,
    the gradient of the state entering chunk c through chunk c's own
    output, ``R[c] = ds_in[c] + exp(total_c) R[c+1]``, and the gradient of
    chunk c's own state ``S_loc[c]`` is ``R[c+1]`` (zero for the last
    chunk). Returns those (B, H, nc, P, N)."""
    lam = torch.exp(cum[..., -1])                                # (B,H,nc)
    R = torch.zeros_like(ds_in[:, :, 0])
    ds_loc = torch.empty_like(ds_in)
    for c in reversed(range(ds_in.shape[2])):
        ds_loc[:, :, c] = R
        R = ds_in[:, :, c] + lam[:, :, c, None, None] * R
    return ds_loc


def ssd_bwd_states_plain(xc, bc, cc, dtc, cum, dy):
    """The backward's first launch: each chunk's own state ``x^T (w o
    B)``, the forward's stage 1 recomputed (:func:`ssd_chunk_state_plain`),
    and ``dS_in[c] = sum_i exp(cum_i) g_i (x) C_i``, the gradient of the
    state entering chunk c through chunk c's own output: the same product
    with exp(cum) weights, g and C in the places of x and B. Returns
    (states, ds_in), (B, H, nc, P, N) each."""
    ds_in = torch.einsum("bhcip,bhcin->bhcpn", dy * torch.exp(cum)[..., None],
                         cc)
    return ssd_chunk_state_plain(xc, bc, dtc, cum), ds_in


def ssd_bwd_passing_plain(states, ds_in, cum):
    """The backward's second launch, one pass per state element: forward
    over the chunks, the states entering each chunk
    (:func:`ssd_state_passing_plain`); then in reverse, dS_loc
    (:func:`ssd_state_passing_bwd_plain`). Returns (entering, ds_loc)."""
    entering, _ = ssd_state_passing_plain(states, cum)
    return entering, ssd_state_passing_bwd_plain(ds_in, cum)


def _intra_terms(xc, bc, cc, dtc, cum, dy):
    """The causal (i >= j) tiles of a chunk both backward kernels
    recompute: the decay E = exp(cum_i - cum_j) (0 above the diagonal,
    selected before the exp), L = E dt_j, the scores C_i . B_j and
    G = g_i . x_j, as (B, H, nc, Q, Q) (i, j)."""
    Q = xc.shape[3]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    E = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              -torch.inf))
    L = E * dtc[..., None, :]
    Sc = torch.einsum("bhcin,bhcjn->bhcij", cc, bc)
    G = torch.einsum("bhcip,bhcjp->bhcij", dy, xc)
    return E, L, Sc, G


def ssd_key_bwd_plain(xc, bc, cc, dtc, cum, dy, entering, ds_loc):
    """The key side of the chunk output's backward and the chunk state's
    backward, per key j of a chunk (one kernel): with M = (C B^T) o L and D = ``ds_loc[c]``,
    w_j = exp(total - cum_j) dt_j and dw_j = x_j^T D B_j,

      dx_j   = sum_{i>=j} M_ij g_i + w_j D B_j
      dB_j   = sum_{i>=j} G_ij L_ij C_i + w_j D^T x_j
      ddt_j  = sum_i G_ij Sc_ij E_ij + dw_j exp(total - cum_j)
      dcum_j = -sum_i G_ij M_ij - dw_j w_j            (its key side)

    and, for the chunk's last position, ``tail`` = sum_j dw_j w_j +
    exp(total) <D, S_in[c]> (the chunk total's gradient through the chunk
    state and the state passing). Returns (dx, dB, ddt, dcum, tail)."""
    E, L, Sc, G = _intra_terms(xc, bc, cc, dtc, cum, dy)
    M = Sc * L
    total = cum[..., -1:]
    w = torch.exp(total - cum) * dtc                             # (B,H,nc,Q)
    DB = torch.einsum("bhcjn,bhcpn->bhcjp", bc, ds_loc)
    dw = (xc * DB).sum(-1)
    dx = torch.einsum("bhcij,bhcip->bhcjp", M, dy) + w[..., None] * DB
    dB = (torch.einsum("bhcij,bhcin->bhcjn", G * L, cc)
          + w[..., None] * torch.einsum("bhcjp,bhcpn->bhcjn", xc, ds_loc))
    ddt = (G * Sc * E).sum(-2) + dw * torch.exp(total - cum)
    dcum = -(G * M).sum(-2) - dw * w
    tail = (dw * w).sum(-1) + torch.exp(total[..., 0]) * (
        ds_loc * entering).sum((-2, -1))
    return dx, dB, ddt, dcum, tail


def ssd_row_bwd_plain(xc, bc, cc, dtc, cum, dy, entering, dcum_key, tail):
    """The row side of the chunk output's backward, per query row i of a
    chunk (one kernel, after the key side): with y_inter_i = exp(cum_i) C_i
    S_in^T,

      dC_i   = exp(cum_i) g_i S_in + sum_{j<=i} G_ij L_ij B_j
      dcum_i = dcum_key_i + g_i . y_inter_i + sum_j G_ij M_ij
               (+ ``tail`` at the chunk's last position).

    Returns (dC, dcum)."""
    E, L, Sc, G = _intra_terms(xc, bc, cc, dtc, cum, dy)
    ec = torch.exp(cum)[..., None]
    dC = (ec * torch.einsum("bhcip,bhcpn->bhcin", dy, entering)
          + torch.einsum("bhcij,bhcjn->bhcin", G * L, bc))
    y_inter = ec * torch.einsum("bhcin,bhcpn->bhcip", cc, entering)
    dcum = dcum_key + (dy * y_inter).sum(-1) + (G * Sc * L).sum(-1)
    dcum[..., -1] += tail
    return dC, dcum


def ssd_bwd_staged_plain(xc, bc, cc, dtc, cum, dy):
    """The backward of :func:`ssd_staged_plain`, launch by launch as the
    backward kernels split it: the chunk states and dS_in
    (:func:`ssd_bwd_states_plain`); the state passing forward and in
    reverse (:func:`ssd_bwd_passing_plain`); the key side with the chunk
    state's backward (:func:`ssd_key_bwd_plain`); the row side
    (:func:`ssd_row_bwd_plain`). Returns (dx, dB, dC, ddt, dcum), the
    gradients of the five inputs."""
    entering, ds_loc = ssd_bwd_passing_plain(
        *ssd_bwd_states_plain(xc, bc, cc, dtc, cum, dy), cum)
    dx, dB, ddt, dcum_key, tail = ssd_key_bwd_plain(
        xc, bc, cc, dtc, cum, dy, entering, ds_loc)
    dC, dcum = ssd_row_bwd_plain(xc, bc, cc, dtc, cum, dy, entering,
                                 dcum_key, tail)
    return dx, dB, dC, ddt, dcum


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


def _validate_states(states, xc, bc) -> None:
    want = (*xc.shape[:3], xc.shape[-1], bc.shape[-1])
    if tuple(states.shape) != want:
        raise ValueError(f"ssd states: expected (B,H,nc,P,N) = {want}, got "
                         f"{tuple(states.shape)}")
    if states.dtype != torch.float32 or states.device != xc.device:
        raise ValueError(f"ssd states: expected float32 on {xc.device}, got "
                         f"{states.dtype} on {states.device}")


def _checked(xc, bc, *tensors) -> tuple[int, ...]:
    """The C interface's (BH, nc, Q, P, N), after the CUDA kernels' own
    limits: P, N and contiguity."""
    B, H, nc, Q, P = xc.shape
    N = bc.shape[-1]
    if P > MAX_HEADDIM or N > MAX_STATE:
        raise ValueError(
            f"ssd_chunk_scan: the CUDA kernels take P <= {MAX_HEADDIM} and "
            f"N <= {MAX_STATE}, got P={P}, N={N}")
    if not all(t.is_contiguous() for t in (xc, bc, *tensors)):
        raise ValueError("ssd_chunk_scan: the CUDA kernels take contiguous "
                         "inputs")
    return B * H, nc, Q, P, N


def _call(entry: str, pointers, dims, device) -> None:
    """One C entry point of the library: pointers (tensors or None), then
    the five ints, then the stream."""
    lib = _build.load("ssd_scan")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(device).cuda_stream
    code = fn(*(None if t is None else t.data_ptr() for t in pointers), *dims,
              stream)
    _build.check(lib, code, entry)


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device.type == "cuda"


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise where a stage kernel's launch would drop a gradient: the
    kernels are launched through ctypes, so their outputs carry no
    ``grad_fn``. Called by the three per-stage entry points on the card
    path only; the fused scan (:func:`ssd_chunk_scan_gpu`) is the one with
    a backward (:class:`_B3Function`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: an input requires grad on a card; the per-stage SSD "
            f"kernels have no backward: the fused scan ssd_chunk_scan_gpu "
            f"is the one with a backward")


def ssd_chunk_state_gpu(xc, bc, dtc, cum) -> torch.Tensor:
    """Stage 1 (:func:`ssd_chunk_state_plain`): kernel 1 on a card."""
    _validate(xc, bc, bc, dtc, cum)
    if not _on_cuda("ssd_chunk_state", xc):
        return ssd_chunk_state_plain(xc, bc, dtc, cum)
    refuse_autograd("ssd_chunk_state", xc, bc, dtc, cum)
    dims = _checked(xc, bc, dtc, cum)
    states = xc.new_empty((*xc.shape[:3], dims[3], dims[4]))
    _call("ssd_chunk_state", (xc, bc, dtc, cum, states), dims, xc.device)
    STAGE_LAUNCHES["chunk_state"] += 1
    return states


def ssd_state_passing_gpu(states, cum) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 (:func:`ssd_state_passing_plain`): kernel 2 on a card, run
    over a copy of ``states`` (the scan itself runs it in place)."""
    if (states.ndim != 5 or cum.ndim != 4
            or tuple(cum.shape[:3]) != tuple(states.shape[:3])):
        raise ValueError(f"ssd_state_passing: states (B,H,nc,P,N) "
                         f"{tuple(states.shape)} and cum (B,H,nc,Q) "
                         f"{tuple(cum.shape)} disagree")
    if states.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"ssd_state_passing: states and cum must be float32, "
                        f"got {states.dtype} and {cum.dtype}")
    if cum.device != states.device:
        raise ValueError(f"ssd_state_passing: states on {states.device}, cum "
                         f"on {cum.device}")
    if not _on_cuda("ssd_state_passing", states):
        return ssd_state_passing_plain(states, cum)
    refuse_autograd("ssd_state_passing", states, cum)
    B, H, nc, P, N = states.shape
    entering = states.contiguous().clone()
    final = states.new_empty((B, H, P, N))
    _call("ssd_state_passing", (entering, cum.contiguous(), final),
          (B * H, nc, cum.shape[-1], P, N), states.device)
    STAGE_LAUNCHES["state_passing"] += 1
    return entering, final


def ssd_chunk_output_gpu(xc, bc, cc, dtc, cum, entering) -> torch.Tensor:
    """Stage 3 (:func:`ssd_chunk_output_plain`): kernel 3 on a card."""
    _validate(xc, bc, cc, dtc, cum)
    _validate_states(entering, xc, bc)
    if not _on_cuda("ssd_chunk_output", xc):
        return ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering)
    refuse_autograd("ssd_chunk_output", xc, bc, cc, dtc, cum, entering)
    dims = _checked(xc, bc, cc, dtc, cum, entering)
    y = torch.empty_like(xc)
    _call("ssd_chunk_output", (xc, bc, cc, dtc, cum, entering, y), dims,
          xc.device)
    STAGE_LAUNCHES["chunk_output"] += 1
    return y


def _launch(xc, bc, cc, dtc, cum) -> torch.Tensor:
    global LAUNCHES
    dims = _checked(xc, bc, cc, dtc, cum)
    # the kernels' scratch: each chunk's state, then the state entering it
    states = xc.new_empty((*xc.shape[:3], dims[3], dims[4]))
    y = torch.empty_like(xc)
    if is_traced(xc):  # shapes only: the op in the kernels' place
        torch.ops.repro_torch.b3_scan(xc, bc, cc, dtc, cum, states, y)
        return y
    _call("ssd_chunk_scan_staged", (xc, bc, cc, dtc, cum, states, y), dims,
          xc.device)
    LAUNCHES += 1
    for stage in STAGE_LAUNCHES:
        STAGE_LAUNCHES[stage] += 1
    return y


def _launch_bwd(xc, bc, cc, dtc, cum, dy):
    """Launch the backward kernels (``ssd_chunk_scan_bwd``) on the scan's
    five inputs and ``dy``: (dx, dB, dC, ddt, dcum), the five inputs'
    gradients. The wrapper allocates the kernels' scratch: the states
    entering each chunk and their gradients (B, H, nc, P, N), and per
    position and per chunk the chunk total's terms."""
    global BWD_LAUNCHES
    dims = _checked(xc, bc, cc, dtc, cum)
    if tuple(dy.shape) != tuple(xc.shape) or dy.dtype != torch.float32:
        raise ValueError(f"ssd_chunk_scan backward: dy must be float32 "
                         f"{tuple(xc.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    dy = dy.contiguous()
    states = xc.new_empty((*xc.shape[:3], dims[3], dims[4]))
    dstates = torch.empty_like(states)
    tw = torch.empty_like(cum)
    lam_dot = cum.new_empty(cum.shape[:3])
    grads = tuple(torch.empty_like(t) for t in (xc, bc, cc, dtc, cum))
    if is_traced(xc):  # shapes only: the op in the kernels' place
        torch.ops.repro_torch.b3_scan_bwd(xc, bc, cc, dtc, cum, dy, states,
                                          dstates, tw, lam_dot, *grads)
        return grads
    _call("ssd_chunk_scan_bwd", (xc, bc, cc, dtc, cum, dy, states, dstates,
                                 tw, lam_dot, *grads), dims, xc.device)
    BWD_LAUNCHES += 1
    return grads


def _kernel_route(t: torch.Tensor) -> bool:
    """Whether the backward of a scan on ``t`` takes the kernels' route: a
    CUDA or a traced tensor; a CPU tensor takes the plain VJP."""
    return is_traced(t) or t.device.type == "cuda"


class _B3Function(torch.autograd.Function):
    """The scan on the card with a backward: the forward launches the
    three kernels (:func:`_launch`) and saves only the five inputs; the
    backward launches the backward kernels (:func:`_launch_bwd`) at those
    inputs, or on CPU tensors takes the VJP of the plain staged scan
    (:func:`ssd_staged_plain`), recomputed under autograd: the kernels'
    plain version. The reference defines no VJP for its Pallas kernel and
    trains through its plain chunked scan, so this is its gradient.
    :data:`LAUNCHES` counts one launch per forward (and one per recompute
    under a checkpoint), :data:`BWD_LAUNCHES` one per backward."""

    @staticmethod
    def forward(ctx, xc, bc, cc, dtc, cum):
        ctx.save_for_backward(xc, bc, cc, dtc, cum)
        return _launch(xc, bc, cc, dtc, cum)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad
        saved = ctx.saved_tensors  # once: a checkpoint unpacks them once
        if _kernel_route(saved[0]):
            grads = _launch_bwd(*saved, dy)
            return tuple(g if n else None for g, n in zip(grads, need))
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            y = ssd_staged_plain(*ins)
            got = iter(torch.autograd.grad(
                y, [t for t, n in zip(ins, need) if n], dy))
        return tuple(next(got) if n else None for n in need)


def ssd_chunk_scan_gpu(
    xc: torch.Tensor,    # (B, H, nc, Q, P)
    bc: torch.Tensor,    # (B, H, nc, Q, N)  (per-head broadcast B)
    cc: torch.Tensor,    # (B, H, nc, Q, N)
    dtc: torch.Tensor,   # (B, H, nc, Q)     softplus'd dt
    cum: torch.Tensor,   # (B, H, nc, Q)     inclusive cumsum of dt*A
) -> torch.Tensor:
    """SSD chunk scan -> y (B, H, nc, Q, P), all float32, the state starting
    at zero in each (batch, head). On a card the scan goes through
    :class:`_B3Function`: a grad-requiring input gives a ``y`` whose
    backward launches the backward kernels (:func:`_launch_bwd`)."""
    _validate(xc, bc, cc, dtc, cum)
    if not is_traced(xc) and not _on_cuda("ssd_chunk_scan", xc):
        return ssd_staged_plain(xc, bc, cc, dtc, cum)
    return _B3Function.apply(xc, bc, cc, dtc, cum)
