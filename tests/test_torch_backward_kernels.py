"""The backward kernels of B2 (``csrc/flash_attention_bwd.cu``) and B3
(``csrc/ssd_scan.cu``'s ``ssd_chunk_scan_bwd``) as far as the CPU reaches
them: their wrappers' argument checks and route rules, the traced route on
meta and fake tensors (shapes, the registered op, its operations; no
launch), and ``BWD_LAUNCHES`` counting one launch per backward through a
stand-in for the C entry point that computes the plain version. The kernels
themselves run only on a card (``chip_smoke.py``'s ``[train]``).

B3's backward is also checked as the kernels split it: the plain
stage-by-stage :func:`ssd_bwd_staged_plain` against autograd of
``ssd_staged_plain`` and, through ``ops.ssd_prep``, against ``jax.grad`` of
the reference's chunked scan (``repro.models.ssm._ssd_scan``), in float32.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import ssm as ref_ssm

from repro_torch.kernels import _build, ops, ref, work
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import flash

from _torch_model_parity import one_torch_thread  # noqa: F401


@pytest.fixture
def no_launch(monkeypatch):
    """Loading a kernel library (the first step of every launch) fails."""
    def refuse(*_a, **_k):
        raise AssertionError("a call reached a kernel launch")

    monkeypatch.setattr(_build, "load", refuse)
    counts = (fa.BWD_LAUNCHES, ssd.BWD_LAUNCHES)
    yield
    assert (fa.BWD_LAUNCHES, ssd.BWD_LAUNCHES) == counts


# -- B2 ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 64, 128, "wgmma"), (torch.bfloat16, 192, 128, "wgmma"),
    (torch.bfloat16, 192, 64, "wgmma"), (torch.bfloat16, 176, 128, "wgmma"),
    (torch.bfloat16, 96, 64, "wgmma"), (torch.bfloat16, 72, 64, "ffma"),
    (torch.float32, 128, 128, "ffma"), (torch.float32, 64, 64, "ffma")])
def test_b2_bwd_variant_rule(dtype, D, Dv, want):
    """The forward's rule: bf16 with D and Dv multiples of 16, D at most
    192 (MLA's; 176 padded to 192 as the forward pads it) and Dv at most
    128 takes the tensor cores; other widths and float32 the CUDA-core
    kernels."""
    assert fa._bwd_variant(dtype, D, Dv) == want
    assert fa._bwd_variant(dtype, D, Dv) == fa._variant(dtype, D, Dv)


@pytest.mark.parametrize("D,Dv,gflop", [(128, 128, 171.9), (192, 128, 893.8)])
def test_b2_bwd_work_counts_each_product_over_its_width(D, Dv, gflop):
    """The backward's operations at granite-8b's train shape (B 2, H 32,
    KV 8) and MLA's (B 2, H 128, KV 128), S 2048 causal: S = q kᵀ, dQ =
    dS k and dK = dSᵀ q over D, dP = dO vᵀ and dV = Pᵀ dO over Dv, two
    operations a live pair and width each; 2.5 x the forward's at D = Dv."""
    H, KV = (32, 8) if D == Dv else (128, 128)
    kw = dict(causal=True, window=None, itemsize=2)
    flops, nbytes = work.flash_bwd_work(2, H, 2048, 2048, KV, D, Dv, **kw)
    live = 2 * H * 2048 * 2049 / 2
    assert flops == sum(2.0 * live * w for w in (D, D, D, Dv, Dv))
    assert round(flops / 1e9, 1) == gflop
    fwd = work.flash_work(2, H, 2048, 2048, KV, D, Dv, **kw)[0]
    assert (flops == 2.5 * fwd) == (D == Dv)
    assert nbytes == 2 * 2 * (2 * H * 2048 * (D + Dv) + 2 * KV * 2048
                              * (D + Dv)) + 2 * H * 2048 * 4


def _b2_tensors(B=1, H=4, KV=2, S=64, D=32, Dv=32, dtype=torch.bfloat16,
                device="cpu"):
    q = torch.zeros((B, S, H, D), dtype=dtype, device=device).transpose(1, 2)
    k = torch.zeros((B, S, KV, D), dtype=dtype, device=device).transpose(1, 2)
    v = torch.zeros((B, S, KV, Dv), dtype=dtype,
                    device=device).transpose(1, 2)
    o = torch.zeros((B, S, H, Dv), dtype=dtype, device=device).transpose(1, 2)
    lse = torch.zeros((B, H, S), device=device)
    return q, k, v, o, lse, torch.zeros_like(o)


def test_b2_bwd_argument_checks(no_launch):
    """The wrapper raises on what the kernels do not take, before any
    launch: mixed dtypes, a head dim past 192, an lse of another shape,
    and (tensor cores) a stride TMA cannot read."""
    q, k, v, o, lse, do = _b2_tensors()
    kw = dict(causal=True, window=None, scale=0.1)
    with pytest.raises(TypeError, match="one dtype"):
        fa._launch_bwd(q.float(), k, v, o, lse, do, **kw)
    with pytest.raises(ValueError, match="D <= 192"):
        big = torch.zeros((1, 4, 64, 200), dtype=torch.bfloat16)
        fa._launch_bwd(big, big[:, :2], v, o, lse, do, **kw)
    with pytest.raises(ValueError, match="lse"):
        fa._launch_bwd(q, k, v, o, lse[:, :, :8], do, **kw)
    wide = torch.zeros((1, 64, 4, 36), dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="TMA"):
        fa._launch_bwd(wide.transpose(1, 2), k, v, o, lse, do, **kw)


@pytest.mark.parametrize("device", ["meta", "cpu", "cuda"])
@pytest.mark.parametrize("dtype,D,Dv", [(torch.bfloat16, 32, 32),
                                        (torch.float32, 36, 20)])
def test_b2_bwd_traced_route(no_launch, device, dtype, D, Dv):
    """On a meta tensor, and on fake CPU and CUDA tensors under the trace
    analysis: dq, dk and dv of the inputs' shapes, types and devices in the
    (B, S, heads, ·) memory layout the launch allocates, and one
    registered backward op with the kernels' operation count."""
    B, H_, KV, S = 2, 8, 2, 64
    kw = dict(causal=True, window=24, scale=0.1)
    if device == "meta":
        ins = _b2_tensors(B, H_, KV, S, D, Dv, dtype, "meta")
        grads = fa._launch_bwd(*ins, **kw)
        a = None
    else:
        tr = H.Tracer()
        with tr:
            ins = _b2_tensors(B, H_, KV, S, D, Dv, dtype, device)
        out = {}
        a = H.analyze(lambda *t: out.setdefault(
            "g", fa._launch_bwd(*t, **kw)), *ins)
        grads = out["g"]
    for g, t in zip(grads, ins[:3]):
        assert tuple(g.shape) == tuple(t.shape) and g.dtype == t.dtype
        assert g.device.type == device
        assert g.stride(1) == t.shape[3]  # (B, S, heads, ·) in memory
    if a is not None:
        assert a.launches("repro_torch.b2_flash_bwd") == 1
        assert a.flops == work.flash_bwd_work(B, H_, S, S, KV, D, Dv,
                                              causal=True, window=24,
                                              itemsize=2)[0]


def test_b2_bwd_launches_count_one_per_backward(monkeypatch):
    """``_B2Function`` on the kernels' route, the forward stood in for by
    the plain forward's (o, lse) and the backward's C entry point by the
    plain backward written into the kernels' outputs: each backward counts
    one launch (and one of its variant), and its gradients are the plain
    version's bits."""
    def fake_launch(q, k, v, *, causal, window, scale, with_lse=False):
        B_, H_, Sq, D = q.shape
        KV = k.shape[1]
        o, lse = flash._fwd_all(q.reshape(B_, KV, H_ // KV, Sq, D), k, v,
                                flash.MaskSpec(causal=causal, window=window),
                                scale, k.shape[2], 8)
        o = o.reshape(B_, H_, Sq, v.shape[3])
        return (o, lse.reshape(B_, H_, Sq)) if with_lse else o

    def fake_call(variant, tensors, *_dims, causal, window, scale):
        q, k, v, o, do, lse, _delta, dq, dk, dv = tensors
        for out, g in zip((dq, dk, dv), fa._plain_bwd(
                q, k, v, o, lse, do, causal=causal, window=window,
                scale=scale)):
            out.copy_(g)

    monkeypatch.setattr(fa, "_launch", fake_launch)
    monkeypatch.setattr(fa, "_call_bwd", fake_call)
    monkeypatch.setattr(fa, "_kernel_route", lambda t: True)
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((1, 4, 32, 16), (1, 2, 32, 16),
                               (1, 2, 32, 16), (1, 4, 32, 16)))
    scale = 1.0 / math.sqrt(16)
    fa.reset_launches()
    for n in range(1, 4):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa._B2Function.apply(*ins, True, None, scale)
        got = torch.autograd.grad(o, ins, do)
        assert fa.BWD_LAUNCHES == n and fa.BWD_VARIANT_LAUNCHES == {
            "wgmma": 0, "ffma": n}
    o_p, lse_p = fake_launch(q, k, v, causal=True, window=None, scale=scale,
                             with_lse=True)
    want = fa._plain_bwd(q, k, v, o_p, lse_p, do, causal=True, window=None,
                         scale=scale)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fa.reset_launches()
    assert fa.BWD_LAUNCHES == 0


# -- B2's dk/dv grid split by the heads of a group -------------------------------

# (B, KV, Sk, G, D) of every B2 backward the card runs: the train steps'
# attentions at a batch of 2 (mixtral's window at 1 x 8192) and the three
# short grids of the configurations with few KV heads
_GRIDS = {"granite-8b": (2, 8, 2048, 4, 128),
          "zamba2-1.2b": (2, 32, 2048, 1, 64),
          "seamless decoder": (2, 16, 512, 1, 64),
          "seamless encoder and cross": (2, 16, 1024, 1, 64),
          "mixtral-8x7b window": (1, 8, 8192, 4, 128),
          "deepseek-v3 MLA": (2, 128, 2048, 1, 192),
          "starcoder2-7b": (2, 4, 2048, 9, 128),
          "internvl2-1b": (2, 2, 2304, 7, 64),
          "glm4-9b": (2, 2, 2048, 16, 128),
          "granite-34b": (2, 1, 2048, 48, 128)}
_SPLIT = {"internvl2-1b": 4, "glm4-9b": 4, "granite-34b": 8}


@pytest.mark.parametrize("name", list(_GRIDS))
def test_b2_bwd_parts_rule(name):
    """One part wherever the dk/dv grid fills two thirds of the 132 SMs
    (128 CTAs and more) or the kernel is the D > 128 one; at the three
    short grids (72, 64 and 32 CTAs) about two CTAs an SM."""
    B, KV, Sk, G, D = _GRIDS[name]
    parts = fa._bwd_parts(B, KV, Sk, G, 132, D)
    assert parts == _SPLIT.get(name, 1)
    ctas = B * KV * -(-Sk // fa.BWD_KEYS) * parts
    assert parts == 1 or 1.5 * 132 <= ctas <= 2.5 * 132


@pytest.mark.parametrize("G,parts", [(7, 4), (16, 4), (48, 8), (4, 1),
                                     (9, 9), (5, 3)])
def test_b2_bwd_parts_cover_each_head_once(G, parts):
    """The parts' heads are a partition of the group, in order, each part
    one head at least and at most one more than another."""
    heads = fa.part_heads(G, parts)
    assert [h for r in heads for h in r] == list(range(G))
    sizes = [len(r) for r in heads]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op dispatched while open, with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((str(func), args))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("H_,KV,S,D,parts", [(48, 1, 2048, 128, 8),
                                             (14, 2, 2304, 64, 4),
                                             (32, 8, 2048, 128, 1)])
def test_b2_bwd_traced_route_allocates_the_parts_scratch(no_launch, H_, KV,
                                                         S, D, parts):
    """On meta tensors at a train shape (batch 2) the wrapper picks the
    parts with the modelled card's SM count and hands the traced op a
    float32 scratch (parts, B, Sk, KV, D + Dv) on ``meta``, or none at one
    part."""
    ins = _b2_tensors(2, H_, KV, S, D, D, torch.bfloat16, "meta")
    with _Ops() as rec:
        fa._launch_bwd(*ins, causal=True, window=None, scale=0.1)
    (args,) = [a for f, a in rec.calls if "b2_flash_bwd" in f]
    part = args[13] if len(args) > 13 else None
    if parts == 1:
        assert part is None
        return
    assert part.device.type == "meta" and part.dtype == torch.float32
    assert tuple(part.shape) == (parts, 2, S, KV, 2 * D)


# -- sums over a GQA group's rows (C10) ---------------------------------------------

def test_ffma_dkdv_sum_order_holds_float32_at_a_group_of_48():
    """C10: B2's FFMA dk/dv kernel summed a key's dv over every row of
    its group in one float32 chain (48 x 2048 rows at granite-34b), which
    missed ``FLASH_TOL``'s float32 bound against the exact sum on the card
    (2.5x it against float64; 1.2x against the plain version). Its repair
    sums a 32-row tile, then a head's tiles, then the group's heads. The
    same terms in float32 (a key's p = exp(s - lse) over causal rows, do
    drawn as the card's check draws it), summed in either order, against
    their float64 sum: the one chain misses the bound, the kernel's order
    keeps well inside it."""
    rng = np.random.default_rng(12)
    G, S, T, J, D = 48, 2048, 32, 8, 16
    rows = np.arange(1, S + 1, dtype=np.float64)
    # keys seen by every row i with weight ~ 1 / (i + 1) (causal rows,
    # scores of unit spread)
    p = np.exp(rng.standard_normal((G, S, J))) / (np.e ** 0.5 * rows[:, None])
    do = rng.standard_normal((G, S, D)).astype(np.float32)
    p32 = p.astype(np.float32)[..., None]
    t = p32 * do[:, :, None, :]  # (G, S, J, D) float32 terms
    exact = (p32.astype(np.float64) * do[:, :, None, :]).sum((0, 1))

    def ratio(x):
        return np.max(np.abs(x - exact) / (2e-5 + 2e-5 * np.abs(exact)))

    one_chain = np.add.accumulate(t.reshape(G * S, J, D), axis=0)[-1]
    tiles = np.add.accumulate(t.reshape(G, S // T, T, J, D), axis=2)[:, :, -1]
    heads = np.add.accumulate(tiles, axis=1)[:, -1]
    three_levels = np.add.accumulate(heads, axis=0)[-1]
    assert ratio(one_chain) > 2.0
    assert ratio(three_levels) < 0.5


def test_dk_rounding_bound_covers_o_rounded_through_delta():
    """``flash_dk_rounding_bound``: dk from o and from o rounded to bf16
    (the plain backward on the same q, k, v, lse and do, so only delta
    moves) differ by no more than the bound, which sums each row's delta
    error over every head of the group; a bound without the group's sum
    (one head's share) would not hold."""
    rng = np.random.default_rng(3)
    B_, S, H_, KV, D = 1, 64, 8, 1, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B_, S, H_, D), (B_, S, KV, D), (B_, S, KV, D),
                               (B_, S, H_, D)))
    scale = D ** -0.5
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o, lse = flash._fwd_all(qt.reshape(B_, KV, H_ // KV, S, D), kt, vt,
                            flash.MaskSpec(causal=True), scale, S, 8)
    o, lse = o.reshape(B_, H_, S, D), lse.reshape(B_, H_, S)
    kw = dict(causal=True, window=None, scale=scale)
    dk = fa._plain_bwd(qt, kt, vt, o, lse, dot, **kw)[1]
    dk_r = fa._plain_bwd(qt, kt, vt, o.bfloat16().float(), lse, dot, **kw)[1]
    bound = ref.flash_dk_rounding_bound(q, k, o.transpose(1, 2), do,
                                        causal=True, scale=scale)
    gap = (dk - dk_r).transpose(1, 2).abs()
    assert bound.shape == k.shape
    assert bool((gap <= bound).all()) and float(gap.max()) > 0
    assert not bool((gap <= bound / H_).all())


# -- B2's build report, as chip_smoke.py's [build] reads it ----------------------

def _entry(name: str, spill: int) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {spill} bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            f"ptxas info    : Used 168 registers, used 1 barriers\n")


# B2's 13 backward kernels of namespace tcb: the 12 wgmma kernels (dk/dv
# and dq at D, Dv in 64 and 128, the dk/dv kernel whose warpgroups split
# the products and dq at D 192) and the reduce of a split group's parts
_TCB = [f"_ZN3tcb{len(k)}{k}ILi{dp}ELi{dv}EEEv14CUtensorMap_st"
        for k, dps in (("flash_bwd_dkdv_wgmma", (64, 128)),
                       ("flash_bwd_dq_wgmma", (64, 128, 192)),
                       ("flash_bwd_dkdv_split", (192,)))
        for dp in dps for dv in (64, 128)] + [
    "_ZN3tcb21flash_bwd_dkdv_reduceEPKfP13__nv_bfloat16S3_iiiiiii7StridesS4_f"]
_FFMA = "_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu17flash_bwd_dq_ffmaIfEEv"
_SERIALISED = ("ptxas info    : (C7512) Potential Performance Loss: "
               "wgmma.mma_async instructions are serialized due to "
               f"insufficient register resources for the function '{_TCB[0]}'\n")


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module (importing it runs nothing)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_ptxas_spills_reads_each_kernels_line(chip_smoke):
    """Each kernel's spill line is read for the entry function above it;
    the notes ptxas prints before the entries name no kernel's spills."""
    log = _SERIALISED + _entry(_TCB[0], 0) + _entry(_FFMA, 28) + _entry(
        _TCB[1], 16)
    assert chip_smoke.ptxas_spills(log) == {
        _TCB[0]: (0, 0), _FFMA: (28, 28), _TCB[1]: (16, 16)}


_SSD = "_ZN55_GLOBAL__N__0b1c2d3e_11_ssd_scan_cu"
_SSD_BWD = [f"{_SSD}{k}ILi{w}E{b}EEvPKf"
            for k, b in (("18ssd_bwd_key_kernel", ""),
                         ("18ssd_bwd_row_kernel", ""),
                         ("22ssd_chunk_state_kernel", "Lb1E"))
            for w in (64, 128)] + [f"{_SSD}22ssd_bwd_passing_kernelEPfS0_PKfiii"]
# the forward's kernels, which may spill: its chunk-state instantiation
# (bool false) and its chunk output
_SSD_FWD = [f"{_SSD}22ssd_chunk_state_kernelILi128ELb0EEEvPKf",
            f"{_SSD}23ssd_chunk_output_kernelEPKf"]


@pytest.mark.parametrize("case,passes", [
    ("clean", True),          # 13 tcb kernels, none spills; ffma may
    ("wgmma_spills", False),  # one wgmma kernel spills
    ("serialised", False),    # ptxas serialised a wgmma
    ("missing", False),       # fewer than the 13 tcb kernels reported
    ("ssd_spills", False),    # one of B3's backward kernels spills
    ("ssd_serialised", False),  # ptxas serialised a wgmma of B3's library
    ("ssd_missing", False),   # fewer than B3's 7 backward kernels reported
])
def test_bwd_build_check(chip_smoke, monkeypatch, case, passes):
    """``check_bwd_build`` passes B2's backward library only with every
    one of its 13 tcb kernels (12 wgmma, the reduce) at 0 spill bytes and
    no wgmma serialised,
    and the SSD library only with B3's 7 backward kernels (key, row and
    states at widths 64 and 128, the state passing) at 0 spill bytes and
    none of its wgmma serialised; the forward's kernels may spill."""
    names = _TCB[:-1] if case == "missing" else _TCB
    log = "".join(_entry(n, 8 if case == "wgmma_spills" and i == 3 else 0)
                  for i, n in enumerate(names)) + _entry(_FFMA, 28)
    if case == "serialised":
        log = _SERIALISED + log
    ssd_names = _SSD_BWD[1:] if case == "ssd_missing" else _SSD_BWD
    ssd_log = "".join(_entry(n, 4 if case == "ssd_spills" and i == 4 else 0)
                      for i, n in enumerate(ssd_names)) + "".join(
        _entry(n, 16) for n in _SSD_FWD)
    if case == "ssd_serialised":
        ssd_log = _SERIALISED.replace(_TCB[0], _SSD_BWD[0]) + ssd_log
    monkeypatch.setattr(_build, "BUILD_LOG",
                        {"flash_attention_bwd": (1.0, log),
                         "ssd_scan": (1.0, ssd_log)})
    if passes:
        chip_smoke.check_bwd_build()
    else:
        lib = "ssd_scan" if case.startswith("ssd") else "flash_attention_bwd"
        with pytest.raises(SystemExit, match=lib):
            chip_smoke.check_bwd_build()


@pytest.mark.parametrize("shift,want", [(0.0, 0), (1.0, 3)])
def test_kernel_ab_bwd_gate(shift, want):
    """``kernel_ab.py``'s gate on B2's backward counts the elements of dq,
    dk and dv beyond the bound, dq's with its extra term."""
    sys.path.insert(0, str(ROOT))
    import kernel_ab

    rng = np.random.default_rng(3)
    ref = tuple(torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(
        np.float32)) for _ in range(3))
    got = tuple(r.clone() for r in ref)
    for g in got:
        g[0, 0, 0, 0] += shift
    extras = (torch.zeros_like(ref[0]), None, None)
    assert kernel_ab.beyond(got, (ref, extras), 3e-2) == want
    assert kernel_ab.beyond(got[1], ref[1], 3e-2) == int(want > 0)


@pytest.mark.parametrize("shift,want", [(0.0, 0), (1e-3, 0), (1.0, 5),
                                        (float("nan"), 5)])
def test_kernel_ab_b3_bwd_gate(chip_smoke, shift, want):
    """``kernel_ab.py``'s gate on B3's backward counts the elements of the
    five gradients beyond ``chip_smoke.b3_grad_ratio``'s bound (2e-4 of
    each gradient's rms plus 2e-4 of the element): a shift of 1e-3 on an
    element of size O(1) stays inside, 1 does not, NaN never does."""
    sys.path.insert(0, str(ROOT))
    import kernel_ab

    rng = np.random.default_rng(4)
    ref = [torch.from_numpy(rng.standard_normal((1, 2, 2, 8, 6)).astype(
        np.float32) * 10) for _ in range(5)]
    got = [r.clone() for r in ref]
    for g in got:
        g[0, 0, 0, 0, 0] += shift
    assert kernel_ab.b3_beyond(got, ref) == want
    assert kernel_ab.b3_beyond(got, ref) == sum(
        int((~(chip_smoke.b3_grad_ratio(g, w) <= 1.0)).sum())
        for g, w in zip(got, ref))


# -- B3 ---------------------------------------------------------------------------

def _b3_chunks(B=2, H=3, nc=3, Q=16, P=8, N=12, device="cpu"):
    x = torch.zeros((B, H, nc, Q, P), device=device)
    b = torch.zeros((B, H, nc, Q, N), device=device)
    t = torch.zeros((B, H, nc, Q), device=device)
    return x, b, b.clone(), t, t.clone()


def test_b3_bwd_argument_checks(no_launch):
    """dy of another shape or type, and P past the kernels' tiles, raise
    before any launch."""
    x, b, c, dt, cum = _b3_chunks()
    with pytest.raises(ValueError, match="dy"):
        ssd._launch_bwd(x, b, c, dt, cum, x[..., :4])
    with pytest.raises(ValueError, match="dy"):
        ssd._launch_bwd(x, b, c, dt, cum, x.double())
    wide = torch.zeros((2, 3, 3, 16, 80))
    with pytest.raises(ValueError, match="P <= 64"):
        ssd._launch_bwd(wide, b, c, dt, cum, wide)


def test_b3_bwd_refuses_a_wide_state(no_launch):
    """N past the widest instantiation raises before any launch."""
    x, b, c, dt, cum = _b3_chunks(N=12)
    wide = torch.zeros((*b.shape[:4], 136))
    with pytest.raises(ValueError, match="N <= 128"):
        ssd._launch_bwd(x, wide, wide, dt, cum, x)


@pytest.mark.parametrize("P,N,Q", [(40, 72, 20), (30, 20, 48), (64, 128, 64),
                                   (1, 1, 1), (64, 64, 256), (8, 65, 33),
                                   (64, 128, 256)])
def test_b3_bwd_traced_route_shapes(no_launch, P, N, Q):
    """At ragged shapes, at the smallest, and at N on both sides of 64
    (the kernels' two state widths), the traced route on fake CUDA
    tensors gives the five gradients of their inputs' shapes, one
    registered backward op with the kernels' operation count, and the
    scratch (the states and their gradients) in the trace's memory."""
    B, H_, nc = 1, 2, 2
    tr = H.Tracer()
    with tr:
        ins = _b3_chunks(B, H_, nc, Q, P, N, "cuda")
    out = {}
    a = H.analyze(lambda *t: out.setdefault(
        "g", ssd._launch_bwd(*t, t[0])), *ins)
    for g, t in zip(out["g"], ins):
        assert tuple(g.shape) == tuple(t.shape) and g.device.type == "cuda"
    assert a.launches("repro_torch.b3_scan_bwd") == 1
    assert a.flops == work.ssd_bwd_work(B, H_, nc, Q, P, N)[0]
    assert a.memory["temp_bytes"] >= 2 * B * H_ * nc * P * N * 4


@pytest.mark.parametrize("device", ["meta", "cpu", "cuda"])
def test_b3_bwd_traced_route(no_launch, device):
    """On a meta tensor, and on fake CPU and CUDA tensors under the trace
    analysis: the five gradients of their inputs' shapes on their device,
    one registered backward op with its operation count, and the scratch
    the launch allocates counted in the trace's memory."""
    B, H_, nc, Q, P, N = 2, 3, 3, 16, 8, 12
    if device == "meta":
        ins = _b3_chunks(B, H_, nc, Q, P, N, "meta")
        grads = ssd._launch_bwd(*ins, ins[0])
        a = None
    else:
        tr = H.Tracer()
        with tr:
            ins = _b3_chunks(B, H_, nc, Q, P, N, device)
        out = {}
        a = H.analyze(lambda *t: out.setdefault(
            "g", ssd._launch_bwd(*t, t[0])), *ins)
        grads = out["g"]
    for g, t in zip(grads, ins):
        assert tuple(g.shape) == tuple(t.shape) and g.device.type == device
    if a is not None:
        assert a.launches("repro_torch.b3_scan_bwd") == 1
        assert a.flops == work.ssd_bwd_work(B, H_, nc, Q, P, N)[0]
        # the states and their gradients, (B, H, nc, P, N) float32 each
        assert a.memory["temp_bytes"] >= 2 * B * H_ * nc * P * N * 4


def _ssd_prepped(seed=0, Bn=2, L=64, H=4, P=8, G=2, N=8, chunk=16):
    """``ops.ssd_prep``'s chunks of the reference test's distributions, and
    a dy."""
    rng = np.random.default_rng(seed)
    xh, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((Bn, L, H, P), (Bn, L, G, N), (Bn, L, G, N)))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((Bn, L, H)), 0.0)
                          .astype(np.float32))
    A = -torch.from_numpy(np.exp(rng.standard_normal(H) * 0.5)
                          .astype(np.float32))
    chunks = ops.ssd_prep(xh, Bm, Cm, dt, A, chunk=chunk)
    dy = torch.from_numpy(rng.standard_normal(chunks[0].shape)
                          .astype(np.float32))
    return chunks, dy


def test_b3_bwd_launches_count_one_per_backward(monkeypatch):
    """``_B3Function`` on the kernels' route, its forward stood in for by
    the plain staged scan and the backward's C entry point by the plain
    stage-by-stage backward written into the kernels' outputs: each
    backward counts one launch, and gives those gradients; the scratch is
    handed to the entry point with the gradients after it."""
    seen = []

    def fake_call(entry, pointers, dims, device):
        if entry == "ssd_chunk_scan_bwd":
            ins, dy, grads = pointers[:5], pointers[5], pointers[10:]
            seen.append(tuple(t.shape for t in pointers[6:10]))
            for out, g in zip(grads, ssd.ssd_bwd_staged_plain(*ins, dy)):
                out.copy_(g)
        else:
            raise AssertionError(entry)

    monkeypatch.setattr(ssd, "_launch", lambda *a: ssd.ssd_staged_plain(*a))
    monkeypatch.setattr(ssd, "_call", fake_call)
    monkeypatch.setattr(ssd, "_kernel_route", lambda t: True)
    chunks, dy = _ssd_prepped()
    ssd.reset_launches()
    for n in range(1, 3):
        ins = [t.clone().requires_grad_(True) for t in chunks]
        got = torch.autograd.grad(ssd._B3Function.apply(*ins), ins, dy)
        assert ssd.BWD_LAUNCHES == n
    want = ssd.ssd_bwd_staged_plain(*chunks, dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    B, H_, nc, Q, P = chunks[0].shape
    N = chunks[1].shape[-1]
    assert seen[0] == ((B, H_, nc, P, N), (B, H_, nc, P, N), (B, H_, nc, Q),
                       (B, H_, nc))


def test_b3_bwd_fused_plain_launches():
    """The plain versions of the backward's first two launches are the
    stages they fuse: the chunk states and dS_in, then the state passing
    forward and in reverse."""
    chunks, dy = _ssd_prepped()
    xc, bc, cc, dtc, cum = chunks
    states, ds_in = ssd.ssd_bwd_states_plain(*chunks, dy)
    assert torch.equal(states, ssd.ssd_chunk_state_plain(xc, bc, dtc, cum))
    want_in = torch.einsum("bhcip,bhcin->bhcpn",
                           dy * torch.exp(cum)[..., None], cc)
    assert torch.equal(ds_in, want_in)
    entering, ds_loc = ssd.ssd_bwd_passing_plain(states, ds_in, cum)
    assert torch.equal(entering, ssd.ssd_state_passing_plain(states, cum)[0])
    assert torch.equal(ds_loc, ssd.ssd_state_passing_bwd_plain(ds_in, cum))
    assert torch.equal(ds_loc[:, :, -1], torch.zeros_like(ds_loc[:, :, -1]))


@pytest.mark.parametrize("chunk", [16, 32])
def test_b3_staged_backward_matches_autograd(chunk):
    """The split the kernels compute (the carry recomputed; dS_in; the
    state passing in reverse; the key side with the chunk state's
    backward; the row side) against autograd of ``ssd_staged_plain``, in
    float32 within 1e-5 of each gradient's max |g| (the sums run in
    another order)."""
    chunks, dy = _ssd_prepped(chunk=chunk)
    ins = [t.clone().requires_grad_(True) for t in chunks]
    want = torch.autograd.grad(ssd.ssd_staged_plain(*ins), ins, dy)
    got = ssd.ssd_bwd_staged_plain(*chunks, dy)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale


class _StagedScan(torch.autograd.Function):
    """The plain staged scan whose backward is the kernels' split."""

    @staticmethod
    def forward(ctx, *chunks):
        ctx.save_for_backward(*chunks)
        return ssd.ssd_staged_plain(*chunks)

    @staticmethod
    def backward(ctx, dy):
        return ssd.ssd_bwd_staged_plain(*ctx.saved_tensors, dy)


@pytest.mark.parametrize("L,chunk", [(64, 16), (96, 32)])
def test_b3_staged_backward_matches_reference_grad(L, chunk):
    """x, B, C, dt and A through ``ops.ssd_prep`` and the kernels' split
    against ``jax.grad`` of the reference's chunked scan on the same
    inputs (reduced mamba2-130m's heads and widths), within 1e-4 of each
    gradient's max |g| (float32; the reference's own scan tolerance)."""
    ref_cfg = ref_reduced_config(ref_get_config("mamba2-130m"),
                                 dtype=jnp.float32, ssm_chunk=chunk)
    H, P, G, N = (ref_cfg.ssm_nheads, ref_cfg.ssm_headdim,
                  ref_cfg.ssm_ngroups, ref_cfg.ssm_state)
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((2, L, H, P)).astype(np.float32),
              (rng.standard_normal((2, L, G, N)) * 0.5).astype(np.float32),
              (rng.standard_normal((2, L, G, N)) * 0.5).astype(np.float32),
              np.logaddexp(rng.standard_normal((2, L, H)), 0.0)
              .astype(np.float32),
              (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)]
    dy = rng.standard_normal((2, L, H, P)).astype(np.float32)

    def ref_loss(*a):
        y, _ = ref_ssm._ssd_scan(*a, ref_cfg)
        return jnp.sum(y * dy)

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in arrays])
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = _StagedScan.apply(*ops.ssd_prep(*ins, chunk=chunk))
    y = y.movedim(1, 3).reshape(2, L, H, P)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
