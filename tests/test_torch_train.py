"""The port's loss and gradients on the CPU: ``loss_fn`` under every remat
policy against ``jax.value_and_grad`` of the reference's on the same
inputs (reduced granite-8b, at a depth that takes ``_block_split``'s blocks,
in bf16, deepseek-v3 with aux and MTP, mixtral-8x7b with its window and
top-2 experts, mamba2-130m, zamba2-1.2b with its
shared block under remat, internvl2-1b with its patches and granite-34b's
one KV head); the flash backward against ``jax.grad`` of the
reference's flash; B3's backward on a card (the fused scan's Function) and
the per-stage kernels' refusal. The train step,
placements and the loop are in ``test_torch_train_step.py``."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as ref_flash

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan
from repro_torch.models import flash

from _torch_model_parity import one_torch_thread  # noqa: F401
from _torch_train_parity import Ref, as_np, check_f32

REMATS = ["none", "full", "full_flat", "dots", "dots_no_batch"]

@pytest.fixture(scope="module")
def granite():
    return Ref("granite-8b", n_layers=4, vocab_size=64)


@pytest.mark.parametrize("remat", REMATS)
def test_granite_loss_and_grads_match_reference(granite, remat):
    check_f32(granite, *granite.port_loss_and_grads(remat))


def test_remat_policies_bit_equal(granite):
    """Recompute in eager torch reruns the same ops: every policy gives the
    loss and gradients of remat='none' exactly."""
    base = granite.port_loss_and_grads("none")
    for remat in REMATS[1:]:
        loss, _, grads = granite.port_loss_and_grads(remat)
        assert torch.equal(loss, base[0]), remat
        for k, g in grads.items():
            assert torch.equal(g, base[2][k]), (remat, k)


@pytest.fixture(scope="module")
def granite12():
    return Ref("granite-8b", n_layers=12, vocab_size=64)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_granite_blocked_depth_matches_reference(granite12, remat):
    """n_layers=12 reaches _block_split's blocks: 3 blocks of 4 layers."""
    check_f32(granite12, *granite12.port_loss_and_grads(remat))


def test_granite_bf16_within_dense_bounds():
    """bf16 at the bounds of the dense bf16 tests (C2, C4): the loss within
    3 % of the reference's, each gradient within 0.05 of its leaf's max |g|
    and 0.03 of its norm (measured: 0.023 and 0.020 at most)."""
    ref = Ref("granite-8b", dtype="bfloat16", n_layers=4, vocab_size=64)
    loss, _, grads = ref.port_loss_and_grads("full")
    assert abs(float(loss) - ref.loss) <= 0.03 * abs(ref.loss)
    for k, g in grads.items():
        want, got = ref.grads[k], as_np(g)
        assert np.abs(got - want).max() <= 0.05 * np.abs(want).max(), k
        assert (np.linalg.norm(got - want)
                <= 0.03 * np.linalg.norm(want)), k


@pytest.fixture(scope="module")
def deepseek():
    return Ref("deepseek-v3-671b")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_deepseek_nll_aux_and_mtp_match_reference(deepseek, remat):
    ref = deepseek
    loss, metrics, grads = ref.port_loss_and_grads(remat)
    assert set(metrics) == {"nll", "aux", "mtp_nll"}
    assert "['mtp']['proj']" in grads
    check_f32(ref, loss, metrics, grads)


@pytest.fixture(scope="module")
def mixtral():
    return Ref("mixtral-8x7b", seq=32)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_mixtral_windowed_moe_matches_reference(mixtral, remat):
    """Reduced mixtral-8x7b: top-2 MoE dispatch and combine under autograd,
    and the sliding window (16 at this size) over 32 tokens, so that the
    window cuts pairs from every row past the 16th."""
    ref = mixtral
    assert ref.cfg.sliding_window == 16 < ref.batch["tokens"].shape[1]
    assert ref.cfg.top_k == 2 and ref.cfg.first_k_dense == 0
    loss, metrics, grads = ref.port_loss_and_grads(remat)
    assert set(metrics) == {"nll", "aux"}
    assert any("w_gate" in k and "layers" in k for k in grads)
    check_f32(ref, loss, metrics, grads)


@pytest.fixture(scope="module")
def mamba2():
    return Ref("mamba2-130m")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_mamba2_matches_reference(mamba2, remat):
    check_f32(mamba2, *mamba2.port_loss_and_grads(remat))


@pytest.fixture(scope="module")
def zamba2():
    return Ref("zamba2-1.2b")


@pytest.mark.parametrize("remat", ["none", "full", "full_flat"])
def test_zamba2_shared_block_under_remat(zamba2, remat):
    """The hybrid's shared block is placed by layer index: a recompute
    applies it after the same layers. Loss and gradients match the
    reference's and equal remat='none' exactly."""
    loss, metrics, grads = zamba2.port_loss_and_grads(remat)
    check_f32(zamba2, loss, metrics, grads)
    base_loss, _, base = zamba2.port_loss_and_grads("none")
    assert torch.equal(loss, base_loss)
    for k in grads:
        assert torch.equal(grads[k], base[k]), k


# the configurations with few KV heads: reduced internvl2-1b with its
# patches before the text (14 heads over 2 KV heads, the real group of 7)
# and reduced granite-34b (48 heads over one KV head: multi-query attention)
FEW_KV = {"internvl2-1b": dict(n_heads=14, n_kv_heads=2),
          "granite-34b": dict(n_heads=48, n_kv_heads=1)}


@pytest.fixture(scope="module", params=list(FEW_KV))
def few_kv(request):
    return Ref(request.param, **FEW_KV[request.param])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_few_kv_heads_loss_and_grads_match_reference(few_kv, remat):
    """Loss and every gradient against the reference's at the groups of 7
    and 48; the vlm's patches reach the loss through the trunk (their
    positions give no logits)."""
    ref = few_kv
    assert ref.cfg.n_heads // ref.cfg.n_kv_heads in (7, 48)
    if ref.cfg.family == "vlm":
        assert ref.batch["patches"].shape[1] == ref.cfg.frontend_len
    check_f32(ref, *ref.port_loss_and_grads(remat))


# -- the flash backward ---------------------------------------------------------

FLASH_CASES = {  # B, Sq, Sk, H, KV, D, Dv, causal, window, block_k
    "gqa-causal": (2, 32, 32, 4, 2, 16, 16, True, None, 16),
    "window": (2, 32, 32, 4, 2, 16, 16, True, 8, 16),
    "cross-padded": (1, 24, 40, 4, 1, 16, 16, False, None, 16),
    "mla-d192": (1, 32, 32, 2, 2, 192, 128, True, None, 16),
    "gqa-group7": (1, 32, 32, 14, 2, 16, 16, True, None, 16),
    "mqa-group48": (2, 32, 32, 48, 1, 16, 16, True, None, 16),
}


@functools.lru_cache(maxsize=None)
def _flash_inputs(case):
    """The case's numpy (q, k, v, do) and ``jax.grad`` of the reference's
    flash, computed once for both backward tests."""
    B_, Sq, Sk, H, KV, D, Dv, causal, window, block_k = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B_, Sq, H, D), (B_, Sk, KV, D), (B_, Sk, KV, Dv),
             (B_, Sq, H, Dv))]
    f = lambda q, k, v: jnp.sum(ref_flash.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window, block_k=block_k,
        n_strips=4) * arrs[3])
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*arrs[:3])
    return arrs, [np.asarray(w) for w in want], (causal, window, block_k)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_vjp_matches_reference(case):
    """blocked_flash's autograd (the backward _flash_bwd) against jax.grad
    of the reference's flash at 2e-5 in float32."""
    arrs, want, (causal, window, block_k) = _flash_inputs(case)
    q, k, v = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:3]]
    o = flash.blocked_flash(q, k, v, causal=causal, window=window,
                            block_k=block_k, n_strips=4)
    got = torch.autograd.grad((o * torch.from_numpy(arrs[3])).sum(),
                              [q, k, v])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_b2_function_backward_matches_reference(case, monkeypatch):
    """The card's autograd Function around B2, its launch stood in for by
    the plain forward's (o, lse): the backward (_plain_bwd from the saved
    lse, on the kernel's (B, H, S, D) layout, K/V padded to whole blocks)
    against jax.grad of the reference's flash at 2e-5."""
    arrs, want, (causal, window, _) = _flash_inputs(case)

    def fake_launch(q, k, v, *, causal, window, scale, with_lse=False):
        B_, H, Sq, D = q.shape
        KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
        spec = flash.MaskSpec(causal=causal, window=window)
        o, lse = flash._fwd_all(q.reshape(B_, KV, H // KV, Sq, D), k, v, spec,
                                scale, Sk, 8)
        o = o.reshape(B_, H, Sq, Dv)
        return (o, lse.reshape(B_, H, Sq)) if with_lse else o

    monkeypatch.setattr(fa, "_launch", fake_launch)
    q, k, v = [torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
               for a in arrs[:3]]
    scale = 1.0 / math.sqrt(q.shape[3])
    o = fa._B2Function.apply(q, k, v, causal, window, scale)
    got = torch.autograd.grad(
        (o * torch.from_numpy(arrs[3]).transpose(1, 2)).sum(), [q, k, v])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w, atol=2e-5,
                                   rtol=2e-5)


# -- B3 on a card: the fused scan has a backward, the stages refuse -------------

def test_ssd_refuses_grad_on_a_card(monkeypatch):
    """On a card the fused scan of a grad-requiring input returns a tensor
    whose grad_fn is ``_B3Function``'s (its backward the plain staged
    scan's VJP); the per-stage kernels' outputs would carry no grad_fn, so
    a grad-requiring input to one of them raises, naming the fused scan.
    Without grad (or on the CPU) every call goes through."""
    rng = np.random.default_rng(0)
    Bn, L, H, P, G, N = 1, 32, 4, 8, 1, 8
    xh, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((Bn, L, H, P), (Bn, L, G, N), (Bn, L, G, N)))
    dt = torch.from_numpy(rng.random((Bn, L, H)).astype(np.float32))
    A = -torch.ones(H)
    xh.requires_grad_(True)
    y = ops.ssd(xh, Bm, Cm, dt, A, chunk=16)   # the CPU: plain, with grad
    assert y.requires_grad
    chunks = ops.ssd_prep(xh, Bm, Cm, dt, A, chunk=16)
    monkeypatch.setattr(ssd_scan, "_on_cuda", lambda what, t: True)
    monkeypatch.setattr(ssd_scan, "_launch", lambda *a: torch.zeros_like(
        a[0]))
    out = ssd_scan.ssd_chunk_scan_gpu(*chunks)
    assert type(out.grad_fn).__name__ == "_B3FunctionBackward"
    with pytest.raises(NotImplementedError, match="fused scan"):
        ssd_scan.ssd_chunk_state_gpu(chunks[0], chunks[1], chunks[3],
                                     chunks[4])
    with pytest.raises(NotImplementedError, match="fused scan"):
        ssd_scan.refuse_autograd("ssd", xh)
    with torch.no_grad():
        assert ssd_scan.ssd_chunk_scan_gpu(*chunks).grad_fn is None
