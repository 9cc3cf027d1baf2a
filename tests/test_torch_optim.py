"""The port's optimizer (``repro_torch.optim``): the reference's cases of
``tests/test_optim.py`` pointed at the port, and AdamW, the int8 moments
and the gradient compression held against the reference on the same
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import optim as ref_optim
from repro.optim.quantized import dequantize as ref_dequantize
from repro.optim.quantized import quantize as ref_quantize

from repro_torch.core.objects import _leaves_with_keys
from repro_torch.optim import (
    AdamWConfig,
    CompressionConfig,
    apply_error_feedback,
    compress,
    decompress,
    init as adamw_init,
    init_error_feedback,
    schedule,
    update,
)
from repro_torch.optim.quantized import QTensor, dequantize, quantize


def _normal(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _toy_state(seed=0, moment_style="f32"):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0,
                      moment_style=moment_style)
    params = {"w": _normal(seed, (8, 256)), "b": torch.zeros((4,))}
    return cfg, params, adamw_init(cfg, params)


class TestAdamW:
    def test_first_step_matches_closed_form(self):
        cfg, params, state = _toy_state()
        grads = {k: torch.ones_like(p) for k, p in params.items()}
        new_p, new_s, metrics = update(cfg, grads, state, params)
        lr = float(schedule(cfg, torch.ones(())))
        clip = min(1.0, cfg.grad_clip / float(metrics["grad_norm"]))
        expect = params["b"] - lr * (clip / (clip + cfg.eps))
        np.testing.assert_allclose(new_p["b"], expect, rtol=1e-5)
        assert int(new_s["step"]) == 1

    def test_grad_clip_caps_norm(self):
        cfg, params, state = _toy_state()
        grads = {k: 1e6 * torch.ones_like(p) for k, p in params.items()}
        _p1, _s1, m = update(cfg, grads, state, params)
        assert float(m["grad_norm"]) > cfg.grad_clip  # raw norm reported

    @pytest.mark.parametrize("style", ["bf16", "int8"])
    def test_reduced_precision_moments_track_f32(self, style):
        cfg32, params, s32 = _toy_state(0, "f32")
        cfgq, _, sq = _toy_state(0, style)
        p32, pq = params, params
        for i in range(5):
            g = {k: 0.1 * _normal(100 + i, p.shape) for k, p in params.items()}
            p32, s32, _ = update(cfg32, g, s32, p32)
            pq, sq, _ = update(cfgq, g, sq, pq)
        err = max(float((p32[k] - pq[k]).abs().max()) for k in params)
        scale = float(p32["w"].abs().max())
        assert err < 0.05 * scale, f"{style} diverged: {err}"

    def test_int8_moments_memory_shape(self):
        cfg, params, state = _toy_state(0, "int8")
        m_w = state["m"]["w"]
        assert isinstance(m_w, QTensor) or m_w.dtype == torch.float32
        # big leaf quantizes; small 'b' leaf stays f32
        assert not isinstance(state["m"]["b"], QTensor)

    def test_schedule_warmup_and_decay(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100)
        s = [float(schedule(cfg, torch.tensor(t))) for t in [1, 5, 10, 50, 100]]
        assert s[0] < s[1] < s[2]          # warmup rises
        assert s[2] >= s[3] >= s[4]        # cosine decays
        assert s[4] >= cfg.lr * cfg.min_lr_ratio - 1e-6


class TestQuantizedState:
    @settings(max_examples=30, deadline=None)
    @given(st.integers(0, 2 ** 31 - 1))
    def test_property_roundtrip_error_bound(self, seed):
        x = _normal(seed, (512, 512))
        back = dequantize(quantize(x))
        # blockwise int8: error <= scale = max|block|/127
        err = (back - x).abs()
        assert float(err.max()) <= float(x.abs().max()) / 127 + 1e-6

    def test_small_leaf_not_quantized(self):
        assert not isinstance(quantize(torch.ones((256,))), QTensor)

    def test_leaves_are_codes_and_scale(self):
        """The reference's pytree registration: two leaves, keyed as its
        keystr keys them."""
        q = quantize(_normal(0, (512, 512)))
        keys = [k for k, _ in _leaves_with_keys({"m": q})]
        assert keys == ["['m'].codes", "['m'].scale"]


class TestCompression:
    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 2 ** 31 - 1), st.integers(1, 4000))
    def test_property_roundtrip(self, seed, n):
        x = _normal(seed, (n,))
        codes, scale = compress(x)
        back = decompress(codes, scale, x.shape)
        assert float((back - x).abs().max()) <= float(x.abs().max()) / 127 + 1e-6

    def test_error_feedback_unbiased_over_time(self):
        """Sum of EF-compressed grads converges to sum of true grads."""
        cfg = CompressionConfig(enabled=True)
        g_true = {"w": 0.01 * torch.ones((1024,))}
        residual = init_error_feedback(g_true)
        total = torch.zeros((1024,))
        for _ in range(50):
            gq, residual = apply_error_feedback(g_true, residual, cfg)
            total = total + gq["w"]
        np.testing.assert_allclose(
            total, 50 * g_true["w"],
            atol=float(residual["w"].abs().max()) + 1e-5)

    def test_wire_bytes_reduction(self):
        x = torch.ones((1 << 16,), dtype=torch.float32)
        codes, scale = compress(x)
        wire = codes.nbytes + scale.nbytes
        assert wire < x.nbytes / 3.5  # ~4x minus scale overhead


# -- against the reference ----------------------------------------------------

def _pair_trees(seed=3):
    """Parameters and gradients, one big leaf (quantizable at int8) and a
    small one, as numpy and as each package's arrays."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((1024, 256)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    gs = [{k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in p.items()} for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("style", ["f32", "bf16", "int8"])
def test_adamw_steps_match_reference(style):
    """Three AdamW steps (warmup and decay both live) give the reference's
    parameters, moments and metrics at its own bound."""
    p, gs = _pair_trees()
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10, moment_style=style)
    cfg, rcfg = AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, rs = adamw_init(cfg, tp), ref_optim.init(rcfg, rp)
    for g in gs:
        tp, ts, tm = update(cfg, {k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
        rp, rs, rm = ref_optim.update(rcfg, {k: jnp.asarray(v)
                                             for k, v in g.items()}, rs, rp)
    for k in p:
        np.testing.assert_allclose(tp[k], np.asarray(rp[k]), atol=2e-5,
                                   rtol=2e-4)
        for mom in ("m", "v"):
            np.testing.assert_allclose(
                dequantize(ts[mom][k]).float(),
                np.asarray(ref_dequantize(rs[mom][k]).astype(jnp.float32)),
                atol=2e-5, rtol=2e-4)
    assert int(ts["step"]) == int(rs["step"]) == 3
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(rm[name]), rtol=1e-6)
    assert isinstance(ts["m"]["w"], QTensor) == (style == "int8")


def test_quantize_codes_equal_reference():
    x = np.random.default_rng(5).standard_normal((4, 512, 256)).astype(
        np.float32)
    q, rq = quantize(torch.from_numpy(x)), ref_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.codes.numpy(), np.asarray(rq.codes))
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(rq.scale),
                               rtol=1e-7)


@pytest.mark.parametrize("n", [1000, 4096])
def test_compress_and_error_feedback_equal_reference(n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32)
    r = (0.01 * rng.standard_normal(n)).astype(np.float32)
    codes, scale = compress(torch.from_numpy(g))
    rcodes, rscale = ref_optim.compress(jnp.asarray(g))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rcodes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(rscale), rtol=1e-7)
    cfg = CompressionConfig(enabled=True)
    gq, res = apply_error_feedback({"w": torch.from_numpy(g)},
                                   {"w": torch.from_numpy(r)}, cfg)
    rgq, rres = ref_optim.apply_error_feedback(
        {"w": jnp.asarray(g)}, {"w": jnp.asarray(r)},
        ref_optim.CompressionConfig(enabled=True))
    np.testing.assert_allclose(gq["w"], np.asarray(rgq["w"]), atol=1e-6)
    np.testing.assert_allclose(res["w"], np.asarray(rres["w"]), atol=1e-6)


def test_int8_scales_are_a_true_division_on_the_leafs_device():
    """ROADMAP C11: the scales of int8 moments and of compressed gradients
    are ``amax / 127`` with the divisor a tensor on the leaf's own device.
    A Python-number divisor reaches the kernel as a CPU scalar, which a
    card turns into a multiply by the rounded reciprocal (one unit in the
    last place off the reference's quotient in about 5 % of the scales);
    on a meta tensor, as on a card, every divisor must be on that device.
    On the CPU each scale is the correctly rounded quotient."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.optim.quantized import quantize_blocks

    divisors = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.div.Tensor, torch.ops.aten.div.Scalar):
                divisors.append(args[1])
            return func(*args, **(kwargs or {}))

    with Record():
        quantize_blocks(torch.empty((4, 512), device="meta"))
        compress(torch.empty((4, 512), device="meta"))
    assert len(divisors) == 4
    assert all(isinstance(d, torch.Tensor) and d.device.type == "meta"
               for d in divisors)
    x = _normal(7, (64, 1024))
    amax = x.abs().reshape(64, 4, 256).amax(-1)
    exact = (amax.double() / 127).float()
    assert torch.equal(quantize_blocks(x).scale, exact)
    assert torch.equal(compress(x)[1], exact.reshape(-1))
