"""The port's dense decoder against the JAX reference: the models' flash
attention and its route to kernel B2, RoPE, GQA attention and decode, the
MLP, and reduced granite-8b, glm4-9b and internvl2-1b end to end.

Same numpy inputs through both packages; the reference's parameters are
carried over with ``params_from_reference``. Tolerances are stated beside
each test.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import flash as ref_flash
from repro.models import layers as ref_L
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.models import flash as pt_flash
from repro_torch.models import layers as pt_L
from repro_torch.models import get_model, make_batch
from repro_torch.models import transformer as tf

from _torch_model_parity import (
    DTYPES,
    FRACTIONS,
    as_np,
    check_decode_matches_forward,
    check_decode_steps,
    check_forward_f32,
    check_init_shapes,
    check_lane_decode,
    check_offload_decode,
    check_offload_forward,
    make_pair,
)

DENSE_ARCHS = ["granite-8b", "glm4-9b", "internvl2-1b"]

# B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset
FLASH_CASES = {
    "causal-gqa": (2, 64, 64, 8, 2, 16, 16, True, None, 0),
    "window-mqa-dv": (1, 128, 128, 4, 1, 32, 16, True, 32, 0),
    "mha": (1, 64, 64, 4, 4, 16, 16, True, None, 0),
    "cross": (2, 48, 80, 6, 3, 16, 16, False, None, 0),
    "sk-not-a-block-multiple": (2, 40, 72, 4, 2, 16, 16, True, None, 0),
    "q-offset-decode": (2, 1, 96, 8, 8, 16, 16, True, None, 95),
    "q-offset-chunk-window": (1, 32, 96, 4, 2, 16, 16, True, 24, 64),
}


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in cache:
            cache[arch, dtype] = make_pair(arch, dtype)
        return cache[arch, dtype]

    return get


def _qkv(case, dtype_name, seed=7):
    B, Sq, Sk, H, KV, D, Dv = case[:7]
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype_name]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, Dv))]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


# -- flash attention --------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES.values(), ids=FLASH_CASES.keys())
def test_flash_matches_reference(case, dtype, tol):
    """The port's blocked flash (the CPU path of ``flash_attention``)
    against the reference's at its own tolerance (2e-5 in float32, 2e-2 in
    bf16, tests/test_models.py), and against the dense oracle: 32-key
    blocks, 4 strips, so every case scans several blocks and strips."""
    causal, window, q_offset = case[7:]
    (jq, jk, jv), (q, k, v) = _qkv(case, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = pt_flash.flash_attention(q, k, v, block_k=32, n_strips=4, **kw)
    want = ref_flash.flash_attention(jq, jk, jv, block_k=32, n_strips=4,
                                     **kw)
    assert got.dtype == q.dtype and got.shape == want.shape
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        as_np(got), as_np(pt_flash.reference_attention(q, k, v, **kw)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,D,Dv,q_offset,want", [
    (torch.bfloat16, 128, 128, 0, "wgmma"),   # granite-8b
    (torch.bfloat16, 64, 64, 0, "wgmma"),     # zamba2-1.2b, internvl2-1b
    (torch.float32, 128, 128, 0, "ffma"),
    (torch.bfloat16, 40, 40, 0, "ffma"),
    (torch.bfloat16, 128, 64, 0, "wgmma"),    # Dv != D
    (torch.bfloat16, 128, 128, 7, "q_offset"),
    (torch.float32, 16, 16, 1, "q_offset"),
    # deepseek-v3's MLA prefill (D 128 + 64, Dv 128); the id is the one
    # this case has always had
    pytest.param(torch.bfloat16, 192, 128, 0, "wgmma",
                 id="dtype7-192-128-0-head dims"),
    (torch.bfloat16, 128, 256, 0, "head dims"),
    (torch.float32, 18, 18, 0, "head dims"),
])
def test_b2_route(dtype, D, Dv, q_offset, want):
    """The CUDA route: which calls go to B2 (and its variant), which
    raise, naming ROADMAP's B2 gap."""
    if want in ("wgmma", "ffma"):
        assert pt_flash.b2_route(dtype, D, Dv, q_offset) == want
    else:
        with pytest.raises(ValueError, match=f"{want}.*ROADMAP B2"):
            pt_flash.b2_route(dtype, D, Dv, q_offset)


def test_flash_on_a_card_never_runs_the_plain_version(monkeypatch):
    """A CUDA tensor takes B2 or raises: the route is called, the blocked
    flash is not. A stand-in for a card's tensor and for the kernel let
    the CPU see the dispatch."""
    calls = []

    def b2(q, k, v, **kw):
        calls.append(kw)
        return "b2"

    monkeypatch.setattr(pt_flash, "_b2", b2)
    monkeypatch.setattr(pt_flash, "blocked_flash",
                        lambda *a, **kw: pytest.fail("plain flash on a card"))
    q = types.SimpleNamespace(device=torch.device("cuda", 0),
                              shape=(1, 4, 2, 16))
    assert pt_flash.flash_attention(q, q, q, window=8) == "b2"
    assert calls == [dict(causal=True, window=8, q_offset=0, scale=0.25)]


def test_flash_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pt_flash.flash_attention(q, q, q)


def test_cpu_flash_launches_nothing():
    pt_fa.reset_launches()
    _, (q, k, v) = _qkv(FLASH_CASES["causal-gqa"], "bfloat16")
    pt_flash.flash_attention(q, k, v)
    assert pt_fa.LAUNCHES == 0
    assert pt_fa.VARIANT_LAUNCHES == {"wgmma": 0, "ffma": 0}


# -- layers -------------------------------------------------------------------

def _cfgs(arch="granite-8b", dtype="float32", **overrides):
    jdt, tdt = DTYPES[dtype]
    return (ref_reduced_config(ref_get_config(arch), dtype=jdt, **overrides),
            reduced_config(get_config(arch), dtype=tdt, **overrides))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 0.0)])
def test_rope_matches_reference(dtype, tol):
    """float32 to 1e-6; bf16 exactly: sin and cos are cast to x's type
    before they multiply, and each product and sum is rounded to bf16."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(24), np.arange(100, 124)]).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    want = ref_L.rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos))
    got = pt_L.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos))
    assert got.dtype == tdt
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


def _attn_params(ref_cfg, seed=3):
    ref_p = ref_L.attention_init(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, params_from_reference(ref_p, device="cpu")


@pytest.mark.parametrize("mode", ["causal", "window", "cross", "mask"])
def test_gqa_attention_matches_reference(mode):
    """float32, 1e-5: the flash path (causal, a sliding window of 16 over
    32 tokens), cross attention on other keys, and an explicit mask through
    ``_sdpa``."""
    over = {"sliding_window": 16} if mode == "window" else {}
    ref_cfg, cfg = _cfgs(**over)
    ref_p, p = _attn_params(ref_cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32)).astype(np.int32)
    kw_ref, kw = {}, {}
    if mode == "cross":
        kw_ref["kv"], kw["kv"] = jnp.asarray(kv), torch.from_numpy(kv)
    if mode == "mask":
        kw_ref["mask"] = ref_L.causal_mask(32, 32, window=8)
        kw["mask"] = pt_L.causal_mask(32, 32, window=8)
    want = ref_L.gqa_attention(ref_p, jnp.asarray(x), ref_cfg,
                               positions=jnp.asarray(pos), **kw_ref)
    got = pt_L.gqa_attention(p, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("offset", [0, 7])
def test_causal_mask_matches_reference(window, offset):
    np.testing.assert_array_equal(
        pt_L.causal_mask(9, 16, window=window, offset=offset).numpy(),
        np.asarray(ref_L.causal_mask(9, 16, window=window, offset=offset)))


@pytest.mark.parametrize("mode", ["scalar", "lanes", "ring", "ring-lanes"])
def test_gqa_decode_step_matches_reference(mode):
    """float32, 1e-5, over 24 steps: a scalar position and a per-lane
    ``(B,)`` vector (lanes 3 apart), on the full cache and on the
    sliding-window ring (``sliding_window=16``, so the ring wraps after 16
    steps). The caches must match too, and the port writes them in
    place."""
    ring = mode.startswith("ring")
    ref_cfg, cfg = _cfgs(**({"sliding_window": 16} if ring else {}))
    ref_p, p = _attn_params(ref_cfg)
    rng = np.random.default_rng(2)
    S_cache = 16 if ring else 32
    shape = (2, S_cache, cfg.n_kv_heads, cfg.head_dim)
    rk, rv = jnp.zeros(shape), jnp.zeros(shape)
    k, v = torch.zeros(shape), torch.zeros(shape)
    lanes = mode.endswith("lanes")
    for t in range(24):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, t + 3] if lanes else t, dtype=np.int32)
        want, rk, rv = ref_L.gqa_decode_step(ref_p, jnp.asarray(x), rk, rv,
                                             jnp.asarray(pos), ref_cfg)
        got, k2, v2 = pt_L.gqa_decode_step(p, torch.from_numpy(x), k, v,
                                           torch.from_numpy(pos), cfg)
        assert k2 is k and v2 is v
        np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(t))
    np.testing.assert_allclose(k.numpy(), as_np(rk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), as_np(rv), atol=1e-5, rtol=1e-5)


def test_mlp_matches_reference():
    ref_cfg, cfg = _cfgs()
    ref_p = ref_L.mlp_init(jax.random.PRNGKey(4), ref_cfg)
    x = np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        as_np(pt_L.mlp(params_from_reference(ref_p, device="cpu"),
                       torch.from_numpy(x))),
        as_np(ref_L.mlp(ref_p, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


# -- the dense models -------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_matches_reference_shapes(arch):
    got = check_init_shapes(arch)
    cfg = reduced_config(get_config(arch))
    # the reference's scales: embedding 1, projections 1/sqrt(fan-in)
    assert 0.9 < got["embed"]["embedding"].float().std() < 1.1
    std = got["layers"]["mlp"]["w_down"].float().std() * cfg.d_ff ** 0.5
    assert 0.9 < std < 1.1


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference_f32(arch, pairs):
    check_forward_f32(pairs(arch))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_steps_match_reference(arch, pairs):
    check_decode_steps(pairs(arch), ("k", "v"))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_matches_forward(arch, pairs):
    check_decode_matches_forward(pairs(arch))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_lane_decode_is_bit_identical(arch, pairs):
    check_lane_decode(pairs(arch))


def test_forward_matches_reference_bf16():
    """Reduced bf16 granite-8b. Bound: max|diff| <= 0.05 * max|logits| and
    ||diff|| <= 0.03 * ||logits||, the bounds of the mamba2-130m bf16 test.
    Reason: both packages round at the same points (einsum outputs, RoPE's
    sin and cos, the flash scores), but XLA-CPU's bf16 logistic (in the
    MLP's silu) and torch's sigmoid round a third of the elements one bf16
    unit apart (ROADMAP C4), and XLA may keep fused bf16 chains in float32;
    two layers and the tied head carry those flips into the logits.
    Measured over init seeds 0-5: max|diff| up to 0.0054 of max|logits|,
    relative L2 up to 0.0073, greedy tokens all equal."""
    pair = make_pair("granite-8b", "bfloat16")
    logits, _ = tf.forward(pair.params, pair.batch, pair.cfg)
    V = pair.cfg.vocab_size
    want, got = pair.ref_logits[..., :V], as_np(logits)[..., :V]
    diff = got - want
    assert np.abs(diff).max() <= 0.05 * np.abs(want).max()
    assert np.linalg.norm(diff) <= 0.03 * np.linalg.norm(want)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_host_offload_forward_is_bit_identical(fraction, prefetch, pairs):
    """Every placement and prefetch setting of granite-8b: logits
    torch.equal to the untiered run's."""
    check_offload_forward(pairs("granite-8b"), fraction, prefetch)


@pytest.mark.parametrize("prefetch", [True, False])
def test_host_offload_decode_is_bit_identical(prefetch, pairs):
    check_offload_decode(pairs("granite-8b"), prefetch, ("k", "v"))


def test_vlm_offload_forward_is_bit_identical(pairs):
    check_offload_forward(pairs("internvl2-1b"), 0.0, True)


def test_make_batch_draws_vlm_patches():
    cfg = reduced_config(get_config("internvl2-1b"))
    batch = make_batch(cfg, torch.Generator().manual_seed(3), 3, 16,
                       device="cpu")
    assert batch["tokens"].shape == (3, 16)
    assert batch["patches"].shape == (3, cfg.frontend_len, cfg.d_model)
    assert batch["patches"].dtype == cfg.dtype
    assert 0.8 < batch["patches"].float().std() < 1.2
    logits, _ = get_model(cfg).forward(
        tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
        batch, cfg)
    assert logits.shape[:2] == (3, 16)  # text positions only
    assert bool(torch.isfinite(logits).all())


def test_decode_cache_matches_reference_layout():
    """The KV cache's shapes are the reference's; a sliding-window config
    keeps a ring of the window's width."""
    for over in ({}, {"sliding_window": 16}):
        ref_cfg, cfg = _cfgs(**over)
        want = jax.eval_shape(lambda: ref_tf.init_decode_cache(ref_cfg, 2, 40))
        got = tf.init_decode_cache(cfg, 2, 40, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
