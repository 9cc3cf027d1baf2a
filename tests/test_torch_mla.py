"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX reference (``repro.models.mla``), on the CPU, and the
models' flash at MLA's head dims.

Reduced deepseek-v3 (head dims D 16 + 8, Dv 16, latent rank 16) in
float32, the reference's parameters carried over by
``convert.params_from_reference`` and the same numpy inputs for both:

* ``mla_attention`` (prefill through the models' flash) within
  ``ATTN_TOL``;
* ``mla_decode_step`` at a scalar and at a per-lane position, and past
  the cache's length (ROADMAP C6: a scalar position writes the last slot,
  a lane past the cache writes nothing): output within ``ATTN_TOL``, the
  latent caches within ``CACHE_TOL``, and what the reference leaves
  untouched ``torch.equal`` to what it was;
* the models' blocked flash at deepseek-v3's full head dims (D 192 =
  128 + 64, Dv 128) against the reference's at its own float32 tolerance
  2e-5, and ``b2_route``: B2 takes (bf16, 192, 128) on the tensor cores,
  float32 on the CUDA cores, and refuses D 208, Dv 192 and any
  ``q_offset``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import flash as ref_flash
from repro.models import mla as ref_mla

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import flash as pt_flash
from repro_torch.models import mla as MLA

from _torch_model_parity import one_torch_thread  # noqa: F401 (autouse)

# float32 bounds: attention outputs (the reference's flash tolerance, 2e-5,
# on outputs of size O(1) after the output projection) and latent caches
# (the layers' float32 cache bound of test_torch_dense.py)
ATTN_TOL = 2e-5
CACHE_TOL = 1e-4
B, S = 2, 16
S_MAX = 8


@pytest.fixture(scope="module")
def mla():
    ref_cfg = ref_reduced_config(ref_get_config("deepseek-v3-671b"),
                                 dtype=jnp.float32)
    cfg = reduced_config(get_config("deepseek-v3-671b"), dtype=torch.float32)
    ref_p = ref_mla.mla_init(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, ref_p, params_from_reference(ref_p, device="cpu")


def _x(cfg, shape, seed=1):
    a = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_mla_init_matches_the_reference_tree(mla):
    ref_cfg, cfg, ref_p, _ = mla
    p = MLA.mla_init(torch.Generator(), cfg)
    assert sorted(p) == sorted(ref_p)
    for k, v in ref_p.items():
        if isinstance(v, dict):
            assert p[k]["scale"].shape == v["scale"].shape
        else:
            assert tuple(p[k].shape) == v.shape, k


def test_mla_attention_matches_reference(mla):
    ref_cfg, cfg, ref_p, p = mla
    jx, tx = _x(cfg, (B, S))
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = ref_mla.mla_attention(ref_p, jx, ref_cfg,
                                 positions=jnp.asarray(pos))
    got = MLA.mla_attention(p, tx, cfg, positions=torch.from_numpy(
        pos.copy()))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def _caches(cfg, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((B, S_MAX, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S_MAX, cfg.qk_rope_head_dim)).astype(
        np.float32)
    return c, kr


# (mode, position): in the cache, at its last slot, and past it
POSITIONS = {
    "scalar-3": np.array(3, np.int32),
    "scalar-last": np.array(S_MAX - 1, np.int32),
    "scalar-at-length": np.array(S_MAX, np.int32),
    "scalar-past": np.array(S_MAX + 5, np.int32),
    "lanes": np.array([2, 6], np.int32),
    "lanes-one-past": np.array([S_MAX + 5, 3], np.int32),
    "lanes-at-length": np.array([S_MAX, S_MAX - 1], np.int32),
}


@pytest.mark.parametrize("name", list(POSITIONS))
def test_mla_decode_step_matches_reference(mla, name):
    ref_cfg, cfg, ref_p, p = mla
    pos = POSITIONS[name]
    jx, tx = _x(cfg, (B, 1), seed=5)
    c, kr = _caches(cfg)
    want, want_c, want_kr = ref_mla.mla_decode_step(
        ref_p, jx, jnp.asarray(c), jnp.asarray(kr), jnp.asarray(pos),
        ref_cfg)
    cache_c, cache_kr = torch.from_numpy(c.copy()), torch.from_numpy(
        kr.copy())
    got, got_c, got_kr = MLA.mla_decode_step(
        p, tx, cache_c, cache_kr, torch.from_numpy(pos), cfg)
    # written in place: the returned caches are the caller's tensors
    assert got_c is cache_c and got_kr is cache_kr
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    for have, ref, before in ((got_c, want_c, c), (got_kr, want_kr, kr)):
        np.testing.assert_allclose(_np(have), _np(ref), atol=CACHE_TOL,
                                   rtol=CACHE_TOL)
        # the rows the reference keeps are bit-equal to what they were
        same = np.all(np.asarray(ref) == before, axis=-1)
        np.testing.assert_array_equal(_np(have)[same], before[same])
    lanes = np.broadcast_to(pos, (B,))
    for b, at in enumerate(lanes):
        if pos.ndim and at >= S_MAX:  # a lane past the cache writes nothing
            np.testing.assert_array_equal(_np(got_c)[b], c[b])


def test_mla_decode_rerun_rewrites_the_same_slots(mla):
    """The expert pager's fixpoint re-runs a decode step on the same cache:
    the second run must leave the cache and the output bit-identical."""
    _, cfg, _, p = mla
    _, tx = _x(cfg, (B, 1), seed=6)
    c, kr = (torch.from_numpy(a) for a in _caches(cfg))
    for pos in (torch.tensor(4, dtype=torch.int32),
                torch.tensor([1, S_MAX + 2], dtype=torch.int32)):
        out1, c1, kr1 = MLA.mla_decode_step(p, tx, c, kr, pos, cfg)
        snap = (c1.clone(), kr1.clone())
        out2, c2, kr2 = MLA.mla_decode_step(p, tx, c, kr, pos, cfg)
        assert torch.equal(out1, out2)
        assert torch.equal(c2, snap[0]) and torch.equal(kr2, snap[1])


# -- the models' flash at MLA's full head dims ---------------------------------

def test_blocked_flash_at_mla_head_dims():
    """``blocked_flash`` (the CPU path) at D 192, Dv 128, causal, with the
    MLA scale 1/sqrt(192), against the reference's models' flash at its
    float32 tolerance 2e-5: 32-key blocks and 4 strips over 96 tokens."""
    rng = np.random.default_rng(9)
    H, Sq, D, Dv = 2, 96, 192, 128
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((1, Sq, H, D), (1, Sq, H, D), (1, Sq, H, Dv))]
    kw = dict(causal=True, scale=1.0 / np.sqrt(D), block_k=32, n_strips=4)
    got = pt_flash.flash_attention(*(torch.from_numpy(a) for a in arrs), **kw)
    want = ref_flash.flash_attention(*(jnp.asarray(a) for a in arrs), **kw)
    assert got.shape == (1, Sq, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype,D,Dv,q_offset,want", [
    (torch.bfloat16, 192, 128, 0, "wgmma"),    # deepseek-v3's MLA prefill
    (torch.float32, 192, 128, 0, "ffma"),      # its float32 path check
    (torch.bfloat16, 192, 64, 0, "wgmma"),
    (torch.bfloat16, 184, 128, 0, "ffma"),     # no multiple of 16
    (torch.bfloat16, 208, 128, 0, "head dims"),
    (torch.bfloat16, 192, 192, 0, "head dims"),
    (torch.float32, 208, 128, 0, "head dims"),
    (torch.bfloat16, 192, 128, 3, "q_offset"),
])
def test_b2_route_at_mla_head_dims(dtype, D, Dv, q_offset, want):
    if want in ("wgmma", "ffma"):
        assert pt_flash.b2_route(dtype, D, Dv, q_offset) == want
    else:
        with pytest.raises(ValueError, match=f"{want}.*ROADMAP B2"):
            pt_flash.b2_route(dtype, D, Dv, q_offset)
