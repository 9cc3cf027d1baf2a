"""Decode at a position at or past the KV cache's length, against the JAX
reference (ROADMAP C6).

The reference never raises there: at a scalar position its
``dynamic_update_slice`` clamps the write to the last slot, and per lane its
scatter drops the write of a lane past the cache. The mask is computed from
the position either way. A serving engine reaches this state in normal use
(free lanes are stepped too), so the port must write exactly what the
reference writes.

Same numpy inputs through both packages, float32; the reference's
parameters are carried over with ``params_from_reference``. Logits are held
to 1e-4 x max(1, max|logits|) and caches to 1e-4, the float32 bounds of
``test_torch_dense.py``; what the reference leaves untouched must be
``torch.equal`` to what it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import layers as ref_L
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import layers as pt_L
from repro_torch.models import transformer as tf

from _torch_model_parity import as_np, scale_of

B = 2
MAX_LEN = 8         # the full cache's length
WINDOW = 4          # the ring's width, for the sliding-window cases
PAST = [0, 5]       # pos = S_cache + PAST


def _cfgs(arch, **overrides):
    return (ref_reduced_config(ref_get_config(arch), dtype=jnp.float32,
                               **overrides),
            reduced_config(get_config(arch), dtype=torch.float32,
                           **overrides))


def _positions(mode: str, S_cache: int, past: int) -> np.ndarray:
    """The position of the step under test: every lane past the cache
    (scalar), or lane 0 past it and lane 1 inside it (per lane)."""
    at = S_cache + past
    if mode == "scalar":
        return np.array(at, dtype=np.int32)
    return np.array([at, 3], dtype=np.int32)


def _assert_write(mode: str, ring: bool, before: torch.Tensor,
                  after: torch.Tensor) -> None:
    """What the step must have done to one layer's cache (B, S, KV, Dh)
    besides matching the reference: a lane past a full cache keeps every
    slot; a scalar step past it rewrites only the last slot."""
    if ring:
        return
    if mode == "scalar":
        assert torch.equal(after[:, :-1], before[:, :-1])
        assert not torch.equal(after[:, -1], before[:, -1])
    else:
        assert torch.equal(after[0], before[0])
        assert not torch.equal(after[1, 3], before[1, 3])


# -- the layer: gqa_decode_step --------------------------------------------

@pytest.mark.parametrize("past", PAST)
@pytest.mark.parametrize("mode", ["scalar", "lanes", "ring", "ring-lanes"])
def test_gqa_decode_step_past_the_cache(mode, past):
    """Fill the cache through both packages, then step once at
    ``S_cache + past``: the output and both caches match the reference."""
    ring = mode.startswith("ring")
    ref_cfg, cfg = _cfgs("granite-8b",
                         **({"sliding_window": WINDOW} if ring else {}))
    ref_p = ref_L.attention_init(jax.random.PRNGKey(3), ref_cfg)
    p = params_from_reference(ref_p, device="cpu")
    S_cache = WINDOW if ring else MAX_LEN
    shape = (B, S_cache, cfg.n_kv_heads, cfg.head_dim)
    rk, rv = jnp.zeros(shape), jnp.zeros(shape)
    k, v = torch.zeros(shape), torch.zeros(shape)
    rng = np.random.default_rng(2)
    steps = [np.array(t, dtype=np.int32) for t in range(S_cache)]
    steps.append(_positions("lanes" if mode.endswith("lanes") else "scalar",
                            S_cache, past))
    for pos in steps:
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        k0, v0 = k.clone(), v.clone()
        want, rk, rv = ref_L.gqa_decode_step(ref_p, jnp.asarray(x), rk, rv,
                                             jnp.asarray(pos), ref_cfg)
        got, k, v = pt_L.gqa_decode_step(p, torch.from_numpy(x), k, v,
                                         torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(pos))
    np.testing.assert_allclose(k.numpy(), as_np(rk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), as_np(rv), atol=1e-5, rtol=1e-5)
    lanes = "lanes" if mode.endswith("lanes") else "scalar"
    _assert_write(lanes, ring, k0, k)
    _assert_write(lanes, ring, v0, v)


# -- the models: reduced granite-8b (dense) and zamba2-1.2b (hybrid) -------

class _Model:
    """One reduced architecture in both packages, its caches filled to
    ``S_cache`` by scalar decode."""

    def __init__(self, arch: str, ring: bool):
        over = {"sliding_window": WINDOW} if ring else {}
        self.ref_cfg, self.cfg = _cfgs(arch, **over)
        self.ref_params = ref_tf.init_params(jax.random.PRNGKey(0),
                                             self.ref_cfg)
        self.params = params_from_reference(self.ref_params, device="cpu")
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (B, MAX_LEN + 1), dtype=np.int32)
        self.kv_keys = (("k", "v") if self.cfg.family == "dense"
                        else ("shared_k", "shared_v"))
        self.step = jax.jit(lambda p, c, t: ref_tf.decode_step(
            p, c, t, self.ref_cfg))
        ref_cache = ref_tf.init_decode_cache(self.ref_cfg, B, MAX_LEN)
        cache = tf.init_decode_cache(self.cfg, B, MAX_LEN, device="cpu")
        self.S_cache = cache[self.kv_keys[0]].shape[2]
        for t in range(self.S_cache):
            tok = self.tokens[:, t:t + 1]
            _, ref_cache = self.step(self.ref_params, ref_cache,
                                     jnp.asarray(tok))
            _, cache = tf.decode_step(self.params, cache,
                                      torch.from_numpy(tok), self.cfg)
        self.ref_cache, self.cache = ref_cache, cache


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch, ring):
        if (arch, ring) not in built:
            built[arch, ring] = _Model(arch, ring)
        return built[arch, ring]

    return get


MODEL_CASES = [("granite-8b", False), ("granite-8b", True),
               ("zamba2-1.2b", False)]


@pytest.mark.parametrize("past", PAST)
@pytest.mark.parametrize("mode", ["scalar", "lanes"])
@pytest.mark.parametrize("arch,ring", MODEL_CASES,
                         ids=["dense", "dense-ring", "hybrid"])
def test_decode_step_past_the_cache(models, arch, ring, mode, past):
    """One model decode step at ``S_cache + past`` (every lane, or lane 0
    only): logits and every cache entry match the reference's."""
    m = models(arch, ring)
    pos = _positions(mode, m.S_cache, past)
    ref_cache = {**m.ref_cache, "pos": jnp.asarray(pos)}
    cache = {k: v.clone() for k, v in m.cache.items()}
    cache["pos"] = torch.from_numpy(pos)
    before = {k: cache[k].clone() for k in m.kv_keys}
    tok = m.tokens[:, MAX_LEN:MAX_LEN + 1]
    want, ref_new = m.step(m.ref_params, ref_cache, jnp.asarray(tok))
    got, new = tf.decode_step(m.params, cache, torch.from_numpy(tok), m.cfg)
    want = as_np(want)
    assert np.abs(as_np(got) - want).max() <= 1e-4 * scale_of(
        want, m.cfg.vocab_size)
    for key in ref_new:
        assert tuple(new[key].shape) == ref_new[key].shape, key
        np.testing.assert_allclose(as_np(new[key]), as_np(ref_new[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    for key in m.kv_keys:
        for layer in range(new[key].shape[0]):
            _assert_write(mode, ring, before[key][layer], new[key][layer])
