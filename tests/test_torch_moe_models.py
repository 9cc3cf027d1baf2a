"""The port's moe family (``repro_torch.models.transformer``) against the JAX
reference, on reduced deepseek-v3 (MLA, one ``first_k_dense`` block, one
MoE block with a shared expert, the ``mtp`` block) and reduced mixtral-8x7b
(GQA with a sliding window, two MoE blocks), float32.

The reference's parameters are carried over by
``convert.params_from_reference``; the same numpy tokens go through both.
Tolerances, beside each check:

* forward logits within 1e-4 x max(1, max|logits|) and the same greedy
  tokens, the aux loss within 1e-5 (``test_torch_dense.py``'s float32
  bounds; the MoE routing is the same, the sums a few units apart);
* each decode step's logits within the forward's bound, the caches within
  1e-4, the router decision of ``decode_step(return_routing=True)``
  equal (``top_i``) and within 1e-5 (``top_p``);
* decode against forward in the reference's no-drop setup (capacity
  factor 8, ``moe_groups=1``): max|diff| < 1e-3, its own bound;
* exact: every ``host_offload`` placement, per-lane decode against each
  lane alone, a re-run of ``decode_step`` on the same cache (the expert
  pager's fixpoint), and the leaf order against ``jax.tree_util``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.models import transformer as tf

from _torch_model_parity import (
    B,
    FRACTIONS,
    S,
    as_np,
    check_decode_steps,
    check_init_shapes,
    check_lane_decode,
    check_offload_decode,
    check_offload_forward,
    make_pair,
    one_torch_thread,  # noqa: F401 (autouse)
    scale_of,
)

ARCHS = ["deepseek-v3-671b", "mixtral-8x7b"]
CACHE_KEYS = {"deepseek-v3-671b": ("c", "kr"), "mixtral-8x7b": ("k", "v")}
AUX_TOL = 1e-5
ROUTING_TOL = 1e-5


@pytest.fixture(scope="module")
def pairs():
    return {arch: make_pair(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(pairs, arch):
    pair = pairs[arch]
    logits, aux = tf.forward(pair.params, pair.batch, pair.cfg)
    _, want_aux = ref_tf.forward(pair.ref_params, pair.ref_batch,
                                 pair.ref_cfg)
    got, want = as_np(logits), pair.ref_logits
    V = pair.cfg.vocab_size
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., V:], want[..., V:])
    assert np.abs(got[..., :V] - want[..., :V]).max() <= 1e-4 * scale_of(
        want, V)
    np.testing.assert_array_equal(got[..., :V].argmax(-1),
                                  want[..., :V].argmax(-1))
    assert float(want_aux) > 0.0
    np.testing.assert_allclose(float(aux), float(want_aux), atol=AUX_TOL,
                               rtol=AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(pairs, arch):
    check_decode_steps(pairs[arch], CACHE_KEYS[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_routing_matches_reference(pairs, arch):
    """``decode_step(return_routing=True)``: the MoE layers' top-k per
    lane, stacked (nL_moe, B, 1, k), as the reference's."""
    pair = pairs[arch]
    cfg = pair.cfg
    step = jax.jit(lambda p, c, t: ref_tf.decode_step(
        p, c, t, pair.ref_cfg, moe_groups=1, return_routing=True))
    ref_cache = ref_tf.init_decode_cache(pair.ref_cfg, B, S)
    cache = tf.init_decode_cache(cfg, B, S, device="cpu")
    n_moe = cfg.n_layers - cfg.first_k_dense
    for t in range(6):
        tok = pair.tokens[:, t:t + 1]
        _, ref_cache, want = step(pair.ref_params, ref_cache,
                                  jnp.asarray(tok))
        _, cache, got = tf.decode_step(pair.params, cache,
                                       torch.from_numpy(tok), cfg,
                                       moe_groups=1, return_routing=True)
        assert tuple(got["top_i"].shape) == (n_moe, B, 1, cfg.top_k)
        np.testing.assert_array_equal(got["top_i"].numpy(),
                                      np.asarray(want["top_i"]))
        np.testing.assert_allclose(got["top_p"].numpy(),
                                   np.asarray(want["top_p"]),
                                   atol=ROUTING_TOL, rtol=ROUTING_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_no_drops(arch):
    """The reference's ``test_moe_decode_matches_forward_no_drops``: with
    capacity factor 8 no slot drops, so decoding one token at a time in
    one dispatch group reproduces the forward's logits (< 1e-3)."""
    ref_cfg = ref_reduced_config(ref_get_config(arch), dtype=jnp.float32,
                                 capacity_factor=8.0)
    cfg = reduced_config(get_config(arch), dtype=torch.float32,
                         capacity_factor=8.0)
    params = params_from_reference(
        ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 16), dtype=np.int32))
    full, _ = tf.forward(params, {"tokens": tok}, cfg)
    cache = tf.init_decode_cache(cfg, B, 16, device="cpu")
    errs = []
    for t in range(16):
        lg, cache = tf.decode_step(params, cache, tok[:, t:t + 1], cfg,
                                   moe_groups=1)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 1e-3


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("fraction", FRACTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_offload_forward_bit_identical(pairs, arch, fraction, prefetch):
    plan = check_offload_forward(pairs[arch], fraction, prefetch)
    if fraction == 0.0:  # the routed experts stream through the MoE loop
        assert "params['layers']['moe']['w_gate']" in plan.remote_names()


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_offload_decode_bit_identical(pairs, arch, prefetch):
    check_offload_decode(pairs[arch], prefetch, CACHE_KEYS[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_lane_decode_equals_each_lane_alone(pairs, arch):
    check_lane_decode(pairs[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rerun_on_the_same_cache_is_bit_identical(pairs, arch):
    """The expert pager's fixpoint re-runs ``decode_step`` on the cache it
    was given: the latent or K/V slots written in place are rewritten with
    the same values, so the logits, the routing and every cache leaf are
    bit-identical run after run, scalar and per lane."""
    pair = pairs[arch]
    cfg = pair.cfg
    for lanes in (False, True):
        cache = tf.init_decode_cache(cfg, B, S, device="cpu")
        if lanes:
            cache["pos"] = torch.tensor([0, 3], dtype=torch.int32)
        for t in range(4):
            _, cache = tf.decode_step(pair.params, cache, torch.from_numpy(
                pair.tokens[:, t:t + 1]), cfg, moe_groups=1)
        tok = torch.from_numpy(pair.tokens[:, 4:5])
        runs = []
        for _ in range(2):
            lg, new, rt = tf.decode_step(pair.params, cache, tok, cfg,
                                         moe_groups=1, return_routing=True)
            runs.append((lg, {k: v.clone() for k, v in new.items()}, rt))
        (lg1, c1, rt1), (lg2, c2, rt2) = runs
        assert torch.equal(lg1, lg2)
        assert torch.equal(rt1["top_i"], rt2["top_i"])
        assert torch.equal(rt1["top_p"], rt2["top_p"])
        for k in c1:
            assert torch.equal(c1[k], c2[k]), k
        assert torch.equal(c1["pos"], cache["pos"] + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_matches_jax(pairs, arch):
    """The catalogue and the plans walk the leaves in this order: the
    reference's ``jax.tree_util`` order, the ``mtp`` subtree included."""
    pair = pairs[arch]
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_leaves_with_path(pair.ref_params)]
    assert [k for k, _ in _leaves_with_keys(pair.params)] == want
    if arch == "deepseek-v3-671b":
        assert any(k.startswith("['mtp']") for k in want)
        assert any(k.startswith("['dense_layers']") for k in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_the_reference_tree(arch):
    check_init_shapes(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_match_init_params(arch):
    """The reference's moe params (the float32 router, the ``mtp`` subtree)
    carried over have the keys, shapes and dtypes of the port's own
    ``init_params``, in bf16."""
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    got = params_from_reference(
        ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg), device="cpu")
    own = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def spec(tree):
        return [(k, tuple(t.shape), t.dtype) for k, t in
                _leaves_with_keys(tree)]

    assert spec(got) == spec(own)
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    assert got["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
