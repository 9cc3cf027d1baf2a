"""The port's hybrid family (zamba2-1.2b: a Mamba2 stack with one shared
attention block applied after every ``hybrid_attn_every`` layers) against
the JAX reference, reduced, on the same numpy tokens with the reference's
parameters carried over. Tolerances are stated beside each test."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.tiering import TieringConfig, place_params
from repro_torch.models import transformer as tf

from _torch_model_parity import (
    B,
    FRACTIONS,
    S,
    as_np,
    check_decode_matches_forward,
    check_decode_steps,
    check_forward_f32,
    check_init_shapes,
    check_lane_decode,
    check_offload_decode,
    check_offload_forward,
    fetch_log,  # noqa: F401  (a fixture)
    make_pair,
)

ARCH = "zamba2-1.2b"
CACHE_KEYS = ("conv", "state", "shared_k", "shared_v")


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


def test_reduced_config_has_groups_and_no_tail():
    """The reduced config runs 2 groups of 2 Mamba2 layers, each followed
    by the shared block."""
    cfg = reduced_config(get_config(ARCH))
    assert (cfg.n_layers, cfg.hybrid_attn_every) == (4, 2)


def test_init_params_matches_reference_shapes():
    got = check_init_shapes(ARCH)
    assert set(got["shared_attn"]) == {"ln1", "ln2", "attn", "mlp"}
    assert got["shared_attn"]["attn"]["wq"].ndim == 2  # one block, unstacked


def test_params_from_reference_carries_the_shared_block(pair):
    """Every leaf, the shared block's included, arrives with its values."""
    flat = {}

    def walk(t, key=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, key + "/" + k)
        else:
            flat[key] = t

    walk(pair.params)
    assert "/shared_attn/attn/wq" in flat and "/shared_attn/mlp/w_down" in flat
    np.testing.assert_array_equal(
        flat["/shared_attn/mlp/w_gate"].numpy(),
        np.asarray(pair.ref_params["shared_attn"]["mlp"]["w_gate"]))


def test_forward_matches_reference_f32(pair):
    check_forward_f32(pair)


def test_decode_steps_match_reference(pair):
    check_decode_steps(pair, CACHE_KEYS)


def test_decode_matches_forward(pair):
    check_decode_matches_forward(pair)


def test_lane_decode_is_bit_identical(pair):
    check_lane_decode(pair)


def test_forward_matches_reference_bf16():
    """Reduced bf16 zamba2-1.2b. Bound: max|diff| <= 0.1 * max|logits| and
    ||diff|| <= 0.05 * ||logits||. Reason: both packages round at the same
    points, but XLA-CPU's bf16 logistic (in every Mamba2 layer's and the
    MLP's silu) and torch's sigmoid round a third of the elements one bf16
    unit apart (ROADMAP C4); four Mamba2 layers and two passes through the
    shared block (twice the depth of the reduced mamba2-130m, whose bound
    is 0.05 and 0.03) carry those flips into the logits. Measured over init
    seeds 0-5: max|diff| up to 0.0588 of max|logits|, relative L2 up to
    0.0276, greedy tokens agreeing at 95-100 %."""
    bf = make_pair(ARCH, "bfloat16")
    logits, _ = tf.forward(bf.params, bf.batch, bf.cfg)
    V = bf.cfg.vocab_size
    want, got = bf.ref_logits[..., :V], as_np(logits)[..., :V]
    diff = got - want
    assert np.abs(diff).max() <= 0.1 * np.abs(want).max()
    assert np.linalg.norm(diff) <= 0.05 * np.linalg.norm(want)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_host_offload_forward_is_bit_identical(pair, fraction, prefetch):
    """Every placement and prefetch setting: logits torch.equal to the
    untiered run's."""
    check_offload_forward(pair, fraction, prefetch)


@pytest.mark.parametrize("prefetch", [True, False])
def test_host_offload_decode_is_bit_identical(pair, prefetch):
    check_offload_decode(pair, prefetch, CACHE_KEYS)


def test_shared_block_is_fetched_once(pair, fetch_log):
    """With every leaf REMOTE, a forward reads the shared block once (not
    once per use), each layer's slices once, and the embedding at each of
    its two uses; so does a decode step."""
    cfg = pair.cfg
    placed, plan = place_params(pair.params, TieringConfig(
        mode="host_offload", local_fraction=0.0), device="cpu")
    assert any(n.startswith("params['shared_attn']")
               for n in plan.remote_names())
    oracle, _ = tf.forward(pair.params, pair.batch, cfg)
    logits, _ = tf.forward(placed, pair.batch, cfg, plan=plan)
    assert torch.equal(logits, oracle)
    layers = [f"layer{i}" for i in range(cfg.n_layers)]
    assert fetch_log.count("shared_attn") == 1
    assert fetch_log.count("embed") == 2
    assert sorted(n for n in fetch_log if n.startswith("layer")) == layers
    fetch_log.clear()
    cache = tf.init_decode_cache(cfg, B, S, device="cpu")
    tf.decode_step(placed, cache, torch.from_numpy(pair.tokens[:, :1]), cfg,
                   plan=plan)
    assert fetch_log.count("shared_attn") == 1
    assert sorted(n for n in fetch_log if n.startswith("layer")) == layers


def test_decode_cache_is_written_in_place(pair):
    """The shared block's KV cache is updated in place (no copy of the
    cache per step); the SSM state is a new tensor, as in the reference."""
    cfg = pair.cfg
    cache = tf.init_decode_cache(cfg, B, S, device="cpu")
    k, state = cache["shared_k"], cache["state"]
    _, new = tf.decode_step(pair.params, cache,
                            torch.from_numpy(pair.tokens[:, :1]), cfg)
    assert new["shared_k"] is k and bool(k[:, :, 0].abs().sum() > 0)
    assert new["state"] is not state
    assert int(new["pos"]) == 1
