"""The port's mamba2-130m model path and layer-loop tiering against the JAX
reference.

The reference's parameters are carried over with ``params_from_reference``
(torch cannot replay ``jax.random``), and both packages see the same numpy
tokens. Reduced configs as the reference's model tests use them; the
tolerances are stated beside each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core.tiering import TieringConfig as RefTieringConfig
from repro.core.tiering import plan_for_params as ref_plan_for_params
from repro.models import transformer as ref_tf

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.exec import HostFetchEngine
from repro_torch.core.metadata import Tier
from repro_torch.core.tiering import (
    TieringConfig,
    place_params,
    plan_for_params,
    tiered_scan,
)
from repro_torch.models import get_model, make_batch
from repro_torch.models import transformer as tf

from _torch_model_parity import check_init_shapes

B, S = 2, 32
FRACTIONS = [1.0, 0.5, 0.0]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _setup(jdt, tdt):
    ref_cfg = ref_reduced_config(ref_get_config("mamba2-130m"), dtype=jdt)
    cfg = reduced_config(get_config("mamba2-130m"), dtype=tdt)
    ref_params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(ref_params, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    ref_logits, _ = ref_tf.forward(ref_params, {"tokens": jnp.asarray(tokens)},
                                   ref_cfg)
    return ref_cfg, cfg, ref_params, params, tokens, ref_logits


@pytest.fixture(scope="module")
def f32():
    return _setup(jnp.float32, torch.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """get_config and reduced_config build the reference's configs, field
    for field (dtypes aside: jnp there, torch here)."""
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (reduced_config(get_config(arch)),
                       ref_reduced_config(ref_get_config(arch)))):
        a, b = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert str(a.pop("dtype")) == "torch." + str(jnp.dtype(b.pop("dtype")))
        assert a == b


def test_init_params_matches_reference_shapes():
    got = check_init_shapes("mamba2-130m")
    cfg = reduced_config(get_config("mamba2-130m"))
    # the reference's scales: embedding 1, in_proj 1/sqrt(d_model)
    assert 0.9 < got["embed"]["embedding"].float().std() < 1.1
    std = got["layers"]["ssm"]["in_proj"].float().std() * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1


def test_forward_matches_reference_f32(f32):
    """Reduced f32 mamba2-130m: max|diff| <= 1e-4 * max(1, max|logits|)
    (the scale rule of the reference's decode test), greedy tokens equal."""
    ref_cfg, cfg, _, params, tokens, ref_logits = f32
    logits, aux = tf.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    want = _np(ref_logits)
    got = _np(logits)
    assert logits.dtype == torch.float32 and got.shape == want.shape
    V = cfg.vocab_size
    np.testing.assert_array_equal(got[..., V:], want[..., V:])  # NEG_INF pad
    scale = max(1.0, float(np.abs(want[..., :V]).max()))
    assert np.abs(got[..., :V] - want[..., :V]).max() <= 1e-4 * scale
    np.testing.assert_array_equal(got[..., :V].argmax(-1),
                                  want[..., :V].argmax(-1))
    assert float(aux) == 0.0


def test_forward_matches_reference_bf16():
    """Reduced bf16 mamba2-130m. Bound: max|diff| <= 0.05 * max|logits| and
    ||diff|| <= 0.03 * ||logits||. Reason: XLA-CPU's bf16 logistic (in each
    layer's silu) and torch's sigmoid round a third of the elements one bf16
    unit apart (tests/test_torch_ssm.py holds it per block); two layers and
    the tied head carry those flips into the logits. Measured over init
    seeds 0-5: max|diff| up to 0.0139 of max|logits|, relative L2 up to
    0.0109, greedy tokens all equal."""
    _, cfg, _, params, tokens, ref_logits = _setup(jnp.bfloat16,
                                                   torch.bfloat16)
    logits, _ = tf.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    V = cfg.vocab_size
    want, got = _np(ref_logits)[..., :V], _np(logits)[..., :V]
    diff = got - want
    assert np.abs(diff).max() <= 0.05 * np.abs(want).max()
    assert np.linalg.norm(diff) <= 0.03 * np.linalg.norm(want)


def test_decode_step_matches_reference(f32):
    """32 decode steps: logits and the cache (conv ring, state, pos)."""
    ref_cfg, cfg, ref_params, params, tokens, _ = f32
    ref_cache = ref_tf.init_decode_cache(ref_cfg, B, S)
    cache = tf.init_decode_cache(cfg, B, S, device="cpu")
    for t in range(S):
        want, ref_cache = ref_tf.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, t:t + 1]), ref_cfg)
        got, cache = tf.decode_step(params, cache,
                                    torch.from_numpy(tokens[:, t:t + 1]), cfg)
        scale = max(1.0, float(np.abs(_np(want)[..., :cfg.vocab_size]).max()))
        assert np.abs(_np(got) - _np(want)).max() <= 1e-4 * scale, t
    for k in ("conv", "state"):
        assert tuple(cache[k].shape) == ref_cache[k].shape
        np.testing.assert_allclose(_np(cache[k]), _np(ref_cache[k]),
                                   atol=1e-4, rtol=1e-4)
    assert int(cache["pos"]) == int(ref_cache["pos"]) == S


def test_decode_matches_forward(f32):
    """The reference's contract inside the port: token-by-token decode
    reproduces the teacher-forced logits, max|diff| < 1e-3 * max(1, scale)."""
    _, cfg, _, params, tokens, _ = f32
    tok = torch.from_numpy(tokens)
    full, _ = tf.forward(params, {"tokens": tok}, cfg)
    cache = tf.init_decode_cache(cfg, B, S, device="cpu")
    errs = []
    for t in range(S):
        lg, cache = tf.decode_step(params, cache, tok[:, t:t + 1], cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    scale = float(full[..., :cfg.vocab_size].abs().max())
    assert max(errs) < 1e-3 * max(scale, 1.0)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3, 0.0])
def test_plan_for_params_matches_reference(fraction):
    """Same object names, tiers and byte counts as the reference's plan."""
    ref_cfg = ref_reduced_config(ref_get_config("mamba2-130m"))
    ref_params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    want = ref_plan_for_params(ref_params, config=RefTieringConfig(
        mode="host_offload", local_fraction=fraction))
    got = plan_for_params(params_from_reference(ref_params, device="cpu"),
                          config=TieringConfig(mode="host_offload",
                                               local_fraction=fraction))
    assert got.tiers.keys() == want.tiers.keys()
    assert {k: v.value for k, v in got.tiers.items()} == {
        k: v.value for k, v in want.tiers.items()}
    assert (got.local_bytes, got.remote_bytes, got.peak_bytes) == (
        want.local_bytes, want.remote_bytes, want.peak_bytes)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_host_offload_forward_is_bit_identical(f32, fraction, prefetch):
    """Every placement and prefetch setting: logits torch.equal to the
    untiered run's."""
    _, cfg, _, params, tokens, _ = f32
    batch = {"tokens": torch.from_numpy(tokens)}
    oracle, _ = tf.forward(params, batch, cfg)
    placed, plan = place_params(
        params, TieringConfig(mode="host_offload", local_fraction=fraction),
        device="cpu")
    assert (len(plan.remote_names()) > 0) == (fraction < 1.0)
    logits, _ = tf.forward(placed, batch, cfg, prefetch=prefetch, plan=plan)
    assert torch.equal(logits, oracle)


@pytest.mark.parametrize("prefetch", [True, False])
def test_host_offload_decode_is_bit_identical(f32, prefetch):
    _, cfg, _, params, tokens, _ = f32
    placed, plan = place_params(
        params, TieringConfig(mode="host_offload", local_fraction=0.0),
        device="cpu")
    c0 = tf.init_decode_cache(cfg, B, S, device="cpu")
    c1 = tf.init_decode_cache(cfg, B, S, device="cpu")
    for t in range(8):
        tok = torch.from_numpy(tokens[:, t:t + 1])
        want, c0 = tf.decode_step(params, c0, tok, cfg)
        got, c1 = tf.decode_step(placed, c1, tok, cfg, prefetch=prefetch,
                                 plan=plan)
        assert torch.equal(got, want)
    assert torch.equal(c0["state"], c1["state"])


class _Recorder(HostFetchEngine):
    """A CPU fetch engine that logs the order of posts."""

    def __init__(self, log):
        super().__init__(throttle=0.0, device="cpu")
        self.log = log

    def fetch(self, name, payloads, *, pace=True):
        self.log.append(("fetch", name))
        return super().fetch(name, payloads, pace=pace)


@pytest.mark.parametrize("prefetch", [True, False])
def test_tiered_scan_streams_remote_slices(prefetch):
    """Layer i sees slice i of every leaf; only the REMOTE leaves travel
    through the engine, one fetch a layer, posted one layer ahead with
    prefetch and just before the layer without."""
    n = 4
    rng = np.random.default_rng(0)
    stacked = {"w": torch.from_numpy(rng.standard_normal((n, 4, 4))),
               "sub": {"b": torch.from_numpy(rng.standard_normal((n, 4))),
                       "s": torch.arange(n)}}
    log = []
    engine = _Recorder(log)

    def layer(c, p):
        i = int(p["sub"]["s"])
        log.append(("compute", i))
        assert torch.equal(p["w"], stacked["w"][i])
        return c @ p["w"] + p["sub"]["b"]

    x0 = torch.from_numpy(rng.standard_normal((2, 4)))
    out = tiered_scan(layer, x0, stacked, n_layers=n, prefetch=prefetch,
                      remote=frozenset({"['w']"}), engine=engine)
    engine.close()
    want = x0
    for i in range(n):
        want = want @ stacked["w"][i] + stacked["sub"]["b"][i]
    assert torch.equal(out, want)
    assert engine.bytes_read == stacked["w"].numel() * 8
    assert engine.n_ops == n
    order = [("fetch", "layer0")]
    for i in range(n):
        if prefetch and i + 1 < n:
            order.append(("fetch", f"layer{i + 1}"))
        order.append(("compute", i))
        if not prefetch and i + 1 < n:
            order.append(("fetch", f"layer{i + 1}"))
    assert log == order


def test_place_params_puts_leaves_by_tier(f32):
    _, _, _, params, _, _ = f32
    placed, plan = place_params(
        params, TieringConfig(mode="host_offload", local_fraction=0.5),
        device="cpu")
    assert plan.tier_of("params['embed']['embedding']") is Tier.REMOTE
    assert plan.tier_of("params['ln_f']['scale']") is Tier.LOCAL  # small
    assert torch.equal(placed["layers"]["ssm"]["in_proj"],
                       params["layers"]["ssm"]["in_proj"])
    none_placed, none_plan = place_params(params, TieringConfig(),
                                          device="cpu")
    assert none_plan is None
    assert none_placed["embed"]["embedding"].device.type == "cpu"


def test_tiering_rejects_what_waits_for_later_slices():
    with pytest.raises(NotImplementedError, match="A11"):
        TieringConfig(mode="fsdp_stream")
    with pytest.raises(ValueError, match="unknown mode"):
        TieringConfig(mode="disk")
    params = {"w": torch.ones((4, 4))}
    # the "auto" budget no longer waits: the sizing solver plans it (its
    # plans are held against the reference's in test_torch_runtime.py)
    auto = plan_for_params(params, config=TieringConfig(local_fraction="auto"))
    assert set(auto.tiers) == {"params['w']"}
    with pytest.raises(NotImplementedError, match="A9"):
        plan_for_params(params, config=TieringConfig(), opt_state=params)


def test_tiered_scan_checks_the_stack():
    stacked = {"w": torch.ones((3, 2, 2)), "b": torch.ones((4, 2))}
    with pytest.raises(ValueError, match="do not all equal n_layers=3"):
        tiered_scan(lambda c, p: c, torch.ones(2), stacked, n_layers=3)
    ok = {"w": torch.ones((3, 2, 2))}
    with pytest.raises(ValueError, match="not in stacked_params"):
        tiered_scan(lambda c, p: c, torch.ones(2), ok, n_layers=3,
                    remote=frozenset({"['v']"}))
    with pytest.raises(ValueError, match="need a HostFetchEngine"):
        tiered_scan(lambda c, p: c, torch.ones(2), ok, n_layers=3,
                    remote=frozenset({"['w']"}))


def test_other_families_name_their_roadmap_item():
    """The dense, vlm, moe, ssm and hybrid families are served (the moe
    family's entry points run: both its configs, GQA with a sliding window
    and MLA); the enc-dec family names ROADMAP A9."""
    for arch, keys in (("mixtral-8x7b", {"k", "v"}),
                       ("deepseek-v3-671b", {"c", "kr"})):
        moe = reduced_config(get_config(arch))
        model = get_model(moe)
        params = model.init_params(torch.Generator(), moe, device="cpu")
        logits, aux = model.forward(
            params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, moe)
        assert logits.shape[:2] == (1, 4) and float(aux) > 0.0
        cache = model.init_decode_cache(moe, 1, 4, device="cpu")
        assert set(cache) == keys | {"pos"}
    encdec = reduced_config(get_config("seamless-m4t-medium"))
    with pytest.raises(NotImplementedError, match="A9"):
        get_model(encdec)
    with pytest.raises(NotImplementedError, match="A9"):
        make_batch(encdec, torch.Generator(), 1, 4, device="cpu")
    for arch in ("granite-8b", "internvl2-1b", "zamba2-1.2b"):
        cfg = reduced_config(get_config(arch))
        assert get_model(cfg).init_decode_cache(cfg, 1, 4, device="cpu")


def test_make_batch():
    cfg = reduced_config(get_config("mamba2-130m"))
    batch = make_batch(cfg, torch.Generator().manual_seed(3), 3, 16,
                       device="cpu")
    tok = batch["tokens"]
    assert tok.shape == (3, 16) and tok.dtype == torch.int32
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab_size
    assert batch["labels"] is tok


def test_entry_points_run_on_the_card_by_default():
    """Without a card the default device raises; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced_config(get_config("mamba2-130m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, torch.Generator(), 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_decode_cache(cfg, 1, 4)
