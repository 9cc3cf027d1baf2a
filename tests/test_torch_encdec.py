"""The enc-dec family (reduced seamless-m4t-medium) in the port against the
reference: forward, ``prefill``'s cross K/V, decode, the loss and its
gradients under remat (also at 12 decoder layers, where checkpoints
nest), every placement and prefetch setting, and ``make_batch``'s frames.
The reference's parameters are carried over with ``params_from_reference``
and both packages see the same numpy frames and tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import encdec as ref_ed

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.tiering import (
    TieringConfig,
    map_leaves,
    place_params,
    place_state,
)
from repro_torch.models import encdec as ed
from repro_torch.models import get_model, make_batch
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.step import (
    TrainStepConfig,
    make_train_step,
    make_value_and_grad,
)

from _torch_model_parity import DTYPES, FRACTIONS, as_np
from _torch_model_parity import one_torch_thread  # noqa: F401
from _torch_train_parity import Ref, check_f32

ARCH = "seamless-m4t-medium"
B, S = 2, 32


class Pair:
    """Reduced seamless-m4t-medium in both packages on the same inputs."""

    def __init__(self, dtype: str = "float32"):
        jdt, tdt = DTYPES[dtype]
        self.ref_cfg = ref_reduced_config(ref_get_config(ARCH), dtype=jdt)
        self.cfg = reduced_config(get_config(ARCH), dtype=tdt)
        self.ref_params = ref_ed.init_params(jax.random.PRNGKey(0),
                                             self.ref_cfg)
        self.params = params_from_reference(self.ref_params, device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S),
                                   dtype=np.int32)
        frames = rng.standard_normal(
            (B, self.cfg.frontend_len, self.cfg.d_model)).astype(np.float32)
        self.ref_batch = {"tokens": jnp.asarray(self.tokens),
                          "frames": jnp.asarray(frames).astype(jdt)}
        self.batch = {"tokens": torch.from_numpy(self.tokens),
                      "frames": torch.from_numpy(frames).to(tdt)}
        self.ref_logits = as_np(ref_ed.forward(self.ref_params,
                                               self.ref_batch,
                                               self.ref_cfg)[0])

    @property
    def V(self) -> int:
        return self.cfg.vocab_size

    def scale(self) -> float:
        return max(1.0, float(np.abs(self.ref_logits[..., :self.V]).max()))

    def ref_cache(self):
        return ref_ed.prefill(self.ref_params,
                              ref_ed.init_decode_cache(self.ref_cfg, B, S),
                              self.ref_batch["frames"], self.ref_cfg)

    def cache(self, params=None, **kw):
        return ed.prefill(params or self.params,
                          ed.init_decode_cache(self.cfg, B, S, device="cpu"),
                          self.batch["frames"], self.cfg, **kw)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_get_model_and_init_shapes(pair):
    """``get_model`` returns this module for both enc-dec families, and
    ``init_params`` builds the reference's tree: leaves, shapes, dtypes."""
    assert get_model(pair.cfg) is ed
    assert get_model(reduced_config(get_config(ARCH), family="audio")) is ed
    got = dict(_leaves_with_keys(ed.init_params(
        torch.Generator().manual_seed(0), pair.cfg, device="cpu")))
    want = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(pair.ref_params)}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == "torch." + str(v.dtype), k


def test_forward_matches_reference_f32(pair):
    """Logits within 1e-4 x max(1, max|logits|), the padded vocabulary
    equal, greedy tokens equal, aux 0."""
    logits, aux = ed.forward(pair.params, pair.batch, pair.cfg)
    got, want = as_np(logits), pair.ref_logits
    assert logits.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., pair.V:], want[..., pair.V:])
    assert np.abs(got[..., :pair.V] - want[..., :pair.V]).max() <= (
        1e-4 * pair.scale())
    np.testing.assert_array_equal(got[..., :pair.V].argmax(-1),
                                  want[..., :pair.V].argmax(-1))
    assert float(aux) == 0.0


def test_prefill_cross_kv_matches_reference_f32(pair):
    """``prefill``'s ``ck`` and ``cv`` within 1e-4 of the reference's,
    written into the cache it was given."""
    want = pair.ref_cache()
    cache = ed.init_decode_cache(pair.cfg, B, S, device="cpu")
    ck = cache["ck"]
    got = ed.prefill(pair.params, cache, pair.batch["frames"], pair.cfg)
    assert got["ck"] is ck
    for k in ("ck", "cv"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(as_np(got[k]), as_np(want[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_forward_and_prefill_match_reference_bf16():
    """bf16 at the dense bf16 tests' bounds (ROADMAP C2, C4):
    max|diff| <= 0.05 x max|logits| and ||diff|| <= 0.03 x ||logits||,
    for the logits and for ``ck`` and ``cv``. Measured (init seed 0):
    logits 0.0073 and 0.0089, ck and cv 0.0096 and 0.0070 at most."""
    bf = Pair("bfloat16")
    logits, _ = ed.forward(bf.params, bf.batch, bf.cfg)
    cache, ref_cache = bf.cache(), bf.ref_cache()
    for got, want in ((as_np(logits)[..., :bf.V], bf.ref_logits[..., :bf.V]),
                      (as_np(cache["ck"]), as_np(ref_cache["ck"])),
                      (as_np(cache["cv"]), as_np(ref_cache["cv"]))):
        diff = got - want
        assert np.abs(diff).max() <= 0.05 * np.abs(want).max()
        assert np.linalg.norm(diff) <= 0.03 * np.linalg.norm(want)


def test_decode_matches_reference_decode(pair):
    """Every decode step's logits within 1e-4 x the forward's scale of the
    reference's decode step, and the self K/V caches equal."""
    step = jax.jit(lambda p, c, t: ref_ed.decode_step(p, c, t, pair.ref_cfg))
    ref_cache, cache = pair.ref_cache(), pair.cache()
    for t in range(S):
        want, ref_cache = step(pair.ref_params, ref_cache,
                               jnp.asarray(pair.tokens[:, t:t + 1]))
        got, cache = ed.decode_step(pair.params, cache, torch.from_numpy(
            pair.tokens[:, t:t + 1]), pair.cfg)
        assert np.abs(as_np(got) - as_np(want)).max() <= 1e-4 * pair.scale()
    for k in ("k", "v"):
        np.testing.assert_allclose(as_np(cache[k]), as_np(ref_cache[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    assert int(cache["pos"]) == int(ref_cache["pos"]) == S


def test_decode_matches_forward(pair):
    """The reference's ``test_decode_matches_forward`` case: after
    ``prefill``, token-by-token decode reproduces the teacher-forced
    logits, max|diff| < 1e-3 x max(1, scale)."""
    full, _ = ed.forward(pair.params, pair.batch, pair.cfg)
    cache = pair.cache()
    tok = pair.batch["tokens"]
    errs = []
    for t in range(S):
        lg, cache = ed.decode_step(pair.params, cache, tok[:, t:t + 1],
                                   pair.cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    scale = float(full[..., :pair.V].abs().max())
    assert max(errs) < 1e-3 * max(scale, 1.0)


@pytest.fixture(scope="module")
def ref2():
    return Ref(ARCH)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_reference(ref2, remat):
    """The loss and every gradient (the encoder's included) against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    check_f32(ref2, *ref2.port_loss_and_grads(remat))


def test_loss_and_grads_at_12_decoder_layers():
    """At 12 decoder layers remat "full" nests (3 blocks of 4): the
    decoder reads the encoder output inside every checkpointed layer and
    its gradient still reaches the encoder's parameters, equal to the
    reference's and to remat "none"'s exactly."""
    ref = Ref(ARCH, n_layers=12, vocab_size=64)
    loss, metrics, grads = ref.port_loss_and_grads("full")
    check_f32(ref, loss, metrics, grads)
    assert float(grads["['enc_layers']['attn']['wq']"].abs().max()) > 0
    base_loss, _, base = ref.port_loss_and_grads("none")
    assert torch.equal(loss, base_loss)
    for k in grads:
        assert torch.equal(grads[k], base[k]), k


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_placements_forward_prefill_and_decode_are_bit_equal(pair, fraction,
                                                             prefetch):
    """host_offload at each fraction, prefetch on and off: the logits, the
    cross K/V and 8 decode steps (logits and caches) torch.equal to the
    untiered run's."""
    oracle, _ = ed.forward(pair.params, pair.batch, pair.cfg)
    placed, plan = place_params(
        pair.params, TieringConfig(mode="host_offload",
                                   local_fraction=fraction), device="cpu")
    assert (len(plan.remote_names()) > 0) == (fraction < 1.0)
    logits, _ = ed.forward(placed, pair.batch, pair.cfg, prefetch=prefetch,
                           plan=plan)
    assert torch.equal(logits, oracle)
    c0 = pair.cache()
    c1 = pair.cache(placed, plan=plan, prefetch=prefetch)
    for t in range(8):
        tok = torch.from_numpy(pair.tokens[:, t:t + 1])
        want, c0 = ed.decode_step(pair.params, c0, tok, pair.cfg)
        got, c1 = ed.decode_step(placed, c1, tok, pair.cfg, plan=plan,
                                 prefetch=prefetch)
        assert torch.equal(got, want), t
    for k in ("k", "v", "ck", "cv"):
        assert torch.equal(c0[k], c1[k]), k


def test_train_step_placements_are_bit_equal(pair):
    """One train step untiered and at host_offload 0.0 with parameters and
    moments in the plan, prefetch on and off: loss, every gradient and
    every updated parameter and moment torch.equal."""
    cfg, opt_cfg = pair.cfg, AdamWConfig(lr=1e-3, warmup_steps=0)
    batch = {**pair.batch, "labels": pair.batch["tokens"]}
    out = {}
    for name, tiering in {
            "untiered": TieringConfig(),
            "0.0": TieringConfig(mode="host_offload", local_fraction=0.0),
            "0.0 prefetch off": TieringConfig(
                mode="host_offload", local_fraction=0.0, prefetch=False),
    }.items():
        params = map_leaves(lambda _k, t: t.clone(), pair.params)
        p, o, plan = place_state(params, adamw.init(opt_cfg, params),
                                 tiering, device="cpu")
        step_cfg = TrainStepConfig.from_tiering(tiering)
        loss, _, grads = make_value_and_grad(cfg, step_cfg, plan=plan)(
            p, batch)
        p1, o1, m = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)(
            p, o, batch)
        out[name] = [loss, m["loss"], grads, dict(_leaves_with_keys(p1)),
                     dict(_leaves_with_keys(o1))]
    base = out.pop("untiered")
    for name, got in out.items():
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        for i in (2, 3, 4):
            assert got[i].keys() == base[i].keys()
            for k in got[i]:
                assert torch.equal(got[i][k], base[i][k]), (name, k)


def test_make_batch_draws_frames():
    """``frames`` (batch, frontend_len, d_model), N(0, 1) in the model's
    dtype, on the device asked for; tokens and labels as every family's."""
    cfg = reduced_config(get_config(ARCH), dtype=torch.bfloat16)
    batch = make_batch(cfg, torch.Generator().manual_seed(3), 3, 16,
                       device="cpu")
    fr = batch["frames"]
    assert tuple(fr.shape) == (3, cfg.frontend_len, cfg.d_model)
    assert fr.dtype == torch.bfloat16 and fr.device.type == "cpu"
    assert abs(float(fr.float().mean())) < 0.2
    assert 0.8 < float(fr.float().std()) < 1.2
    assert batch["labels"] is batch["tokens"]
    assert tuple(batch["tokens"].shape) == (3, 16)
