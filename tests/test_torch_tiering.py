"""The port's layer loop under checkpointing (``repro_torch.core.tiering``):
the reference's cases of ``tests/test_tiering.py`` pointed at the port,
the scan held against the reference's on the same inputs, REMOTE leaves'
gradients through the fetch engine, and the plan over parameters and
optimizer state equal to the reference's."""
import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import noop_context_fn

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core import tiering as ref_tiering
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.exec import HostFetchEngine
from repro_torch.core.metadata import Tier
from repro_torch.core.tiering import (
    RemoteGrads,
    TieringConfig,
    _block_split,
    blocked_remat_scan,
    grad_safe_barrier,
    plan_for_params,
    prefetch_scan,
    remote_carry_placer,
    tiered_scan,
)
from repro_torch.models import transformer as tf
from repro_torch.models.api import make_batch
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as adamw_init

D = 8
REMAT_MODES = {
    "none": (False, None),
    "dots": (True, tf.REMAT_POLICIES["dots"]),
    "full": (True, noop_context_fn),
}


def _layer(c, p):
    return torch.tanh(c @ p["w"] + p["b"])


def _setup_np(L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, D)).astype(np.float32),
            {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
             "b": (0.1 * rng.standard_normal((L, D))).astype(np.float32)})


def _setup(L, seed=0):
    x0, st = _setup_np(L, seed)
    return (torch.from_numpy(x0).requires_grad_(True),
            {k: torch.from_numpy(v).requires_grad_(True) for k, v in st.items()})


def _value_and_grads(fn, x0, stacked):
    loss = fn(x0, stacked)
    g = torch.autograd.grad(loss, [x0, stacked["b"], stacked["w"]])
    return loss.detach(), g


def _oracle_loss(x0, stacked, L):
    c = x0
    for i in range(L):
        c = _layer(c, {k: t[i] for k, t in stacked.items()})
    return (c ** 2).sum()


@pytest.mark.parametrize("L", [5, 12, 16])  # 5 is prime: single-block remat
@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("mode", list(REMAT_MODES))
def test_matches_unscanned_oracle(L, prefetch, mode):
    remat, policy = REMAT_MODES[mode]
    x0, stacked = _setup(L)

    def loss(x0, stacked):
        c = tiered_scan(_layer, x0, stacked, n_layers=L, remat=remat,
                        policy=policy, prefetch=prefetch, min_layers=4)
        return (c ** 2).sum()

    l_got, g_got = _value_and_grads(loss, x0, stacked)
    l_ref, g_ref = _value_and_grads(lambda x, s: _oracle_loss(x, s, L), x0,
                                    stacked)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-6)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_prefetch_bit_identical_under_remat(mode):
    """Prefetch changes fetch timing only: loss/grads exactly equal."""
    remat, policy = REMAT_MODES[mode]
    L = 12
    x0, stacked = _setup(L)

    def lg(prefetch):
        def loss(x0, stacked):
            c = tiered_scan(_layer, x0, stacked, n_layers=L, remat=remat,
                            policy=policy, prefetch=prefetch, min_layers=4)
            return (c ** 2).sum()
        return _value_and_grads(loss, x0, stacked)

    l_on, g_on = lg(True)
    l_off, g_off = lg(False)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


def test_grad_of_barriered_checkpoint_scan_does_not_raise():
    L = 6
    x0, stacked = _setup(L)
    from torch.utils.checkpoint import checkpoint

    c = x0
    for i in range(L):
        c = checkpoint(lambda cc, w, b: _layer(grad_safe_barrier(cc),
                                               {"w": w, "b": b}),
                       c, stacked["w"][i], stacked["b"][i],
                       use_reentrant=False)
    g = torch.autograd.grad(c.sum(), x0)[0]
    assert bool(torch.isfinite(g).all())


def test_grad_safe_barrier_is_identity_with_identity_grad():
    x = {"a": torch.arange(6.0).reshape(2, 3).requires_grad_(True),
         "b": torch.ones((), requires_grad=True)}
    y = grad_safe_barrier(x)
    for k in x:
        assert torch.equal(x[k], y[k])
    ga, gb = torch.autograd.grad((grad_safe_barrier(x)["a"] * 2.0).sum(),
                                 [x["a"], x["b"]], allow_unused=True)
    assert torch.equal(ga, torch.full((2, 3), 2.0))
    assert gb is None  # unused: the reference's zero cotangent


def test_tuple_carry_with_scalar_aux():
    """MoE-shaped carry: (activations, scalar aux accumulator)."""
    L = 6
    x0, stacked = _setup(L)

    def layer(carry, p):
        x, aux = carry
        x = _layer(x, p)
        return x, aux + x.sum()

    x, aux = tiered_scan(layer, (x0, torch.zeros(())), stacked, n_layers=L,
                         remat=True, policy=noop_context_fn, min_layers=2)
    g = torch.autograd.grad((x ** 2).sum() + 0.1 * aux, x0)[0]
    assert bool(torch.isfinite(g).all())


class TestBlockSplit:
    @pytest.mark.parametrize("n", [1, 2, 5, 12, 16, 36, 97])
    def test_exact_factorization_outer_le_inner(self, n):
        n_outer, n_inner = _block_split(n)
        assert n_outer * n_inner == n
        assert n_outer <= n_inner
        assert (n_outer, n_inner) == ref_tiering._block_split(n)

    def test_prime_degenerates_to_single_block(self):
        assert _block_split(5) == (1, 5)
        assert _block_split(97) == (1, 97)

    def test_square_is_sqrt(self):
        assert _block_split(16) == (4, 4)

    def test_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            _block_split(0)


def test_depth_mismatch_raises_clear_error():
    x0, stacked = _setup(5)
    with pytest.raises(ValueError, match="mis-block"):
        tiered_scan(_layer, x0, stacked, n_layers=7)


def test_peer_leaves_must_be_known_and_split():
    """``tiered_scan(peer=)`` gathers only leaves a placement split over a
    mesh axis (``peer_keys`` of an fsdp_stream plan): a key not in the
    stack, or a leaf not split over its axis (a plain tensor), raises."""
    x0, stacked = _setup(3)
    with pytest.raises(ValueError, match="not in stacked_params"):
        tiered_scan(_layer, x0, stacked, n_layers=3, peer={"['u']": "data"})
    with pytest.raises(ValueError, match="not split"):
        tiered_scan(_layer, x0, stacked, n_layers=3, peer={"['w']": "data"})


def test_deprecated_shims_delegate():
    L = 6
    x0, stacked = _setup(L)
    ref = _oracle_loss(x0, stacked, L)
    for out in (prefetch_scan(_layer, x0, stacked, n_layers=L),
                blocked_remat_scan(_layer, x0, stacked, n_layers=L)):
        np.testing.assert_allclose((out ** 2).sum().detach(), ref.detach(),
                                   rtol=1e-6)


def test_remote_carry_placer_needs_no_mesh():
    assert remote_carry_placer(None) is None
    # under a mesh it places DTensor carries (test_torch_mesh.py); a plain
    # tensor or a scalar passes through
    place = remote_carry_placer(object())
    x, aux = torch.ones((2, 3)), torch.zeros(())
    got = place((x, aux))
    assert got[0] is x and got[1] is aux


@pytest.mark.parametrize("mode", ["none", "full"])
@pytest.mark.parametrize("L", [5, 16])
def test_scan_matches_reference_scan(mode, L):
    """The same inputs through the reference's tiered_scan and the port's:
    loss and gradients at the reference's tolerance."""
    remat, policy = REMAT_MODES[mode]
    x0n, stn = _setup_np(L)

    def jlayer(c, p):
        return jnp.tanh(c @ p["w"] + p["b"])

    def jloss(x0, st):
        c = ref_tiering.tiered_scan(
            jlayer, x0, st, n_layers=L, remat=remat, min_layers=4,
            policy=(None if not remat
                    else jax.checkpoint_policies.nothing_saveable))
        return (c ** 2).sum()

    l_ref, (gx, gst) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x0n), {k: jnp.asarray(v) for k, v in stn.items()})
    x0, stacked = _setup(L)
    l_got, g_got = _value_and_grads(
        lambda x, s: (tiered_scan(_layer, x, s, n_layers=L, remat=remat,
                                  policy=policy, min_layers=4) ** 2).sum(),
        x0, stacked)
    np.testing.assert_allclose(l_got, np.asarray(l_ref), rtol=1e-6)
    for a, b in zip(g_got, (gx, gst["b"], gst["w"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


class _TrackingEngine(HostFetchEngine):
    """The CPU engine, keeping a weak reference to every tensor it hands
    out."""

    def __init__(self):
        super().__init__(throttle=0.0, device="cpu")
        self.handed: list[weakref.ref] = []

    def acquire(self, fut):
        out = super().acquire(fut)
        self.handed += [weakref.ref(t) for t in out.values()]
        return out


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("mode", ["none", "full"])
@pytest.mark.parametrize("L", [5, 16])
def test_remote_leaves_give_local_grads(L, mode, prefetch):
    """REMOTE stacked leaves fetched through the engine and attached to
    RemoteGrads: the loss and every gradient torch.equal to the all-local
    scan's, and (under remat) no fetched tensor alive after the forward."""
    remat, policy = REMAT_MODES[mode]
    x0, stacked = _setup(L)
    l_ref, g_ref = _value_and_grads(
        lambda x, s: (tiered_scan(_layer, x, s, n_layers=L, remat=remat,
                                  policy=policy, prefetch=prefetch,
                                  min_layers=4) ** 2).sum(), x0, stacked)
    host = {"w": stacked["w"].detach().clone(), "b": stacked["b"]}
    engine = _TrackingEngine()
    grads = RemoteGrads("cpu")
    out = tiered_scan(_layer, x0, host, n_layers=L, remat=remat,
                      policy=policy, prefetch=prefetch, min_layers=4,
                      remote=frozenset({"['w']"}), engine=engine, grads=grads,
                      prefix="params")
    alive = sum(r() is not None for r in engine.handed)
    loss = (out ** 2).sum()
    gx, gb, _ = torch.autograd.grad(loss, [x0, host["b"], grads.anchor])
    engine.close()
    assert torch.equal(loss.detach(), l_ref)
    assert torch.equal(gx, g_ref[0]) and torch.equal(gb, g_ref[1])
    assert torch.equal(grads.grads["params['w']"], g_ref[2])
    # remat="none" saves every fetched weight for the backward; under
    # remat the fetches are recomputed, none saved across the forward
    assert alive == (L if mode == "none" else 0)


def _ref_pair(n_layers=4):
    ref_cfg = ref_reduced_config(ref_get_config("granite-8b"),
                                 dtype=jnp.float32, n_layers=n_layers,
                                 vocab_size=64)
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32,
                         n_layers=n_layers, vocab_size=64)
    return ref_cfg, cfg, ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)


@pytest.mark.parametrize("fraction", [0.5, 0.25])
def test_plan_with_opt_state_equals_reference(fraction):
    """Parameters and moments in one plan: names, kinds and tiers equal to
    the reference's plan on the same tree."""
    ref_cfg, _cfg, ref_params = _ref_pair()
    ref_opt = ref_optim.init(ref_optim.AdamWConfig(), ref_params)
    ref_plan = ref_tiering.plan_for_params(
        ref_params, config=ref_tiering.TieringConfig(
            mode="host_offload", local_fraction=fraction),
        opt_state=ref_opt)
    params = params_from_reference(ref_params, device="cpu")
    opt = adamw_init(AdamWConfig(), params)
    plan = plan_for_params(params, config=TieringConfig(
        mode="host_offload", local_fraction=fraction), opt_state=opt)
    assert sorted(plan.remote_names()) == sorted(ref_plan.remote_names())
    assert any(n.startswith("opt['m']") for n in plan.remote_names())
    assert plan.tier_of("opt['step']") is Tier.LOCAL


def test_model_grads_under_every_remat_policy():
    """End-to-end: gradients of the port's loss under every policy, finite
    and (recompute being exact in torch) equal to remat='none'."""
    _ref_cfg, cfg, _ = _ref_pair()
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(gen, cfg, device="cpu")
    batch = make_batch(cfg, torch.Generator().manual_seed(1), 2, 16,
                       device="cpu")
    leaves = [t.requires_grad_(True) for t in _flat(params)]
    out = {}
    for remat in ("none", "full", "full_flat", "dots", "dots_no_batch"):
        loss, _ = tf.loss_fn(params, batch, cfg, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
        assert bool(torch.isfinite(loss))
    for remat, (loss, grads) in out.items():
        assert torch.equal(loss, out["none"][0]), remat
        for a, b in zip(grads, out["none"][1]):
            assert torch.equal(a, b), remat


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def test_policies_are_context_fns():
    assert tf.REMAT_POLICIES["none"] is None
    assert set(tf.REMAT_POLICIES) == set(ref_tf.REMAT_POLICIES)
    for name in ("dots", "dots_no_batch"):
        assert isinstance(tf.REMAT_POLICIES[name], functools.partial)
