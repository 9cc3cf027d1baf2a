"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
dense dispatch (``repro.models.moe._moe_ffn_dense``), on the CPU.

Reduced mixtral-8x7b (4 experts, top-2) and deepseek-v3 (32 experts,
top-8, one shared expert), the reference's parameters carried over by
``convert.params_from_reference`` and the same numpy inputs for both:

* float32: ``top_i`` equal; ``top_p``, the output and the aux loss within
  ``F32_TOL`` (the router's softmax and the experts' sums run in each
  library's own order, a few float32 units apart);
* bf16: the output bit-equal (``np.array_equal``). The reference rounds
  at every operation (the expert products once each, its silu as
  ``1 / (1 + exp(-x))`` op by op, each of a token's k weighted adds in
  the order of the slots sorted by expert); the port rounds at the same
  points, so at k = 8 a combine in any other order would show;
* every dispatch grouping, with and without ``return_routing``, and a
  capacity factor small enough that slots drop;
* the reference's ``test_zero_rows_are_exact[dense]`` against the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import moe as ref_moe

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import moe as MOE

from _torch_model_parity import one_torch_thread  # noqa: F401 (autouse)

# float32 bound on top_p, the output and the aux loss (absolute and
# relative): the two libraries' softmax and sums differ by float32 units
F32_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# reduced configs: deepseek-v3 at 32 experts top-8 so that the combine adds
# eight slots a token
ARCHS = {"mixtral-8x7b": {}, "deepseek-v3-671b": dict(n_experts=32, top_k=8)}
GROUPS = [None, 1, 2, 4, 8]


def _as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(arch: str, dtype: str, seed: int = 0, **overrides):
    jdt, tdt = DTYPES[dtype]
    kw = {**ARCHS[arch], **overrides}
    ref_cfg = ref_reduced_config(ref_get_config(arch), dtype=jdt, **kw)
    cfg = reduced_config(get_config(arch), dtype=tdt, **kw)
    ref_p = ref_moe.moe_init(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, ref_p, params_from_reference(ref_p, device="cpu")


def _x(cfg, dtype: str, shape=(2, 8), seed: int = 1):
    a = np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


@pytest.fixture(scope="module")
def pairs():
    return {(arch, dt, cf): _pair(arch, dt, **({"capacity_factor": cf}
                                               if cf else {}))
            for arch in ARCHS for dt in DTYPES for cf in (None, 0.5)}


@pytest.mark.parametrize("routing", [False, True])
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cf", [None, 0.5], ids=["cf-default", "cf-0.5"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_ffn_float32(pairs, arch, cf, groups, routing):
    ref_cfg, cfg, ref_p, p = pairs[(arch, "float32", cf)]
    jx, tx = _x(cfg, "float32")
    want = ref_moe._moe_ffn_dense(ref_p, jx, ref_cfg, groups=groups,
                                  return_routing=True)
    got = MOE.moe_ffn(p, tx, cfg, groups=groups, return_routing=routing)
    assert len(got) == (3 if routing else 2)
    np.testing.assert_allclose(_as_np(got[0]), _as_np(want[0]),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=F32_TOL,
                               rtol=F32_TOL)
    if routing:
        top_i, top_p = got[2]
        assert top_i.dtype == torch.int32
        np.testing.assert_array_equal(top_i.numpy(), np.asarray(want[2][0]))
        np.testing.assert_allclose(top_p.numpy(), np.asarray(want[2][1]),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("cf", [None, 0.5], ids=["cf-default", "cf-0.5"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_ffn_bf16_bit_equal(pairs, arch, cf, groups):
    ref_cfg, cfg, ref_p, p = pairs[(arch, "bfloat16", cf)]
    jx, tx = _x(cfg, "bfloat16")
    want, want_aux, (want_i, _) = ref_moe._moe_ffn_dense(
        ref_p, jx, ref_cfg, groups=groups, return_routing=True)
    got, aux, (top_i, _) = MOE.moe_ffn(p, tx, cfg, groups=groups,
                                       return_routing=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(_as_np(got), _as_np(want))
    np.testing.assert_allclose(float(aux), float(want_aux), atol=F32_TOL,
                               rtol=F32_TOL)


def test_slots_drop_at_the_small_capacity(pairs):
    """At capacity factor 0.5 some slots find their expert full, so the
    cases above exercise the dropped-slot path (its zero adds into the
    expert's first slot)."""
    _, cfg, _, _ = pairs[("deepseek-v3-671b", "float32", 0.5)]
    _, tx = _x(cfg, "float32")
    _, _, (top_i, _) = MOE.moe_ffn(
        pairs[("deepseek-v3-671b", "float32", 0.5)][3], tx, cfg,
        return_routing=True)
    T, k = tx.shape[1], cfg.top_k
    cap = max(int(np.ceil(T * k / cfg.n_experts * 0.5)), 1)
    per_row = [np.bincount(r.reshape(-1), minlength=cfg.n_experts).max()
               for r in top_i.numpy()]
    assert max(per_row) > cap


def test_tie_takes_the_lower_expert():
    """``jax.lax.top_k`` breaks a tie toward the lower index, and so does
    the port (``torch.topk`` does not promise to)."""
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    vals, idx = MOE._top_k(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_groups_must_partition_the_tokens(pairs):
    _, cfg, _, p = pairs[("mixtral-8x7b", "float32", None)]
    _, tx = _x(cfg, "float32")
    for bad in (0, 5):
        with pytest.raises(ValueError, match="partition"):
            MOE.moe_ffn(p, tx, cfg, groups=bad)


@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", {}),                      # the reference's case
    ("deepseek-v3-671b", ARCHS["deepseek-v3-671b"]),  # experts left out
])
def test_zero_rows_are_exact(arch, kw):
    """The reference's ``test_zero_rows_are_exact[dense]`` against the
    port: zeroing every expert the router did not select leaves the MoE
    output bit-identical (capacity slots with no valid token carry
    exact-zero activations through silu and the products). At the
    reference's reduced mixtral every expert is routed; at 32 experts some
    are not, and their rows are zeroed."""
    cfg = reduced_config(get_config(arch), dtype=torch.float32, **kw)
    ref_cfg = ref_reduced_config(ref_get_config(arch), dtype=jnp.float32,
                                 **kw)
    p = params_from_reference(ref_moe.moe_init(jax.random.PRNGKey(0),
                                               ref_cfg), device="cpu")
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (2, 6, cfg.d_model), jnp.float32)))
    ref, _aux, (top_i, _top_p) = MOE._moe_ffn_dense(p, x, cfg,
                                                    return_routing=True)
    routed = set(np.unique(top_i.numpy()).tolist())
    assert len(routed) < cfg.n_experts or arch == "mixtral-8x7b"
    mask = torch.zeros((cfg.n_experts, 1, 1))
    for e in routed:
        mask[e] = 1.0
    p2 = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        p2[k] = p[k] * mask
    out, _ = MOE._moe_ffn_dense(p2, x, cfg)
    np.testing.assert_array_equal(ref.numpy(), out.numpy())


def test_moe_init_shapes_match_the_reference():
    """``moe_init``'s tree: the reference's keys, shapes and dtypes (the
    router float32, the experts in the model's type), stacked too."""
    for arch in ARCHS:
        ref_cfg, cfg, ref_p, _ = _pair(arch, "bfloat16")
        p = MOE.moe_init(torch.Generator(), cfg)
        flat = dict(jax.tree_util.tree_leaves_with_path(ref_p))
        want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in flat.items()}
        got = {}

        def walk(t, key=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{key}[{k!r}]")
            else:
                got[key] = (tuple(t.shape), str(t.dtype).split(".")[-1])

        walk(p)
        assert got == want
        stacked = MOE.moe_init(torch.Generator(), cfg, stack=3)
        assert stacked["w_gate"].shape == (3, *p["w_gate"].shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_is_jax_silus(dtype):
    """The experts' silu and its gradient against ``jax.grad`` of
    ``jax.nn.silu`` (the reference's), past exp(-x)'s overflow too: there
    autograd of ``x / (1 + exp(-x))`` op by op multiplies 0 by inf, and
    JAX's derivative of ``lax.logistic`` (``s (1 - s)``) stays finite.
    float32 within ``F32_TOL``, bf16 within two units of its last place."""
    jdt, tdt = DTYPES[dtype]
    x = np.array([-1000.0, -120.0, -89.5, -30.0, -2.5, -0.25, 0.0, 0.5, 3.0,
                  40.0, 95.0, 1000.0], np.float32)
    g = np.linspace(-2.0, 3.0, x.size).astype(np.float32)
    want_y, vjp = jax.vjp(jax.nn.silu, jnp.asarray(x, jdt))
    want_dx = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = MOE._silu(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(tdt))
    assert bool(torch.isfinite(dx).all())
    tol = F32_TOL if dtype == "float32" else 2.0 ** -6
    for got, want in ((y, np.asarray(want_y.astype(jnp.float32))),
                      (dx, want_dx)):
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=tol, atol=tol)
