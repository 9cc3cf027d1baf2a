"""The port's sharding layer on a real mesh: one world of four ``gloo``
ranks on the CPU (``_torch_dist.World``), meshes (2, 2), (1, 4) and (4, 1)
over ``data`` and ``model``, and the ranks' side in
``_torch_mesh_cases.py``.

* The sharded train step of reduced granite-8b, mamba2-130m and
  deepseek-v3-671b (expert-parallel: 4 experts on ``model`` = 2 and 4) in
  float32 against the unsharded one: the loss within 1e-6 relative, every
  gradient within 1e-5 of its leaf's max |g|, the moments after the update
  (given the same gradients) within 1e-5 of their leaf's max, and the
  parameters within that of the update plus two of their own ulps. The
  unsharded step is held to the reference's as ``_torch_train_parity``
  holds it. The reference's own sharded case fails (ROADMAP C1), so the
  unsharded step is the oracle. deepseek-v3 also runs with 2 microbatches
  (each of contiguous global rows).
* ``fsdp_stream`` with prefetch on and off, ``torch.equal``, both held to
  the mesh untiered step (the loss, every gradient, and the update given
  its gradients, at the tolerances above) on its broadcast branch (2, 2),
  its all-gather branch (4, 1) and over ``model`` (``fsdp_axis``); a
  planted fault in its backward that must fail; and ``host_offload``
  under the mesh ``torch.equal`` to the mesh untiered.
* ``_moe_ffn_ep`` forward and gradients against the dense path, and a
  planted fault (the all-reduce of x's gradient left out) that must fail.
* The reference's EP cases of ``tests/test_expert_paging.py`` (bit for
  bit, on (4, 1): a ``model`` axis of one, the reference's (1, 1)) and
  both of ``tests/test_moe_ep.py``.
* Int8 moments and gradient compression under the mesh: two steps given
  the same gradients on (2, 2), (4, 1) and (1, 4) (where the ``model``
  split cuts a quantization block of ``w_up``) against the unsharded
  steps: parameters within the update's tolerance above, int8 codes
  within 1, scales, float32 moments and the error-feedback buffer within
  1e-5 of their leaf's max.
* Decode under the mesh (granite-8b, its KV cache's length split over
  ``model``: the slot written on its owner's shard, the softmax reduced
  over the ranks; mamba2-130m's state update on local shards;
  deepseek-v3's latent cache): 4 steps' logits within 1e-5 of their max
  and the caches within 1e-5 of the unsharded decode's.
* The dry-run's memory tracker on a mesh: rank 0's train step traced on
  fake tensors over a fake process group of 4 (the dry-run's
  ``laid_out`` state) has the tracker's memory dict of rank 0's real step
  on (2, 2) and (4, 1), peak included, ``==``.
* A checkpoint saved on (2, 2) restored on (1, 4) ``==``;
  ``device_put_fn``; the launcher with ``--mesh 2,2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import moe as REF_MOE

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.tiering import TieringConfig
from repro_torch.models import get_model
from repro_torch.models import moe as MOE

import _torch_mesh_cases as C
from _torch_dist import World, fake_group
from _torch_train_parity import Ref, check_f32


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


_REFS: dict = {}


def ref_of(arch: str) -> Ref:
    """The reduced architecture with a batch of 4 (every data split
    divides it), the reference's parameters carried over."""
    if arch not in _REFS:
        _REFS[arch] = Ref(arch, batch=4, seq=16)
    return _REFS[arch]


def _close(got: np.ndarray, want: np.ndarray, scale_of: np.ndarray,
           rel: float, slack: np.ndarray | float = 0.0) -> bool:
    scale = max(float(np.abs(scale_of).max()), 1e-30)
    return bool(np.all(np.abs(got - want) <= rel * scale + slack))


STEP_CASES = [("granite-8b", (2, 2), 1), ("granite-8b", (1, 4), 1),
              ("granite-8b", (4, 1), 1), ("mamba2-130m", (2, 2), 1),
              ("mamba2-130m", (1, 4), 1), ("mamba2-130m", (4, 1), 1),
              ("deepseek-v3-671b", (2, 2), 1),
              ("deepseek-v3-671b", (1, 4), 1),
              ("deepseek-v3-671b", (2, 2), 2)]


def _step_id(arch, shape, mb) -> str:
    return f"{arch}-{shape[0]}x{shape[1]}" + (f"-mb{mb}" if mb > 1 else "")


@pytest.mark.parametrize("arch,shape,mb", STEP_CASES,
                         ids=[_step_id(*c) for c in STEP_CASES])
def test_sharded_step_matches_unsharded(world, arch, shape, mb):
    """With ``mb`` microbatches (2: each of contiguous global rows, so the
    MoE's balance term, a product of per-microbatch means, is the
    unsharded step's). The unsharded microbatched step is held to the
    reference's in ``test_torch_train_step.py``."""
    ref = ref_of(arch)
    out = world.run(C.step_case, ref.cfg, ref.params(), ref.batch, shape,
                    mb)[0]
    if mb == 1:  # the oracle: the port's unsharded step, held to the
        check_f32(ref, out["loss0"], out["metrics0"], out["grads0"])
    assert abs(out["loss"] - out["loss0"]) <= 1e-6 * abs(out["loss0"])
    for k, v in out["metrics0"].items():
        assert abs(out["metrics"][k] - v) <= 1e-6 * max(abs(v), 1e-6), k
    assert set(out["grads"]) == set(out["grads0"])
    for k, g0 in out["grads0"].items():
        assert _close(out["grads"][k], g0, g0, 1e-5), k
    held_update(out["old"], {"params": out["new"], "m": out["m"],
                             "v": out["v"]},
                {"params": out["new0"], "m": out["m0"], "v": out["v0"]})
    calls = out["calls"]
    if arch == "mamba2-130m":
        assert calls["ssd"] == 2 * ref.cfg.n_layers  # forward + recompute
    else:
        assert calls["flash"] > 0
    if arch == "deepseek-v3-671b":
        assert calls["moe_ep"] == 2 * mb * (ref.cfg.n_layers
                                            - ref.cfg.first_k_dense)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_vocab_parallel_loss_matches_unsharded(world, shape):
    """C8: the loss of logits split by vocabulary (on ``model``) and by
    rows (on ``data``) reduces each rank's slice: its value within 1e-6
    relative and its gradient within 1e-6 of the leaf's max of the
    unsharded loss's (float32; the sums run in another order). Rank 0's
    slice and its gradient stay a ``model``-th of the vocabulary. The
    labels fall in every slice, the padded columns' NEG_INF included."""
    from repro_torch.kernels.ref import NEG_INF

    rng = np.random.default_rng(0)
    B, S, V = 4, 8, 64
    logit = torch.from_numpy(rng.normal(size=(B, S, V)).astype(np.float32))
    logit[..., 60:] = NEG_INF  # a padded vocabulary's tail
    labels = torch.from_numpy(rng.integers(0, 60, (B, S)).astype(np.int32))
    out = world.run(C.xent_case, logit, labels, shape)[0]
    assert abs(out["loss"] - out["loss0"]) <= 1e-6 * abs(out["loss0"])
    assert _close(out["g"], out["g0"], out["g0"], 1e-6)
    assert out["width"] == out["grad_width"] == V // shape[1]
    assert out["calls"] == 1


def test_mtp_loss_is_vocab_parallel(world):
    """C8 in reduced deepseek-v3's loss on (1, 4), the vocabulary split 4
    ways: the main head's loss and the MTP term each go through the
    vocabulary-parallel loss, and the loss, both terms and every gradient
    match the unsharded step's (1e-6 relative; gradients 1e-5 of their
    leaf's max |g|, as the sharded step's test holds them)."""
    ref = ref_of("deepseek-v3-671b")
    out = world.run(C.loss_case, ref.cfg, ref.params(), ref.batch,
                    (1, 4))[0]
    assert out["calls"] == 2
    assert abs(out["loss"] - out["loss0"]) <= 1e-6 * abs(out["loss0"])
    assert set(out["metrics0"]) >= {"nll", "mtp_nll"}
    for k, v in out["metrics0"].items():
        assert abs(out["metrics"][k] - v) <= 1e-6 * max(abs(v), 1e-6), k
    assert grads_off(out["grads"], out["grads0"]) == []


def held_update(old: dict, got: dict, want: dict) -> None:
    """An update (``params``, moments ``m`` and ``v``) given the oracle's
    gradients against the oracle's: parameters within 1e-5 of the update
    plus two of their own ulps, moments within 1e-5 of their leaf's max."""
    for k, o in old.items():
        upd = want["params"][k] - o
        assert _close(got["params"][k], want["params"][k], upd, 1e-5,
                      2 * np.spacing(np.abs(o))), k
        for mom in ("m", "v"):
            w = want[mom][k]
            assert _close(got[mom][k], w, w, 1e-5), (mom, k)


def grads_off(got: dict, want: dict) -> list[str]:
    """The gradients of ``got`` not within 1e-5 of their leaf's max |g|
    in ``want``."""
    assert got.keys() == want.keys()
    return [k for k, g in want.items() if not _close(got[k], g, g, 1e-5)]


def _fsdp(**kw) -> TieringConfig:
    return TieringConfig(mode="fsdp_stream", local_fraction=0.0, **kw)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_fsdp_stream_and_offload_under_a_mesh(world, shape):
    """fsdp_stream at local fraction 0 (every leaf REMOTE: split over
    ``data``, the layer dim where 2 layers divide it, gathered by
    broadcasts; a weight dim on (4, 1), gathered by all-gathers) with
    prefetch on and off: ``torch.equal``, and held to the mesh untiered
    step (the oracle) at the sharded step's tolerances: the loss, every
    gradient, and the update given the oracle's gradients. host_offload at 0.5 (each rank's
    local shards in host memory) ``torch.equal`` to the mesh untiered, as
    every placement is without a mesh."""
    ref = ref_of("granite-8b")
    tierings = {
        "untiered": TieringConfig(mode="none"),
        "fsdp": _fsdp(),
        "fsdp_no_prefetch": _fsdp(prefetch=False),
        "offload": TieringConfig(mode="host_offload", local_fraction=0.5),
        "offload_no_prefetch": TieringConfig(
            mode="host_offload", local_fraction=0.5, prefetch=False),
    }
    out = world.run(C.placed_step_case, ref.cfg, ref.params(), ref.batch,
                    shape, tierings, "untiered")[0]

    equal(out["fsdp"], out["fsdp_no_prefetch"])
    equal(out["offload"], out["untiered"])
    equal(out["offload_no_prefetch"], out["untiered"])
    assert out["offload"]["n_remote"] > 0
    split = out["fsdp"]["split"]
    assert "['layers']['attn']['wq']" in split
    assert "['layers']['mlp']['w_up']" in split
    kind = "broadcast" if shape == (2, 2) else "all_gather"
    oracle = out["untiered"]
    for leg in (k for k in tierings if k.startswith("fsdp")):
        got = out[leg]
        assert got["split"] and got["gathers"].get(kind, 0) > 0, leg
        assert abs(got["loss"] - oracle["loss"]) <= 1e-6 * abs(
            oracle["loss"]), leg
        assert grads_off(got["grads"], oracle["grads"]) == [], leg
        held_update(out["old"], got["given"], oracle)


def test_fsdp_stream_over_the_model_axis(world):
    """``TieringConfig.fsdp_axis`` reaches the layer loop: deepseek-v3 on
    (2, 2) at fsdp_axis "model" splits the REMOTE leaves the rules leave
    whole on ``model`` (MLA's low-rank projections, the shared expert),
    and ``tiered_scan`` gathers them over ``model``. Prefetch on and off
    ``torch.equal``, both held to the mesh untiered step as above."""
    ref = ref_of("deepseek-v3-671b")
    tierings = {"untiered": TieringConfig(mode="none"),
                "fsdp_model": _fsdp(fsdp_axis="model"),
                "fsdp_model_no_prefetch": _fsdp(fsdp_axis="model",
                                                prefetch=False)}
    out = world.run(C.placed_step_case, ref.cfg, ref.params(), ref.batch,
                    (2, 2), tierings, "untiered")[0]
    equal(out["fsdp_model"], out["fsdp_model_no_prefetch"])
    oracle = out["untiered"]
    for leg in ("fsdp_model", "fsdp_model_no_prefetch"):
        got = out[leg]
        assert "['layers']['attn']['wq_a']" in got["split"], leg
        assert sum(got["gathers"].values()) > 0, leg
        assert abs(got["loss"] - oracle["loss"]) <= 1e-6 * abs(
            oracle["loss"]), leg
        assert grads_off(got["grads"], oracle["grads"]) == [], leg
        held_update(out["old"], got["given"], oracle)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_fsdp_stream_backward_fault_is_caught(world, shape):
    """The planted fault in fsdp_stream's backward (a broadcast layer's
    gradient put on the ranks that do not own it on (2, 2); an
    all-gathered layer's part taken one shard over on (4, 1)): the
    forward is untouched, and the gradient check above must fail."""
    ref = ref_of("granite-8b")
    tierings = {"untiered": TieringConfig(mode="none"), "fsdp": _fsdp()}
    out = world.run(C.placed_step_case, ref.cfg, ref.params(), ref.batch,
                    shape, tierings, None, True)[0]
    got, oracle = out["fsdp"], out["untiered"]
    assert abs(got["loss"] - oracle["loss"]) <= 1e-6 * abs(oracle["loss"])
    off = grads_off(got["grads"], oracle["grads"])
    assert off and all(k.startswith("['layers']") for k in off)


def equal(a: dict, b: dict) -> None:
    """Two placed steps' loss, gradients, parameters and moments, bit for
    bit."""
    assert a["loss"] == b["loss"]
    for part in ("grads", "params", "m", "v"):
        assert a[part].keys() == b[part].keys()
        for k, t in a[part].items():
            assert np.array_equal(t, b[part][k]), (part, k)


def test_one_rank_mesh_is_bit_equal_to_no_mesh(tmp_path):
    """What chip_smoke.py's [mesh] phase holds on the card, here on a (1,
    1) mesh of this process: on one rank every redistribute is the
    identity and the local ops are the unsharded ones, so the mesh step
    (DEFAULT_RULES), fsdp_stream (prefetch on and off) and host_offload
    under the mesh are ``torch.equal`` to the step without a mesh."""
    from _torch_dist import one_rank_group

    ref = ref_of("granite-8b")
    legs = {
        "no mesh": TieringConfig(mode="none"),
        "mesh": TieringConfig(mode="none"),
        "fsdp 0.5": TieringConfig(mode="fsdp_stream", local_fraction=0.5),
        "fsdp 0.5 prefetch off": TieringConfig(
            mode="fsdp_stream", local_fraction=0.5, prefetch=False),
        "offload 0.5": TieringConfig(mode="host_offload",
                                     local_fraction=0.5),
    }
    with one_rank_group(str(tmp_path)):
        out = C.placed_step_case(ref.cfg, ref.params(), ref.batch, (1, 1),
                                 legs)
    # fsdp_stream's REMOTE leaves stay whole on a data axis of one: no
    # gather is posted, and its legs are the plain mesh step
    for leg in ("fsdp 0.5", "fsdp 0.5 prefetch off"):
        assert out[leg]["n_remote"] and not out[leg]["split"], leg
        assert not out[leg]["gathers"], leg
    assert out["offload 0.5"]["n_remote"]
    for name in legs:
        equal(out[name], out["no mesh"])


def _moe_inputs(arch, seed=0, shape=(4, 16), **overrides):
    """The reference's MoE parameters and input (its tests' draws) as
    torch tensors, and the port's config."""
    rcfg = ref_reduced_config(ref_get_config(arch), dtype=jnp.float32,
                              **overrides)
    cfg = reduced_config(get_config(arch), dtype=torch.float32, **overrides)
    p = REF_MOE.moe_init(jax.random.PRNGKey(seed), rcfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1),
                          (*shape, rcfg.d_model), jnp.float32)
    return cfg, _torch(p), torch.from_numpy(np.array(x))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_ep_matches_dense_fwd_and_grads(world, shape):
    """tests/test_moe_ep.py's case (its (2, 4) mesh becomes the world's
    (2, 2) and (1, 4)), at its tolerances."""
    cfg, p, x = _moe_inputs("deepseek-v3-671b", capacity_factor=8.0)
    out = world.run(C.ep_case, cfg, p, x, shape)[0]
    (d_out, d_aux, d_g), (e_out, e_aux, e_g) = out["dense"], out["ep"]
    np.testing.assert_allclose(e_out, d_out, atol=1e-4, rtol=1e-4)
    assert e_aux == pytest.approx(d_aux, rel=1e-5)
    scale = max(float(np.abs(g).max()) for g in d_g.values())
    for k, g in d_g.items():
        np.testing.assert_allclose(e_g[k], g, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_ep_without_the_dx_all_reduce_is_caught(world, shape):
    """The planted fault: x enters every expert shard whole but feeds only
    that shard's experts, so each shard's dx is a share; leaving out their
    all-reduce must break the gradient check above (and nothing else)."""
    cfg, p, x = _moe_inputs("deepseek-v3-671b", capacity_factor=8.0)
    out = world.run(C.ep_case, cfg, p, x, shape, True)[0]
    (d_out, _, d_g), (e_out, _, e_g) = out["dense"], out["ep"]
    np.testing.assert_allclose(e_out, d_out, atol=1e-4, rtol=1e-4)
    scale = max(float(np.abs(g).max()) for g in d_g.values())
    assert not np.allclose(e_g["x"], d_g["x"], atol=1e-4 * scale, rtol=1e-3)


def test_ep_path_gated_off_without_mesh():
    """No mesh: moe_ffn takes the dense path (tests/test_moe_ep.py)."""
    cfg, p, x = _moe_inputs("deepseek-v3-671b", shape=(2, 8))
    out, aux = MOE.moe_ffn(p, x, cfg)
    dense, dense_aux = MOE._moe_ffn_dense(p, x, cfg)
    assert out.shape == x.shape
    assert torch.equal(out, dense) and torch.equal(aux, dense_aux)


# -- the EP cases of tests/test_expert_paging.py ------------------------------

EP11 = (4, 1)  # a model axis of one: the reference's (1, 1) mesh


@pytest.mark.parametrize("groups", [None, 1, 2, 4, 8])
def test_ep_threads_groups(world, groups):
    cfg, p, x = _moe_inputs("mixtral-8x7b", shape=(2, 8),
                            capacity_factor=8.0)
    (dense, aux_d), (ep, aux_e) = world.run(
        C.ep_paging_case, cfg, p, x, EP11, "groups", groups)[0]
    np.testing.assert_array_equal(dense, ep)
    np.testing.assert_allclose(aux_d, aux_e, rtol=1e-6)


def test_ep_rejects_bad_groups(world):
    cfg, p, _ = _moe_inputs("mixtral-8x7b", shape=(2, 8))
    x = torch.zeros((2, 8, cfg.d_model))
    msgs = world.run(C.ep_paging_case, cfg, p, x, EP11, "bad_groups",
                     [5, 0])[0]
    assert all(m is not None and "partition" in m for m in msgs)


@pytest.mark.parametrize("seed", range(4))
def test_dense_vs_ep_property(world, seed):
    cfg, p, x = _moe_inputs("deepseek-v3-671b", seed=seed, shape=(2, 12),
                            capacity_factor=1.0)
    (dense, _), (ep, _) = world.run(C.ep_paging_case, cfg, p, x, EP11,
                                    "groups", 2)[0]
    np.testing.assert_array_equal(dense, ep)


def test_zero_rows_are_exact(world):
    """[ep]: zeroing every expert the router did not pick leaves the EP
    output bit-identical ([dense] runs in test_torch_moe.py)."""
    cfg, p, x = _moe_inputs("mixtral-8x7b", shape=(2, 6))
    ref, out = world.run(C.ep_paging_case, cfg, p, x, EP11, "zero_rows")[0]
    np.testing.assert_array_equal(ref, out)


# -- checkpoint, data, launcher -----------------------------------------------

def test_checkpoint_restores_onto_another_mesh(world, tmp_path):
    """Saved on (2, 2), restored onto (1, 4)'s placements: every leaf ==
    (the reference's test_elastic_restore_onto_shardings on a real
    mesh)."""
    ref = ref_of("granite-8b")
    out = world.run(C.checkpoint_case, ref.cfg, ref.params(),
                    str(tmp_path))[0]
    before, after = out["before"], out["after"]
    assert after["step"] == 3
    for part in ("params", "opt"):
        assert set(after[part]) == set(before[part])
        for k, t in before[part].items():
            assert np.array_equal(after[part][k], t), (part, k)
    assert after["wq_mesh"] == (1, 4)
    assert after["wq"] == [None, 2]  # (layers, d, heads): heads on model


def test_device_put_fn_lands_batches_sharded(world):
    cfg = reduced_config(get_config("internvl2-1b"))
    out = world.run(C.put_case, cfg, (2, 2))[0]
    assert set(out) == {"tokens", "labels", "patches"}
    for k, (placements, got, want) in out.items():
        assert placements == [0, None], k  # the batch on data
        np.testing.assert_array_equal(got, want)


def test_launcher_trains_on_a_mesh(world):
    losses = world.run(C.launcher_case, [
        "--arch", "granite-8b", "--mesh", "2,2", "--device", "cpu",
        "--steps", "4", "--batch", "4", "--seq", "32", "--lr", "3e-3"])[0]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


# -- int8 moments and gradient compression under the mesh ---------------------

def _int8_inputs():
    """Reduced granite-8b (float32) wide enough that its MLP weights and
    the embedding are int8 moments (1 MiB and more, last dim a multiple of
    256), its parameters, a batch and fixed gradients, all drawn from
    seed 0."""
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32,
                         d_model=256, d_ff=512, vocab_size=1024)
    gen = torch.Generator().manual_seed(0)
    params = get_model(cfg).init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                           dtype=torch.int32)
    grads = {k: torch.randn(t.shape, generator=gen) * 1e-2
             for k, t in _leaves_with_keys(params)}
    return cfg, params, {"tokens": tokens, "labels": tokens}, grads


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_int8_moments_and_compression_under_a_mesh(world, shape):
    cfg, params, batch, grads = _int8_inputs()
    out = world.run(C.moments_case, cfg, params, batch, shape, grads)[0]
    assert "['layers']['mlp']['w_up']" in out["quantized"]
    assert "['embed']['embedding']" in out["quantized"]
    w_up = out["split"]["['layers']['mlp']['w_up']"]
    assert w_up == ([] if shape == (4, 1) else [1])  # 512 over model
    old = {k: t.numpy() for k, t in _leaves_with_keys(params)}
    for step, (got, want) in enumerate(zip(out["got"], out["want"])):
        for k, o in old.items():  # held_update's bound on the parameters
            w = want["params"][k]
            assert _close(got["params"][k], w, w - o, 1e-5,
                          2 * np.spacing(np.abs(o))), (step, k)
        for part in ("m", "v", "ef"):
            assert got[part].keys() == want[part].keys()
            for k, w in want[part].items():
                if k.endswith(".codes"):
                    assert np.abs(got[part][k] - w).max() <= 1, (step, k)
                else:
                    assert _close(got[part][k], w, w, 1e-5), (step, part, k)
        old = want["params"]


# -- the dry-run's predicted peak against a real mesh step --------------------

@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_traced_peak_equals_the_real_mesh_step(world, shape, monkeypatch):
    """Reduced granite-8b (float32): what ``launch.dryrun`` predicts for
    rank 0 (the step traced over a fake group of 4 on its laid-out fake
    state) is what the same tracker counts over rank 0's real step."""
    import repro_torch.core.exec as ex
    import repro_torch.models.flash as mflash
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import streaming_matmul as sm
    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models import sharding as shd
    from repro_torch.optim import init as adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = get_model(cfg).init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    real = world.run(C.memory_case, cfg, params, batch, shape)[0]

    # the kernels' CPU routes on fake tensors too, as the ranks ran them
    for mod in (sm, fa, ssd, mflash, ex):
        monkeypatch.setattr(mod, "is_traced", lambda *_t: False)
    tr = H.Tracer()
    params, batch = torch.utils._pytree.tree_map_only(
        torch.Tensor, tr.from_tensor, (params, batch))
    with tr:
        opt = adamw_init(C.OPT, params)
    with fake_group(4):
        mesh = C.mesh_of(shape)
        with shd.use_mesh(mesh):
            specs = shd.params_pspec_tree(
                params, expert_sharding=cfg.expert_sharding, mesh=mesh)
            args = (dryrun.laid_out(params, specs, mesh, tr),
                    dryrun.laid_out(opt, shd.opt_pspec_tree(opt, specs, mesh),
                                    mesh, tr),
                    dryrun.laid_out(batch, shd.batch_pspec_tree(batch, mesh),
                                    mesh, tr))
            step = make_train_step(cfg, TrainStepConfig(remat="full"), C.OPT)
            traced = H.analyze(step, *args).memory
    assert traced == real
    assert real["temp_bytes"] > 0 and real["peak_bytes_est"] > (
        real["argument_bytes"] + real["output_bytes"])


# -- decode under the mesh ----------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m",
                                  "deepseek-v3-671b"])
def test_decode_under_a_mesh_matches_unsharded(world, arch):
    cfg = reduced_config(get_config(arch), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = get_model(cfg).init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 4), generator=gen,
                           dtype=torch.int32)
    out = world.run(C.decode_case, cfg, params, tokens, (2, 2),
                    2 if cfg.is_moe else None)[0]
    (want_logits, want_cache), (got_logits, got_cache) = (out["want"],
                                                          out["got"])
    for w, g in zip(want_logits, got_logits):
        assert _close(g, w, w, 1e-5)
    assert got_cache.keys() == want_cache.keys()
    for k, w in want_cache.items():
        assert _close(got_cache[k], w, w, 1e-5), k
    if arch == "granite-8b":  # the cache's length split over model
        assert out["split"]["['k']"][1] == 2
