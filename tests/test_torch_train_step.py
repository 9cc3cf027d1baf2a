"""The port's train step and loop on the CPU: one AdamW step (f32, bf16
and int8 moments), a microbatched step and the compression path against
the reference's ``make_train_step`` on the same inputs; every placement
and prefetch setting ``torch.equal``; the reference's cases of
``tests/test_train.py`` pointed at the port; the launcher."""
import jax
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.train import step as ref_step

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.tiering import TieringConfig, map_leaves, place_state
from repro_torch.optim import AdamWConfig, CompressionConfig
from repro_torch.optim import init as adamw_init
from repro_torch.optim.adamw import leaves as adamw_leaves
from repro_torch.optim.quantized import MIN_QUANT_BYTES, QTensor, dequantize
from repro_torch.train import step as step_mod
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import (
    TrainStepConfig,
    init_train_state,
    make_train_step,
    make_value_and_grad,
)

from _torch_model_parity import one_torch_thread  # noqa: F401
from _torch_train_parity import Ref, as_np

# -- the train step against the reference's -----------------------------------

def _ref_state(ref: Ref, opt_kw: dict, compression: bool = False):
    rcfg = ref_optim.AdamWConfig(**opt_kw)
    ref_opt = ref_optim.init(rcfg, ref.ref_params)
    cfg = AdamWConfig(**opt_kw)
    params = ref.params()
    opt = adamw_init(cfg, params)
    if compression:
        ref_opt["ef"] = ref_optim.init_error_feedback(ref.ref_params)
        opt["ef"] = {k: v for k, v in
                     _zeros_like_tree(params).items()}
    return rcfg, ref_opt, cfg, params, opt


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32)


def _check_step(ref_out, out) -> None:
    """Updated parameters and moments at the reference's own bound
    (``atol=2e-5, rtol=2e-4``, tests/test_train.py) and the metrics."""
    (rp, ro, rm), (p, o, m) = ref_out, out
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-4)
    got = dict(_leaves_with_keys(p))
    for k, want in _leaves_with_keys(rp):
        np.testing.assert_allclose(as_np(got[k]), as_np(want), atol=2e-5,
                                   rtol=2e-4, err_msg=k)
    for mom in ("m", "v"):
        got = {k: v for k, v in _leaves_with_keys_q(o[mom])}
        for k, want in _leaves_with_keys_q(ro[mom], ref=True):
            np.testing.assert_allclose(as_np(got[k]), as_np(want), atol=2e-5,
                                       rtol=2e-4, err_msg=f"{mom}{k}")


def _leaves_with_keys_q(tree, key="", ref=False):
    """Leaves of a moment tree, each dequantized to float32."""
    from repro.optim.quantized import QTensor as RefQ
    from repro.optim.quantized import dequantize as ref_deq

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys_q(tree[k], f"{key}[{k!r}]", ref)
    elif ref:
        yield key, ref_deq(tree) if isinstance(tree, RefQ) else tree
    else:
        yield key, dequantize(tree)


@pytest.fixture(scope="module")
def granite256():
    return Ref("granite-8b", n_layers=2, vocab_size=64, d_model=256,
               d_ff=1024)


@pytest.mark.parametrize("style", ["f32", "bf16", "int8"])
def test_train_step_matches_reference(granite256, style, monkeypatch):
    """One AdamW step through each package's make_train_step (d_model 256:
    the MLP leaves take the int8 moments), the port's step given the
    reference's loss and gradients.

    Why given: the first AdamW step maps each clipped gradient g to about
    g / (|g| + eps), which turns the packages' gradient difference (1e-4 of
    a leaf's max |g|, held by the tests above) into an update difference of
    up to lr x 1e-2 wherever the clipped |g| is near eps. End to end, one
    element of wk (of 32768) sits there and differs by 2.8e-5. The end-to-
    end step is held at the reference's bound on tests/test_train.py's
    tiny_cfg below (microbatched and compressed)."""
    ref = granite256
    kw = dict(lr=1e-3, warmup_steps=0, moment_style=style)
    rcfg, ref_opt, cfg, params, opt = _ref_state(ref, kw)
    ref_out = jax.jit(ref_step.make_train_step(
        ref.ref_cfg, ref_step.TrainStepConfig(), rcfg))(
        ref.ref_params, ref_opt, ref.ref_batch)
    ref_grads = {k: torch.from_numpy(g.copy()) for k, g in ref.grads.items()}
    monkeypatch.setattr(
        step_mod, "make_value_and_grad",
        lambda *a, **k: lambda p, b, engine=None: (
            torch.tensor(ref.loss), {}, dict(ref_grads)))
    out = step_mod.make_train_step(ref.cfg, TrainStepConfig(), cfg)(
        params, opt, ref.batch)
    _check_step(ref_out, out)
    if style == "int8":
        assert type(out[1]["m"]["layers"]["mlp"]["w_up"]).__name__ == "QTensor"


def _deepseek256() -> Ref:
    """Reduced deepseek-v3 (1 dense MLA layer, 1 MoE layer, the MTP block)
    at d_model 256 with a dense d_ff of 1024 and experts of 256: the dense
    MLP's and the experts' leaves take int8 moments."""
    return Ref("deepseek-v3-671b", n_layers=2, vocab_size=64, d_model=256,
               d_ff=1024, moe_d_ff=256)


def test_deepseek_int8_step_matches_reference(monkeypatch):
    """One int8 AdamW step of the moe family, the port's step given the
    reference's loss and gradients (as
    :func:`test_train_step_matches_reference`), against the reference's
    int8 step at its own bound; the expert leaves' moments are codes."""
    ref = _deepseek256()
    kw = dict(lr=1e-3, warmup_steps=0, moment_style="int8")
    rcfg, ref_opt, cfg, params, opt = _ref_state(ref, kw)
    ref_out = jax.jit(ref_step.make_train_step(
        ref.ref_cfg, ref_step.TrainStepConfig(), rcfg))(
        ref.ref_params, ref_opt, ref.ref_batch)
    ref_grads = {k: torch.from_numpy(g.copy()) for k, g in ref.grads.items()}
    monkeypatch.setattr(
        step_mod, "make_value_and_grad",
        lambda *a, **k: lambda p, b, engine=None: (
            torch.tensor(ref.loss), {}, dict(ref_grads)))
    out = step_mod.make_train_step(ref.cfg, TrainStepConfig(), cfg)(
        params, opt, ref.batch)
    _check_step(ref_out, out)
    for w in ("w_gate", "w_up", "w_down"):
        assert isinstance(out[1]["m"]["layers"]["moe"][w], QTensor)
    assert isinstance(out[1]["v"]["dense_layers"]["mlp"]["w_up"], QTensor)


def test_deepseek_int8_step_placements_are_bit_equal():
    """The moe family's int8 step untiered and at host_offload 0.0 (every
    code and expert weight REMOTE, beside every leaf but the small ones,
    fetched and written back through the update's store): loss,
    gradients, updated parameters and every code and scale torch.equal."""
    ref = _deepseek256()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, moment_style="int8")
    p0 = ref.params()
    o0 = adamw_init(opt_cfg, p0)
    out = {}
    for name in ("untiered", "host_offload_0.0"):
        tiering = PLACEMENTS[name]
        p, o, plan = place_state(_clone(p0), _clone(o0), tiering,
                                 device="cpu")
        if plan is not None:  # small leaves (scales, norms) stay LOCAL
            remote = set(plan.remote_names())
            assert all(n in remote for n in _state_by_name(p0, o0)
                       if n.endswith(".codes") or n.startswith(
                           "params['layers']['moe']['w_"))
        step_cfg = TrainStepConfig.from_tiering(tiering)
        loss, _, grads = make_value_and_grad(ref.cfg, step_cfg, plan=plan)(
            p, ref.batch)
        p1, o1, m = make_train_step(ref.cfg, step_cfg, opt_cfg, plan=plan)(
            p, o, ref.batch)
        out[name] = (loss, grads, _state_by_name(p1, o1), m["loss"])
    base = out["untiered"]
    assert sum(isinstance(t, QTensor) for mom in ("m", "v")
               for _, t in adamw_leaves(o1[mom])) >= 8
    loss, grads, state, step_loss = out["host_offload_0.0"]
    assert torch.equal(loss, base[0]) and torch.equal(step_loss, base[3])
    assert grads.keys() == base[1].keys() and state.keys() == base[2].keys()
    for k in grads:
        assert torch.equal(grads[k], base[1][k]), k
    for k in state:
        assert torch.equal(state[k], base[2][k]), k


def test_microbatched_step_matches_reference():
    """microbatches=4 against the reference's microbatched step, and
    against the port's full batch at the reference's bound."""
    ref = Ref("granite-8b", batch=8, n_layers=2, vocab_size=128)
    kw = dict(lr=1e-3, warmup_steps=0)
    rcfg, ref_opt, cfg, params, opt = _ref_state(ref, kw)
    ref_out = jax.jit(ref_step.make_train_step(
        ref.ref_cfg, ref_step.TrainStepConfig(microbatches=4), rcfg))(
        ref.ref_params, ref_opt, ref.ref_batch)
    mb = make_train_step(ref.cfg, TrainStepConfig(microbatches=4), cfg)(
        params, opt, ref.batch)
    _check_step(ref_out, mb)
    full = make_train_step(ref.cfg, TrainStepConfig(), cfg)(
        ref.params(), adamw_init(cfg, ref.params()), ref.batch)
    np.testing.assert_allclose(float(full[2]["loss"]), float(mb[2]["loss"]),
                               rtol=1e-4)
    got = dict(_leaves_with_keys(mb[0]))
    for k, t in _leaves_with_keys(full[0]):
        np.testing.assert_allclose(as_np(got[k]), as_np(t), atol=2e-5, rtol=2e-4)


def test_compression_step_matches_reference():
    ref = Ref("granite-8b", n_layers=2, vocab_size=64)
    kw = dict(lr=1e-3, warmup_steps=0)
    rcfg, ref_opt, cfg, params, opt = _ref_state(ref, kw, compression=True)
    on = CompressionConfig(enabled=True)
    ref_out = jax.jit(ref_step.make_train_step(
        ref.ref_cfg, ref_step.TrainStepConfig(
            compression=ref_optim.CompressionConfig(enabled=True)), rcfg))(
        ref.ref_params, ref_opt, ref.ref_batch)
    out = make_train_step(ref.cfg, TrainStepConfig(compression=on), cfg)(
        params, opt, ref.batch)
    _check_step(ref_out, out)
    got = dict(_leaves_with_keys(out[1]["ef"]))
    for k, want in _leaves_with_keys(ref_out[1]["ef"]):
        np.testing.assert_allclose(as_np(got[k]), as_np(want), atol=2e-5,
                                   rtol=2e-4, err_msg=k)


# -- placements and prefetch ---------------------------------------------------

PLACEMENTS = {
    "untiered": TieringConfig(),
    "prefetch_off": TieringConfig(prefetch=False),
    "host_offload_0.5": TieringConfig(mode="host_offload", local_fraction=0.5),
    "host_offload_0.0": TieringConfig(mode="host_offload", local_fraction=0.0),
    "host_offload_0.0_prefetch_off": TieringConfig(
        mode="host_offload", local_fraction=0.0, prefetch=False),
}


def _clone(tree):
    return map_leaves(lambda _k, t: t.clone(), tree)


@pytest.mark.parametrize("arch,n_layers", [
    pytest.param("granite-8b", 2, id="granite-8b"),
    pytest.param("deepseek-v3-671b", 2, id="deepseek-v3-671b"),
    pytest.param("mixtral-8x7b", 2, id="mixtral-8x7b"),
    pytest.param("granite-8b", 12, id="granite-8b-12-layers"),
    pytest.param("internvl2-1b", 2, id="internvl2-1b"),
    pytest.param("granite-34b", 2, id="granite-34b")])
def test_placements_and_prefetch_are_bit_equal(arch, n_layers):
    """Untiered, prefetch off and host_offload at 0.5 and 0.0 (params and
    moments in the plan; at 0.0 prefetch on and off): loss, every
    gradient, every updated parameter and moment torch.equal. At 12 layers
    remat "full" runs 3 blocks of 4 checkpointed layers, the dual buffer
    inside each block. internvl2-1b's batch carries its patches, which the
    step splits with their rows; granite-34b has one KV head."""
    cfg = reduced_config(get_config(arch), dtype=torch.float32,
                         n_layers=n_layers)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    p0, o0 = init_train_state(torch.Generator().manual_seed(0), cfg,
                              TrainStepConfig(), opt_cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(np.random.default_rng(3)
                                            .standard_normal(
            (4, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    out = {}
    for name, tiering in PLACEMENTS.items():
        p, o, plan = place_state(_clone(p0), _clone(o0), tiering,
                                 device="cpu")
        if tiering.mode == "host_offload":
            assert any(n.startswith("opt") for n in plan.remote_names())
        if tiering.local_fraction == 0.0:
            assert any(n.startswith("params['layers']")
                       for n in plan.remote_names())
        step_cfg = TrainStepConfig.from_tiering(tiering)
        loss, _, grads = make_value_and_grad(cfg, step_cfg, plan=plan)(
            p, batch)
        p1, o1, m = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)(
            p, o, batch)
        out[name] = (loss, grads, dict(_leaves_with_keys(p1)),
                     dict(_leaves_with_keys(o1)), m["loss"])
    base = out["untiered"]
    for name, (loss, grads, p1, o1, step_loss) in out.items():
        assert torch.equal(loss, base[0]) and torch.equal(step_loss, base[4])
        for i, tree in ((1, grads), (2, p1), (3, o1)):
            assert tree.keys() == base[i].keys()
            for k in tree:
                assert torch.equal(tree[k], base[i][k]), (name, k)


def _recording_leaf_update(monkeypatch) -> list:
    """``adamw.leaf_update`` as the step calls it, recording each call's
    parameter slice size and whether its moments came as int8 codes."""
    leaf_update = step_mod.adamw.leaf_update
    calls = []

    def recorded(opt_cfg, p, g, m, v, s):
        calls.append((p.numel(), isinstance(m, QTensor)))
        return leaf_update(opt_cfg, p, g, m, v, s)

    monkeypatch.setattr(step_mod.adamw, "leaf_update", recorded)
    return calls


def _state_by_name(p, o) -> dict:
    return {**{"params" + k: t for k, t in _leaves_with_keys(p)},
            **{"opt" + k: t for k, t in _leaves_with_keys(o)}}


@pytest.mark.parametrize("moment_style", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("placement", ["untiered", "host_offload_0.0"])
def test_update_in_row_slices_is_bit_equal(monkeypatch, moment_style,
                                           placement):
    """The update taken a few rows at a time (``UPDATE_SLICE`` cut to 64
    elements: every leaf in slices of one row, REMOTE ones fetched and
    written back slice by slice) gives the bits of the whole-leaf update.
    At d_model 256 and d_ff 1024 the MLP leaves hold int8 moments, and
    those are sliced too: their codes and scales cut by the same rows."""
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32,
                         d_model=256, d_ff=1024)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, moment_style=moment_style)
    p0, o0 = init_train_state(torch.Generator().manual_seed(0), cfg,
                              TrainStepConfig(), opt_cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    tiering = PLACEMENTS[placement]
    calls = _recording_leaf_update(monkeypatch)
    out = []
    for slice_elems in (step_mod.UPDATE_SLICE, 64):
        monkeypatch.setattr(step_mod, "UPDATE_SLICE", slice_elems)
        calls.clear()
        p, o, plan = place_state(_clone(p0), _clone(o0), tiering,
                                 device="cpu")
        step = make_train_step(cfg, TrainStepConfig.from_tiering(tiering),
                               opt_cfg, plan=plan)
        for _ in range(2):
            p, o, _ = step(p, o, batch)
        out.append(_state_by_name(p, o))
    # the sliced run: one row of the leaf's last dim a call
    widest = max(t.shape[-1] for _, t in _leaves_with_keys(p0))
    assert max(n for n, _ in calls) <= max(64, widest)
    quantized = [n for n, q in calls if q]
    if moment_style == "int8":
        assert type(o["m"]["layers"]["mlp"]["w_up"]).__name__ == "QTensor"
        # the embedding's 2048 rows, w_up's and w_gate's 2 x 256, w_down's
        # 2 x 1024; two steps
        assert len(quantized) == 2 * (2048 + 2 * 2 * 256 + 2 * 1024)
        assert max(quantized) <= 1024
    else:
        assert not quantized
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


@pytest.mark.parametrize("moment_style", ["f32", "int8"])
@pytest.mark.parametrize("placement", ["untiered", "host_offload_0.0"])
def test_update_slices_cut_inside_a_stacked_layer(monkeypatch, placement,
                                                  moment_style):
    """Reduced mixtral-8x7b at d_model 256 with experts of 256: its stacked
    expert leaves (2, 4, 256, 256) hold 262144 elements a layer, 1 MiB in
    float32, so their int8 moments are codes. With ``UPDATE_SLICE`` at
    65536 AdamW takes them in slices of 256 rows of the last dim, 65536
    elements each and never a whole layer (a full-width expert weight's
    layer holds 470 M); an int8 slice (256 KiB in float32, under the 1 MiB
    that ``quantize`` asks of a leaf) still comes back as codes, and the
    bits are the whole-leaf update's."""
    cfg = reduced_config(get_config("mixtral-8x7b"), dtype=torch.float32,
                         d_model=256, moe_d_ff=256)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, moment_style=moment_style)
    p0, o0 = init_train_state(torch.Generator().manual_seed(0), cfg,
                              TrainStepConfig(), opt_cfg, device="cpu")
    assert tuple(p0["layers"]["moe"]["w_gate"].shape) == (2, 4, 256, 256)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    tiering = PLACEMENTS[placement]
    calls = _recording_leaf_update(monkeypatch)
    out = []
    for slice_elems in (step_mod.UPDATE_SLICE, 65536):
        monkeypatch.setattr(step_mod, "UPDATE_SLICE", slice_elems)
        calls.clear()
        p, o, plan = place_state(_clone(p0), _clone(o0), tiering,
                                 device="cpu")
        p, o, _ = make_train_step(cfg, TrainStepConfig.from_tiering(tiering),
                                  opt_cfg, plan=plan)(p, o, batch)
        out.append(_state_by_name(p, o))
    sizes = [n for n, _ in calls]
    assert max(sizes) == 65536 and sizes.count(65536) >= 3 * 2 * 262144 // 65536
    quantized = [n for n, q in calls if q]
    if moment_style == "int8":
        for w in ("w_gate", "w_up", "w_down"):
            assert isinstance(o["m"]["layers"]["moe"][w], QTensor)
            assert isinstance(o["v"]["layers"]["moe"][w], QTensor)
        # the embedding (2048, 256) and the three expert leaves
        assert quantized == [65536] * ((2048 * 256 + 3 * 2 * 262144)
                                       // 65536)
        assert 65536 * 4 < MIN_QUANT_BYTES
    else:
        assert not quantized
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


# -- the reference's tests/test_train.py, pointed at the port -----------------

@pytest.fixture(scope="module")
def tiny_cfg():
    return reduced_config(get_config("granite-8b"), dtype=torch.float32,
                          n_layers=2, vocab_size=128)


def test_loss_decreases(tiny_cfg):
    res = train(
        tiny_cfg,
        TrainStepConfig(remat="full"),
        AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100),
        LoopConfig(steps=25, batch=4, seq=32, log_every=100),
        device="cpu",
    )
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.2, f"no learning: {first:.3f} -> {last:.3f}"


def test_microbatching_matches_full_batch(tiny_cfg):
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    from repro_torch.models import make_batch

    params, opt_state = init_train_state(
        torch.Generator().manual_seed(0), tiny_cfg, TrainStepConfig(), opt,
        device="cpu")
    batch = make_batch(tiny_cfg, torch.Generator().manual_seed(1), 8, 32,
                       device="cpu")
    step_full = make_train_step(tiny_cfg, TrainStepConfig(microbatches=1), opt)
    step_mb = make_train_step(tiny_cfg, TrainStepConfig(microbatches=4), opt)
    p1, _, m1 = step_full(params, opt_state, batch)
    p2, _, m2 = step_mb(params, opt_state, batch)
    assert torch.allclose(m1["loss"], m2["loss"], rtol=1e-4)
    got = dict(_leaves_with_keys(p2))
    for k, a in _leaves_with_keys(p1):
        np.testing.assert_allclose(a, got[k], atol=2e-5, rtol=2e-4)


def test_compression_path_trains(tiny_cfg):
    res = train(
        tiny_cfg,
        TrainStepConfig(compression=CompressionConfig(enabled=True)),
        AdamWConfig(lr=3e-3, warmup_steps=5),
        LoopConfig(steps=12, batch=4, seq=32, log_every=100),
        device="cpu",
    )
    assert np.isfinite(res.losses).all()


def test_checkpoint_restart_resumes_exactly(tiny_cfg, tmp_path):
    """Fault tolerance: a killed run resumes bit-exactly from the ckpt."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    common = dict(batch=4, seq=32, log_every=100, ckpt_every=10,
                  ckpt_dir=str(tmp_path / "ckpt"))
    ref = train(tiny_cfg, TrainStepConfig(), opt,
                LoopConfig(steps=20, ckpt_dir=None, **{
                    k: v for k, v in common.items() if k != "ckpt_dir"}),
                device="cpu")

    class Boom(Exception):
        pass

    def bomb(step):
        if step == 13:
            raise Boom()

    with pytest.raises(Boom):
        train(tiny_cfg, TrainStepConfig(), opt,
              LoopConfig(steps=20, **common), fault_hook=bomb, device="cpu")
    resumed = train(tiny_cfg, TrainStepConfig(), opt,
                    LoopConfig(steps=20, **common), device="cpu")
    assert resumed.restored_from == 10
    # the data stream is deterministic in step => identical trajectory
    assert resumed.losses == ref.losses[10:]


def test_checkpoint_restart_under_host_offload_resumes_exactly(tiny_cfg,
                                                             tmp_path):
    """The restart contract with params and moments at host_offload 0.5:
    REMOTE leaves live on the host and each step updates them in place
    while the checkpoint writer runs."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    step_cfg = TrainStepConfig.from_tiering(
        TieringConfig(mode="host_offload", local_fraction=0.5))
    common = dict(steps=12, batch=4, seq=32, log_every=100, ckpt_every=4)
    ref = train(tiny_cfg, step_cfg, opt, LoopConfig(**common), device="cpu")

    class Boom(Exception):
        pass

    def bomb(step):
        if step == 6:
            raise Boom()

    ckpt = dict(common, ckpt_dir=str(tmp_path / "ckpt"))
    with pytest.raises(Boom):
        train(tiny_cfg, step_cfg, opt, LoopConfig(**ckpt), fault_hook=bomb,
              device="cpu")
    resumed = train(tiny_cfg, step_cfg, opt, LoopConfig(**ckpt),
                    device="cpu")
    assert resumed.restored_from == 4
    assert resumed.losses == ref.losses[4:]


def test_step_config_has_one_source_of_prefetch():
    """The placement's prefetch knobs are the step's: from_tiering sets
    both, and a config whose two disagree is refused."""
    off = TieringConfig(mode="host_offload", prefetch=False)
    cfg = TrainStepConfig.from_tiering(off, remat="none")
    assert (cfg.prefetch, cfg.tiering.prefetch, cfg.remat) == (
        False, False, "none")
    cfg = TrainStepConfig.from_tiering(TieringConfig(), prefetch=False)
    assert not cfg.prefetch and not cfg.tiering.prefetch
    assert TrainStepConfig(prefetch=False).tiering is None
    with pytest.raises(ValueError, match="from_tiering"):
        TrainStepConfig(tiering=off)


def test_straggler_watchdog_detects(monkeypatch, tiny_cfg):
    """Inject a 10s stall into exactly one step's measured duration."""
    import time as _time

    orig = _time.perf_counter
    state = {"phase": 0}

    def fake_counter():
        t = orig()
        if state["phase"] == 1:     # t0 of the step after the hook fired
            state["phase"] = 2
            return t
        if state["phase"] >= 2:     # its dt measurement (+ keep the offset
            state["phase"] = 3      # so later deltas are normal again)
            return t + 10.0
        return t

    monkeypatch.setattr("repro_torch.train.loop.time.perf_counter",
                        fake_counter)

    def hook(step):
        if step == 15 and state["phase"] == 0:
            state["phase"] = 1

    res = train(tiny_cfg, TrainStepConfig(), AdamWConfig(),
                LoopConfig(steps=20, batch=2, seq=16, log_every=100),
                fault_hook=hook, device="cpu")
    assert any(e["step"] >= 15 for e in res.straggler_events)


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch import train as launch

    res = launch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                       "--seq", "16"])
    assert res.final_step == 3 and len(res.losses) == 3
    out = capsys.readouterr().out
    assert "arch=mamba2-130m" in out and "done: step 3" in out
    # a mesh of one starts its own one-process group; a larger one needs
    # a running group (test_torch_mesh.py runs --mesh 2,2 in one)
    res = launch.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--mesh", "1,1",
                       "--rules", '{"ff": null}'])
    assert res.final_step == 2
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="process group"):
        launch.main(["--device", "cpu", "--mesh", "2,1"])
    with pytest.raises(ValueError, match="--mesh"):
        launch.main(["--device", "cpu", "--distributed"])
