"""The checks ``chip_smoke.py``'s ``[train]`` makes of the trainer's
options on the CPU: the fingerprint that holds two runs' leaves bit-equal
on the card without host copies, and the count of B2 launches a step
(``step_launches``) under every remat policy and over microbatches, held
to the models' flash calls in a step on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.tiering import TieringConfig, place_state
from repro_torch.models import flash as mflash
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, QTensor, adamw, init_error_feedback
from repro_torch.train.step import (
    TrainStepConfig,
    init_train_state,
    make_train_step,
    make_value_and_grad,
)

from _torch_model_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module (importing it runs nothing)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _flip(t: torch.Tensor, index: int, bit: int) -> torch.Tensor:
    """``t`` with one bit of one element's raw word flipped."""
    out = t.clone()
    word = out.view(-1).view({1: torch.int8, 2: torch.int16,
                              4: torch.int32}[t.element_size()])
    word[index] ^= torch.tensor(1, dtype=word.dtype) << bit
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_fingerprint_sees_one_flipped_bit(chip_smoke, monkeypatch, dtype):
    """Equal tensors give equal fingerprints; one flipped bit anywhere (the
    lowest, a middle and the sign bit, in the first and a later chunk) or
    two elements swapped give another."""
    monkeypatch.setattr(chip_smoke, "FINGERPRINT_CHUNK", 64)
    rng = np.random.default_rng(0)
    if dtype == torch.int8:
        t = torch.from_numpy(rng.integers(-127, 128, (5, 40)).astype(np.int8))
    else:
        t = torch.from_numpy(rng.standard_normal((5, 40)).astype(
            np.float32)).to(dtype)
    fp = chip_smoke.fingerprint(t, "cpu")
    assert fp == chip_smoke.fingerprint(t.clone(), "cpu")
    assert fp[:2] == ((5, 40), str(dtype))
    bits = 8 * t.element_size()
    for index in (0, 37, 130, 199):
        for bit in (0, bits // 2, bits - 1):
            assert chip_smoke.fingerprint(_flip(t, index, bit), "cpu") != fp
    swapped = t.clone().view(-1)
    a, b = swapped[3].clone(), swapped[100].clone()
    assert not torch.equal(a, b)
    swapped[3], swapped[100] = b, a
    assert chip_smoke.fingerprint(swapped.view(5, 40), "cpu") != fp
    # a leaf of a tree is keyed as the tree's keystr, an int8 moment's codes
    # and scales apart
    tree = {"w": t, "q": chip_smoke.QTensor(
        torch.zeros(2, 256, dtype=torch.int8), torch.zeros(2, 1))}
    assert set(chip_smoke.fingerprints(tree, "cpu")) == {
        "['w']", "['q'].codes", "['q'].scale"}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch", "none",
                                   "full_flat"])
@pytest.mark.parametrize("arch,n_layers", [("granite-8b", 2),
                                           ("granite-8b", 12),
                                           ("deepseek-v3-671b", 3)])
def test_step_launches_counts_the_flash_calls(chip_smoke, monkeypatch, arch,
                                              n_layers, remat, microbatches):
    """``step_launches``' B2 count is the models' flash calls in one train
    step (forwards, every recompute, each microbatch's), counted on the CPU
    where the same call runs the plain flash: ``dots`` and
    ``dots_no_batch`` save matrix products only, so they recompute the
    attention as ``full`` does; 12 layers nest the checkpoints; deepseek-v3
    runs its dense and MoE loops and the MTP block."""
    over = dict(n_layers=n_layers)
    if arch.startswith("deepseek"):
        over["first_k_dense"] = 2
    cfg = reduced_config(get_config(arch), dtype=torch.float32, **over)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step_cfg = TrainStepConfig(remat=remat, microbatches=microbatches)
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg,
                                   step_cfg, opt_cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    calls = []
    flash = mflash.blocked_flash
    monkeypatch.setattr(mflash, "blocked_flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    make_train_step(cfg, step_cfg, opt_cfg)(
        params, opt, {"tokens": tokens, "labels": tokens})
    want = chip_smoke.step_launches(cfg, remat, microbatches)
    assert len(calls) == want["flash_attention"]
    assert want["flash_attention_bwd"] == microbatches * (
        n_layers + cfg.mtp_depth)


@pytest.mark.parametrize("ladder", ["int8 ladder", "bf16 ladder"])
def test_ladder_legs_are_bit_equal_across_placements(chip_smoke, ladder):
    """``TRAIN_LADDER``'s options together on reduced granite-8b at d_model
    256 (its MLP leaves and embedding take int8 codes): one step untiered
    and at host_offload 0.5 with parameters, moments and the error-feedback
    buffer in the plan, every leaf's fingerprint equal (loss, gradients,
    updated parameters, codes, scales, the buffer)."""
    spec = chip_smoke.TRAIN_LADDER[ladder]
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.bfloat16,
                         d_model=256, d_ff=1024)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0,
                          moment_style=spec["moment_style"])
    p0 = get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    out = {}
    for name, tiering in (("untiered", TieringConfig()), (
            "host_offload 0.5", TieringConfig(mode="host_offload",
                                              local_fraction=0.5))):
        params = dict(p0)  # the step writes REMOTE leaves' copies only
        opt = adamw.init(opt_cfg, params)
        step_cfg = TrainStepConfig.from_tiering(
            tiering, remat=spec["remat"], **spec["step_kw"])
        if step_cfg.compression.enabled:
            opt["ef"] = init_error_feedback(params)
        params, opt, plan = place_state(params, opt, tiering, device="cpu")
        if plan is not None:
            assert any(n.startswith("opt['ef']") for n in plan.tiers) == (
                step_cfg.compression.enabled)
            assert plan.remote_names()
        loss, _, grads = make_value_and_grad(cfg, step_cfg, plan=plan)(
            params, batch)
        params, opt, m = make_train_step(cfg, step_cfg, opt_cfg, plan=plan)(
            params, opt, batch)
        n_q = sum(isinstance(t, QTensor) for mom in ("m", "v")
                  for _, t in adamw.leaves(opt[mom]))
        assert n_q > 0 if spec["moment_style"] == "int8" else n_q == 0
        out[name] = chip_smoke.fingerprints(
            {"loss": loss, "grads": grads, "step_loss": m["loss"],
             "params": params, "opt": opt}, "cpu")
    assert out["untiered"] == out["host_offload 0.5"]
