"""``tests/test_system.py``'s four headline cases against the port, each
number on the numpy side ``==`` the reference's.

* The eight HPC workloads at a 50 % registered-region budget with every
  large object remote: checksums equal to the untiered oracle's, mean
  slowdown at most 1.25 and median at most 1.16, every slowdown equal to
  the reference's.
* CG's object census: the large objects hold more than 99 % of the peak.
* Reduced granite-8b: the placement over parameters and moments
  (``plan_for_params(opt_state=)``) demotes moments first and saves more
  than 30 % (the reference's plan, leaf for leaf), and 10 train steps on
  the CPU lower the loss.
* deepseek-v3's policy: the routed experts REMOTE, the MLA latent cache
  LOCAL.
"""
import jax
import numpy as np
import pytest
import torch

from repro import core as REF_CORE
from repro import hpc as REF_HPC
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core.placement import PlacementPolicy as RefPolicy
from repro.core.tiering import TieringConfig as RefTiering
from repro.core.tiering import plan_for_params as ref_plan_for_params
from repro.models import get_model as ref_get_model

from repro_torch import core as CORE
from repro_torch import hpc as HPC
from repro_torch.configs import get_config, reduced_config

SIM = 1000.0 / 0.2


def _slowdowns(core, hpc, policy_cls) -> tuple[list, list]:
    slowdowns, checks = [], []
    for name, cls in hpc.WORKLOADS.items():
        oracle = hpc.run_workload(cls(scale=0.2, seed=1), core.DolmaRuntime(
            local_fraction=1.0, sim_scale=SIM), 4)
        dolma = hpc.run_workload(cls(scale=0.2, seed=1), core.DolmaRuntime(
            local_fraction=0.5, fabric=core.INFINIBAND_100G,
            dual_buffer=True, sim_scale=SIM,
            policy=policy_cls(all_large_remote=True)), 4)
        checks.append((dolma.checksum, oracle.checksum))
        slowdowns.append(dolma.elapsed_us / oracle.elapsed_us)
    return slowdowns, checks


def test_headline_memory_saving_with_bounded_slowdown():
    got, checks = _slowdowns(CORE, HPC, CORE.PlacementPolicy)
    for dolma, oracle in checks:
        assert dolma == pytest.approx(oracle, rel=1e-9)
    assert np.mean(got) <= 1.25, f"mean slowdown {np.mean(got):.3f}"
    assert np.median(got) <= 1.16
    want, _ = _slowdowns(REF_CORE, REF_HPC, RefPolicy)
    assert got == want


def _census(core, hpc) -> dict:
    rt = core.DolmaRuntime(local_fraction=1.0)
    hpc.WORKLOADS["CG"](scale=0.2, seed=1).register(rt)
    return core.ObjectCatalog(lo.obj for lo in rt._live.values()).census()


def test_object_census_matches_paper_finding():
    got = _census(CORE, HPC)
    assert got["large_fraction_of_peak"] > 0.99
    assert got == _census(REF_CORE, REF_HPC)


def test_lm_training_end_to_end_with_tiering_decision():
    from repro_torch.core.tiering import TieringConfig, plan_for_params
    from repro_torch.models import get_model, make_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import (
        TrainStepConfig,
        init_train_state,
        make_train_step,
    )

    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2)
    params, opt_state = init_train_state(
        torch.Generator().manual_seed(0), cfg, TrainStepConfig(), opt_cfg,
        device="cpu")
    # DOLMA placement over params+moments: moments demoted first
    plan = plan_for_params(params, config=TieringConfig(local_fraction=0.4),
                           opt_state={"m": params, "v": params})
    remote = set(plan.remote_names())
    assert any(n.startswith("opt") for n in remote)
    assert plan.memory_saving > 0.3

    rcfg = ref_reduced_config(ref_get_config("granite-8b"),
                              dtype=jax.numpy.float32)
    rparams = jax.eval_shape(lambda k: ref_get_model(rcfg).init_params(
        k, rcfg), jax.random.PRNGKey(0))
    ref = ref_plan_for_params(rparams, config=RefTiering(local_fraction=0.4),
                              opt_state={"m": rparams, "v": rparams})
    assert {n: t.name for n, t in plan.tiers.items()} == {
        n: t.name for n, t in ref.tiers.items()}
    assert (plan.local_bytes, plan.remote_bytes, plan.memory_saving) == (
        ref.local_bytes, ref.remote_bytes, ref.memory_saving)

    step = make_train_step(cfg, TrainStepConfig(), opt_cfg)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(10):
        batch = make_batch(cfg, gen, 4, 32, device="cpu")
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    get_model(cfg)  # the family's module, as the reference's case builds it


def _deepseek_plan(core, cfg):
    cat = core.ObjectCatalog()
    cat.add(core.DataObject("experts", (cfg.n_experts, cfg.d_model,
                                        cfg.moe_d_ff), np.float16,
                            n_reads=1, kind=core.ObjectKind.PARAM))
    # MLA latent cache: small per token, read every decode step
    cat.add(core.DataObject("mla_cache", (32768, cfg.kv_lora_rank),
                            np.float16, n_reads=100, n_writes=100,
                            kind=core.ObjectKind.KV_CACHE))
    return core.PlacementPolicy().plan(cat, local_fraction=0.05)


def test_deepseek_policy_keeps_mla_cache_local_demotes_experts():
    plan = _deepseek_plan(CORE, get_config("deepseek-v3-671b"))
    assert plan.tier_of("experts") is CORE.Tier.REMOTE
    assert plan.tier_of("mla_cache") is CORE.Tier.LOCAL
    ref = _deepseek_plan(REF_CORE, ref_get_config("deepseek-v3-671b"))
    assert {n: t.name for n, t in plan.tiers.items()} == {
        n: t.name for n, t in ref.tiers.items()}
    assert (plan.local_bytes, plan.remote_bytes) == (ref.local_bytes,
                                                      ref.remote_bytes)
