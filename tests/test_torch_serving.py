"""The port's serving engine (``repro_torch.serving.engine``) against the JAX
reference, on the CPU.

* The reference's own cases (``tests/test_serving.py``: batched generation,
  determinism, cache placement, pool overflow, the tiered == untiered
  battery) pointed at the port, with the reference's parameters carried
  over by ``convert.params_from_reference``.
* Parity with the reference's engine on the same weights and prompts,
  reduced configs in float32: greedy tokens equal (``np.array_equal``),
  untiered and under pool pressure; the plan summary and ``stats()``
  ``==``; each pool payload ``==`` to the port's own cache and within
  ``CACHE_TOL`` of the reference's (K and V are each package's float32
  arithmetic, a few ulps apart). One field differs by design: the reference's
  ``offload_memory_kind`` is ``"pinned_host"`` on XLA's CPU backend, which
  accepts that memory kind, and the port's is None on the CPU, where torch
  pins no memory (``tiering.supports_host_offload``); it is held to each
  package's own probe.
* Lane decode (``enable_lane_decode`` / ``decode_lanes`` / ``reset_lanes``)
  on reduced granite-8b, mamba2-130m and zamba2-1.2b: every step's tokens
  equal the reference engine's, and every cache leaf's reset lanes are zero.
* ``launch.serve.main`` on the CPU, and a bf16 engine whose pool overflow
  and per-tenant offload write the cache's exact bytes (uint16 views).

Tokens are compared exactly; numpy-side values with ``==``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core.tiering import supports_host_offload as ref_supports_host_offload
from repro.models import get_model as ref_get_model

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.tiering import supports_host_offload
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.serving import EngineConfig, ExpertPagingConfig, ServingEngine

import _torch_serving_parity as P

KIB = 1024
# the float32 cache bound of the decode parity tests (test_torch_dense.py):
# K and V come from each package's own arithmetic, equal to a few ulps
CACHE_TOL = 1e-4
PKGS = (P.package("repro"), P.package("repro_torch"))


@dataclasses.dataclass
class Setup:
    """One reduced float32 architecture in both packages, same weights."""

    ref_cfg: object
    ref_params: dict
    cfg: object
    params: dict
    total: int  # parameter bytes


def _setup(arch: str, dtype: str = "float32") -> Setup:
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref_cfg = ref_reduced_config(ref_get_config(arch), dtype=jdt)
    ref_params = ref_get_model(ref_cfg).init_params(jax.random.PRNGKey(0),
                                                    ref_cfg)
    params = params_from_reference(ref_params, device="cpu")
    return Setup(ref_cfg, ref_params,
                 reduced_config(get_config(arch), dtype=tdt), params,
                 P.param_bytes(ref_params))


@pytest.fixture(scope="module")
def engine_setup():
    s = _setup("granite-8b")
    return s.cfg, get_model(s.cfg), s.params


# -- the reference's cases (tests/test_serving.py), pointed at the port ------

def test_generate_matches_manual_decode(engine_setup):
    cfg, model, params = engine_setup
    prompts = np.array([[5, 9, 2], [7, 1, 3]], np.int32)
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=32))
    out = eng.generate(prompts, max_new=4)

    # manual greedy decode (reference)
    cache = model.init_decode_cache(cfg, 2, 32, device="cpu")
    logits = None
    toks = torch.from_numpy(prompts)
    for t in range(prompts.shape[1]):
        logits, cache = model.decode_step(params, cache, toks[:, t:t+1], cfg)
    ref = []
    cur = logits[:, :, : cfg.vocab_size].argmax(-1).to(torch.int32)
    for _ in range(4):
        ref.append(cur.numpy())
        logits, cache = model.decode_step(params, cache, cur, cfg)
        cur = logits[:, :, : cfg.vocab_size].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(out, np.concatenate(ref, 1))


def test_generate_deterministic(engine_setup):
    cfg, _model, params = engine_setup
    prompts = np.array([[1, 2, 3, 4]], np.int32)
    a = ServingEngine(cfg, params, EngineConfig(max_batch=1, max_len=16)
                      ).generate(prompts, max_new=3)
    b = ServingEngine(cfg, params, EngineConfig(max_batch=1, max_len=16)
                      ).generate(prompts, max_new=3)
    np.testing.assert_array_equal(a, b)


def test_cache_placement_under_budget(engine_setup):
    cfg, _model, params = engine_setup
    total = P.param_bytes(params)
    # budget = 40% of params => the policy demotes the biggest objects
    eng = ServingEngine(cfg, params,
                        EngineConfig(max_batch=2, max_len=64,
                                     hbm_budget_bytes=int(total * 0.4)))
    s = eng.stats()
    assert s["placement"]["n_remote"] > 0
    assert s["placement"]["memory_saving"] > 0.3

    # generous budget => everything local
    eng2 = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=64))
    assert eng2.stats()["placement"]["n_remote"] == 0


def test_kv_overflow_targets_pool(engine_setup):
    """Demoted KV-cache tiers are striped into the multi-node memory pool."""
    cfg, _model, params = engine_setup
    total = P.param_bytes(params)
    eng = ServingEngine(
        cfg, params,
        EngineConfig(max_batch=2, max_len=64,
                     hbm_budget_bytes=int(total * 0.2),
                     pool_nodes=2, pool_replication=2,
                     pool_stripe_bytes=64 * 1024),
    )
    demoted_cache = [n for n in eng.placement.remote_names()
                     if n.startswith("cache")]
    if not demoted_cache:
        pytest.skip("budget did not demote any cache tier for this config")
    assert eng.pool is not None
    for name in demoted_cache:
        assert name in eng.pool
    before = eng.pool.stats()["bytes_written"]

    eng.generate(np.array([[5, 9, 2]], np.int32), max_new=2)
    after = eng.pool.stats()
    # the post-wave overflow write-back really hit the pool's fabric
    assert after["bytes_written"] > before
    assert after["n_alive"] == 2
    # pool holds the current cache values for every demoted tier
    leaves = eng._cache_leaves()
    for name in demoted_cache:
        got = eng.pool.payload(name)
        np.testing.assert_array_equal(got, np.asarray(leaves[name]))


@pytest.mark.parametrize("arch", ["granite-8b", "glm4-9b"])
def test_output_equivalence_under_pool_pressure(arch):
    """Tokens under HBM pressure + pool overflow are bit-identical to the
    untiered/unpooled engine — tiering must never change what is served."""
    s = _setup(arch)
    cfg, params, total = s.cfg, s.params, s.total
    prompts = np.array([[5, 9, 2, 11], [7, 1, 3, 4]], np.int32)
    base = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=48))
    tiered = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=48,
        hbm_budget_bytes=int(total * 0.15),
        pool_nodes=2, pool_replication=2, pool_stripe_bytes=64 * 1024,
    ))
    assert tiered.placement.remote_names(), "budget applied no pressure"
    ref = base.generate(prompts, max_new=6)
    out = tiered.generate(prompts, max_new=6)
    np.testing.assert_array_equal(out, ref)


def test_multi_wave_reset_roundtrips_pool(engine_setup):
    """generate -> reset -> generate: reset frees the previous wave's
    demoted KV entries (no stale pool aliases) and the next wave's overflow
    round-trips the fresh cache contents bit-identically."""
    cfg, _model, params = engine_setup
    total = P.param_bytes(params)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=48, hbm_budget_bytes=int(total * 0.15),
        pool_nodes=2, pool_stripe_bytes=64 * 1024,
    ))
    demoted = [n for n in eng.placement.remote_names()
               if n.startswith("cache")]
    if not demoted:
        pytest.skip("budget did not demote any cache tier for this config")
    prompts = np.array([[5, 9, 2]], np.int32)
    out1 = eng.generate(prompts, max_new=4)
    assert any(n.startswith("cache") for n in eng.pool.names())

    eng.reset()
    # the stale wave's cache objects are gone from the pool
    assert not any(n.startswith("cache") for n in eng.pool.names())

    out2 = eng.generate(prompts, max_new=4)
    np.testing.assert_array_equal(out2, out1)  # fresh wave, same answer
    leaves = eng._cache_leaves(set(demoted))
    for name in demoted:
        np.testing.assert_array_equal(eng.pool.payload(name), leaves[name])


def test_placement_summary_records_offload_capability(engine_setup):
    """The plan summary states how demotions would be realized on the
    engine's device (pinned host memory on a card)."""
    cfg, _model, params = engine_setup
    total = P.param_bytes(params)
    tight = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=64, hbm_budget_bytes=int(total * 0.3)))
    s = tight.stats()["placement"]
    assert s["n_remote"] > 0
    expected = "pinned_host" if supports_host_offload("cpu") else None
    assert s["offload_memory_kind"] == expected

    # no demotions -> nothing to offload, whatever the device supports
    roomy = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=64))
    assert roomy.stats()["placement"]["offload_memory_kind"] is None


# -- the port's own contract -------------------------------------------------

def test_engine_runs_on_its_params_device(engine_setup):
    """The cache is made on the params' device (the CPU here), and a lane
    vector ``pos`` too; the offload probe says no on the CPU and on a card
    that is absent."""
    cfg, _model, params = engine_setup
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=2, max_len=16))
    assert eng.device == torch.device("cpu")
    assert all(t.device == eng.device for t in eng.cache.values())
    eng.reset()
    assert all(t.device == eng.device for t in eng.cache.values())
    eng.enable_lane_decode()
    assert eng.cache["pos"].dtype == torch.int32
    assert tuple(eng.cache["pos"].shape) == (2,)
    assert not supports_host_offload("cpu")
    assert supports_host_offload("cuda") == torch.cuda.is_available()


def test_expert_paging_waits_for_a7(engine_setup):
    """``EngineConfig(expert_paging=...)`` is accepted (expert paging is
    served, ``tests/test_torch_expert_paging.py``); an engine over a model
    that is not a routed MoE raises the reference's ValueError."""
    cfg, _model, params = engine_setup
    pcfg = ExpertPagingConfig(resident_max=2)
    assert EngineConfig(expert_paging=pcfg).expert_paging is pcfg
    assert EngineConfig().expert_paging is None
    with pytest.raises(ValueError, match="routed-MoE"):
        ServingEngine(cfg, params, EngineConfig(expert_paging=pcfg))
    moe = reduced_config(get_config("mixtral-8x7b"), dtype=torch.float32)
    moe_params = get_model(moe).init_params(torch.Generator().manual_seed(0),
                                            moe, device="cpu")
    eng = ServingEngine(moe, moe_params, EngineConfig(
        max_batch=2, max_len=16, expert_paging=pcfg))
    assert eng.expert_store is not None and eng.pool is not None
    assert eng.stats()["experts"]["n_experts"] == moe.n_experts
    eng.expert_store.close()


# -- parity with the reference's engine --------------------------------------

def _strip_kind(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k != "offload_memory_kind"}


def _ref_kind(eng) -> str | None:
    """What the reference's probe makes of the plan on its backend."""
    return ("pinned_host" if eng.placement.remote_names()
            and ref_supports_host_offload() else None)


@pytest.mark.parametrize("mode", ["untiered", "pool"])
@pytest.mark.parametrize("arch", ["granite-8b", "glm4-9b"])
def test_engine_matches_reference(arch, mode):
    """Two waves (generate -> reset -> generate) through both engines:
    tokens equal; plan summary and ``stats()`` (no wall-clock field in
    it) ``==``; every pool payload the port's cache exactly and the
    reference's payload within ``CACHE_TOL``."""
    s = _setup(arch)
    kw = dict(max_batch=2, max_len=48)
    if mode == "pool":
        kw.update(hbm_budget_bytes=int(s.total * 0.1), pool_nodes=2,
                  pool_replication=2, pool_stripe_bytes=64 * KIB)
    P.restart_resource_names(*PKGS)  # one count per package
    ref = ref_serving.ServingEngine(s.ref_cfg, s.ref_params,
                                    ref_serving.EngineConfig(**kw))
    eng = ServingEngine(s.cfg, s.params, EngineConfig(**kw))
    assert eng.catalog.names() == ref.catalog.names()
    for prompts, max_new in ((np.array([[5, 9, 2, 11], [7, 1, 3, 4]],
                                       np.int32), 6),
                             (np.array([[3, 8]], np.int32), 5)):
        np.testing.assert_array_equal(eng.generate(prompts, max_new),
                                      ref.generate(prompts, max_new))
        got, want = eng.stats(), ref.stats()
        assert _strip_kind(got.pop("placement")) == _strip_kind(
            want.pop("placement"))
        assert got == want
        if mode == "pool":
            assert eng.placement.node_of == ref.placement.node_of
            assert eng.pool.names() == ref.pool.names()
            leaves = eng._cache_leaves()
            for name in ref.pool.names():
                got = eng.pool.payload(name)
                np.testing.assert_array_equal(got, leaves[name])
                np.testing.assert_allclose(got, ref.pool.payload(name),
                                           atol=CACHE_TOL, rtol=CACHE_TOL)
        eng.reset()
        ref.reset()
    assert eng.placement_summary()["offload_memory_kind"] is None
    assert ref.placement_summary()["offload_memory_kind"] == _ref_kind(ref)


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m", "zamba2-1.2b"])
def test_lane_decode_matches_reference(arch):
    """Lanes join and retire mid-stream through both engines: every step's
    tokens equal, positions equal, and after ``reset_lanes`` every cache
    leaf's reset lanes are zero (``k``/``v``, ``conv``/``state``,
    ``shared_k``/``shared_v``) and ``pos`` is 0 there."""
    s = _setup(arch)
    kw = dict(max_batch=3, max_len=24)
    ref = ref_serving.ServingEngine(s.ref_cfg, s.ref_params,
                                    ref_serving.EngineConfig(**kw))
    eng = ServingEngine(s.cfg, s.params, EngineConfig(**kw))
    ref.enable_lane_decode()
    eng.enable_lane_decode()
    rng = np.random.default_rng(3)
    feeds = rng.integers(1, s.cfg.vocab_size, (14, 3)).astype(np.int32)
    for t, feed in enumerate(feeds):
        if t in (4, 9):  # lane 1 retires and a new request joins it
            lanes = [1] if t == 4 else [0, 2]
            ref.reset_lanes(lanes)
            eng.reset_lanes(lanes)
            for key, leaf in eng.cache.items():
                if key == "pos":
                    assert not leaf[lanes].any(), key
                else:
                    assert not leaf[:, lanes].any(), key
        got, _ = eng.decode_lanes(feed)
        want, _ = ref.decode_lanes(feed)
        np.testing.assert_array_equal(got, want, err_msg=f"step {t}")
        np.testing.assert_array_equal(eng.lane_positions(),
                                      ref.lane_positions())
    assert eng.lane_kv_bytes([0, 1]) == ref.lane_kv_bytes([0, 1])
    assert sorted(eng.cache) == sorted(ref.cache)


def test_launch_serve_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu``: a reduced
    granite-8b engine serves the request waves."""
    got = serve.main(["--arch", "granite-8b", "--device", "cpu",
                      "--requests", "2", "--batch", "2", "--new-tokens", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=granite-8b device=cpu placement=")
    assert out[1:3] == ["wave 0: 2 requests x 5 tokens",
                        "wave 1: 2 requests x 5 tokens"]
    assert got["tokens"] == 2 * 2 * 5 and got["tokens_per_s"] > 0
    assert "tok/s batched" in out[3]


# -- bf16 through the pool ----------------------------------------------------

@pytest.fixture(scope="module")
def bf16_engine():
    s = _setup("granite-8b", "bfloat16")
    eng = ServingEngine(s.cfg, s.params, EngineConfig(
        max_batch=3, max_len=32, hbm_budget_bytes=int(s.total * 0.15),
        pool_nodes=2, pool_replication=2, pool_stripe_bytes=4 * KIB))
    assert eng.cache["k"].dtype == torch.bfloat16
    assert {"cache['k']", "cache['v']"} <= set(eng._demoted_cache_names())
    return eng


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_bf16_overflow_writes_the_cache_bytes(bf16_engine):
    eng = bf16_engine
    eng.generate(np.array([[5, 9, 2], [7, 1, 3]], np.int32), max_new=4)
    for key in ("k", "v"):
        got = eng.pool.payload(f"cache['{key}']")
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, _bytes_of(eng.cache[key]))
        assert eng.cache[key].abs().sum() > 0


def test_bf16_tenant_offload_writes_the_lanes_bytes(bf16_engine):
    eng = bf16_engine
    eng.reset()
    eng.enable_lane_decode()
    for feed in ([4, 8, 15], [16, 23, 42], [1, 2, 3]):
        eng.decode_lanes(np.array(feed, np.int32))
    eng.offload_tenant_kv("acme", [2, 0])
    assert sorted(eng.tenant_kv_names("acme")) == [
        "kv:acme:cache['k']", "kv:acme:cache['v']"]
    for key in ("k", "v"):
        got = eng.pool.payload(f"kv:acme:cache['{key}']")
        np.testing.assert_array_equal(got,
                                      _bytes_of(eng.cache[key][:, [0, 2]]))
    eng.free_tenant_kv("acme")
    assert eng.tenant_kv_names("acme") == []
