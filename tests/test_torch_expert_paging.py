"""The port's expert paging (``repro_torch.serving.expert_paging`` and the
engine's paging leg) against the JAX reference, on the CPU.

The reference's own cases (``tests/test_expert_paging.py``) pointed at the
port, with the reference's parameters carried over by
``convert.params_from_reference`` (reduced deepseek-v3 and mixtral-8x7b in
float32). The paged engine's tokens are compared with the port's untiered
engine and with the reference's *untiered* engine (ROADMAP C1), and its
``stats()["experts"]`` ledger (hits, misses, fetches, simulated stall and
degradation) ``==`` the reference's paged engine's. The numpy pieces (the
pager, the census, the slab catalogue, the residency advisor) are held to
``==``.

``benchmarks/fig_expert_paging.py``'s loop through the port
(``tests/_torch_paging_parity.py``) gives ``BENCH_pr10.json``'s values
exactly.

The reference's four expert-parallel cases (``test_ep_threads_groups``,
``test_ep_rejects_bad_groups``, ``test_dense_vs_ep_property`` and
``test_zero_rows_are_exact[ep]``) run on a mesh in ``test_torch_mesh.py``;
``test_zero_rows_are_exact[dense]`` runs in ``test_torch_moe.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import get_model as ref_get_model
from repro.serving import expert_paging as ref_paging

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.placement import expert_slab_name, expert_slab_objects
from repro_torch.core.pool import MemoryPool
from repro_torch.core.sizing import (
    advise_expert_residency,
    decode_state_census,
)
from repro_torch.models import get_model
from repro_torch.serving import (
    AutoscaleConfig,
    EngineConfig,
    ExpertPager,
    ExpertPagingConfig,
    ExpertParamStore,
    ServingEngine,
)

from _torch_model_parity import one_torch_thread  # noqa: F401 (autouse)
import _torch_paging_parity as PG
import _torch_serving_parity as P

# deepseek pages with expert_sharding="expert", mixtral with "tensor"
ARCHS = ["deepseek-v3-671b", "mixtral-8x7b"]


class Arch:
    """One reduced float32 MoE architecture in both packages, same
    weights (a router skewed as ``fig_expert_paging`` skews it where
    ``skew``)."""

    def __init__(self, arch: str, *, skew: bool = False, **overrides):
        self.ref_cfg = ref_reduced_config(ref_get_config(arch),
                                          dtype=jnp.float32, **overrides)
        self.cfg = reduced_config(get_config(arch), dtype=torch.float32,
                                  **overrides)
        p = ref_get_model(self.ref_cfg).init_params(jax.random.PRNGKey(0),
                                                    self.ref_cfg)
        if skew:  # the first 20 % of gate logits times 4 (exact)
            hot = PG.n_hot(self.cfg.n_experts)
            moe = p["layers"]["moe"]
            router = moe["router"].at[..., :hot].multiply(PG.HOT_SCALE)
            p = {**p, "layers": {**p["layers"],
                                 "moe": {**moe, "router": router}}}
        self.ref_params = p
        self.params = params_from_reference(self.ref_params, device="cpu")


@pytest.fixture(scope="module")
def moe_setup():
    return {arch: Arch(arch) for arch in ARCHS}


def _prompts(cfg, batch=2, length=4, seed=1):
    return np.array(jax.random.randint(
        jax.random.PRNGKey(seed), (batch, length), 0, cfg.vocab_size
    ), np.int32)


def _paged_engine(cfg, params, *, resident_max=2, prefetch=True, **ecfg_kw):
    pcfg = ExpertPagingConfig(resident_max=resident_max, prefetch=prefetch,
                              throttle=0.0)
    return ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=32, expert_paging=pcfg, **ecfg_kw))


def _ref_paged_engine(a: Arch, *, resident_max=2, prefetch=True, **ecfg_kw):
    pcfg = ref_paging.ExpertPagingConfig(resident_max=resident_max,
                                         prefetch=prefetch, throttle=0.0)
    return ref_serving.ServingEngine(a.ref_cfg, a.ref_params,
                                     ref_serving.EngineConfig(
                                         max_batch=2, max_len=32,
                                         expert_paging=pcfg, **ecfg_kw))


def _untiered(a: Arch, prompts, max_new):
    """Tokens of the port's and of the reference's untiered engines."""
    mine = ServingEngine(a.cfg, a.params, EngineConfig(
        max_batch=2, max_len=32)).generate(prompts, max_new=max_new)
    ref = ref_serving.ServingEngine(a.ref_cfg, a.ref_params,
                                    ref_serving.EngineConfig(
                                        max_batch=2, max_len=32)
                                    ).generate(prompts, max_new=max_new)
    np.testing.assert_array_equal(mine, ref)
    return ref


# -- end-to-end bit-identity ------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_generate_bit_identical(moe_setup, arch):
    a = moe_setup[arch]
    prompts = _prompts(a.cfg)
    ref = _untiered(a, prompts, 6)
    eng = _paged_engine(a.cfg, a.params, resident_max=2)
    out = eng.generate(prompts, max_new=6)
    np.testing.assert_array_equal(ref, out)
    # the resident set was genuinely under-provisioned: paging happened
    st = eng.expert_store.stats()
    assert st["sync_fetches"] > 0
    assert st["misses"] > 0
    assert eng.stats()["experts"] == st
    # the ledger is the reference's paged engine's, field for field
    ref_eng = _ref_paged_engine(a, resident_max=2)
    ref_eng.generate(prompts, max_new=6)
    assert st == ref_eng.expert_store.stats()
    eng.expert_store.close()
    ref_eng.expert_store.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_cold_start_miss_path(moe_setup, arch):
    """The first paged step finds nothing resident: every routed expert
    goes through the blocking sync-fetch path, and the step still produces
    the exact logits (the fixpoint re-run).

    The reference's case also asserts ``sync_fetches == misses`` and fails
    that at reduced mixtral (7 against 6, ROADMAP C1): a fixpoint run whose
    earlier layers were not yet exact can route an expert that the accepted
    run does not, and that sync fetch is no miss of the accepted step. The
    port computes the same routing, so it gives the reference's counts;
    held here: tokens equal to both untiered engines, the counts equal to
    the reference's paged engine's, and every miss a sync fetch."""
    a = moe_setup[arch]
    cfg = a.cfg
    eng = _paged_engine(cfg, a.params, resident_max=cfg.n_experts)
    store = eng.expert_store
    assert store.resident_counts == [0] * store.n_moe_layers
    prompts = np.pad(_prompts(cfg, batch=1, length=1), ((0, 1), (0, 0)))
    ref = _untiered(a, prompts, 2)[:1]
    out = eng.generate(prompts, max_new=2)[:1]
    np.testing.assert_array_equal(ref, out)
    # step 1 had zero residency: its routed experts are all misses
    assert store.misses >= store.n_moe_layers
    assert store.sync_fetches >= store.misses  # every miss blocks
    assert store.hit_rate() < 1.0
    ref_eng = _ref_paged_engine(a, resident_max=cfg.n_experts)
    ref_eng.generate(prompts, max_new=2)
    ref_store = ref_eng.expert_store
    assert (store.sync_fetches, store.misses) == (ref_store.sync_fetches,
                                                  ref_store.misses)
    store.close()
    ref_store.close()


def test_hit_rate_monotone_in_resident_set(moe_setup):
    """More HBM (larger resident set) never pages worse — the expert
    analogue of the §6.1 local-fraction sweep being monotone."""
    a = moe_setup["mixtral-8x7b"]
    prompts = _prompts(a.cfg)
    rates = []
    for r in (1, 2, a.cfg.n_experts):
        eng = _paged_engine(a.cfg, a.params, resident_max=r)
        eng.generate(prompts, max_new=8)
        rates.append(eng.expert_store.hit_rate())
        eng.expert_store.close()
    assert rates == sorted(rates), rates
    assert rates[-1] > rates[0]


def test_prefetch_on_off_equivalence(moe_setup):
    """Prefetch is a latency optimisation, never a correctness knob: the
    served tokens match bitwise with it disabled, and the second wave
    warm-starts from the EMA that survives ``reset()`` (prefetch commits,
    misses converted to hits)."""
    a = moe_setup["mixtral-8x7b"]
    prompts = _prompts(a.cfg)
    outs, stores = [], []
    for prefetch in (True, False):
        eng = _paged_engine(a.cfg, a.params, resident_max=2,
                            prefetch=prefetch)
        wave1 = eng.generate(prompts, max_new=8)
        eng.reset()
        wave2 = eng.generate(prompts, max_new=8)
        np.testing.assert_array_equal(wave1, wave2)
        outs.append(wave2)
        stores.append(eng.expert_store)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], _untiered(a, prompts, 8))
    on, off = stores
    assert on.prefetch_commits > 0
    assert off.prefetch_commits == 0
    assert on.hit_rate() >= off.hit_rate()
    on.close()
    off.close()


def test_reset_frees_expert_extents(moe_setup):
    """``reset()`` frees paged expert extents like demoted cache tiers —
    generate→reset→generate leaves no pool orphans and still serves
    identical tokens after the cold restart."""
    a = moe_setup["deepseek-v3-671b"]
    prompts = _prompts(a.cfg)
    eng = _paged_engine(a.cfg, a.params, resident_max=2)
    first = eng.generate(prompts, max_new=5)
    assert any(n.startswith("expert:") for n in eng.pool.names())
    eng.reset()
    assert not any(n.startswith("expert:") for n in eng.pool.names())
    assert not any(t.any() for t in (eng.expert_store._wg,
                                     eng.expert_store._wu,
                                     eng.expert_store._wd))
    eng.pool.check_no_orphans()
    second = eng.generate(prompts, max_new=5)  # lazy re-register, cold start
    np.testing.assert_array_equal(first, second)
    eng.pool.check_no_orphans()
    eng.expert_store.close()


def test_paging_rejects_non_moe_and_lane_mode(moe_setup):
    dense_cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    dense_params = get_model(dense_cfg).init_params(
        torch.Generator().manual_seed(0), dense_cfg, device="cpu")
    with pytest.raises(ValueError, match="routed-MoE"):
        ServingEngine(dense_cfg, dense_params, EngineConfig(
            expert_paging=ExpertPagingConfig()))
    a = moe_setup["mixtral-8x7b"]
    eng = _paged_engine(a.cfg, a.params)
    with pytest.raises(ValueError, match="mutually exclusive"):
        eng.enable_lane_decode()
    eng.expert_store.close()


def test_bf16_slabs_enter_the_pool_as_their_bytes(moe_setup):
    """A bf16 model's expert slabs are written to the pool as the uint16
    bytes of (w_gate, w_up, w_down), raveled and concatenated; the paged
    tokens equal the untiered engine's."""
    cfg = reduced_config(get_config("mixtral-8x7b"), dtype=torch.bfloat16)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(3),
                                        cfg, device="cpu")
    prompts = _prompts(cfg)
    want = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, max_len=32)).generate(prompts, max_new=4)
    eng = _paged_engine(cfg, params, resident_max=2)
    np.testing.assert_array_equal(eng.generate(prompts, max_new=4), want)
    moe = params["layers"]["moe"]
    for layer, e in ((0, 0), (1, 3)):
        got = eng.pool.payload(expert_slab_name(layer, e))
        bytes_ = np.concatenate([
            moe[k][layer, e].contiguous().view(torch.int16).numpy()
            .view(np.uint16).ravel() for k in ("w_gate", "w_up", "w_down")])
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, bytes_)
    eng.expert_store.close()


def test_paged_autoscale_log_matches_reference(moe_setup):
    """The autoscaler's expert leg (``_readvise_experts``, with the paged
    slabs kept pinned remote in the re-advised plans): two waves under an
    autoscaler, every ``autoscale_log`` entry ``==`` the reference's and the
    tokens equal."""
    a = moe_setup["mixtral-8x7b"]
    prompts = _prompts(a.cfg)
    acfg = dict(readvise_every=2, node_capacity_bytes=64 << 10)
    P.restart_resource_names(*(P.package(n) for n in ("repro",
                                                      "repro_torch")))
    eng = _paged_engine(a.cfg, a.params, resident_max=2,
                        autoscale=AutoscaleConfig(**acfg))
    ref = _ref_paged_engine(a, resident_max=2,
                            autoscale=ref_serving.AutoscaleConfig(**acfg))
    for _ in range(2):
        np.testing.assert_array_equal(eng.generate(prompts, max_new=4),
                                      ref.generate(prompts, max_new=4))
        eng.reset()
        ref.reset()
    assert eng.autoscale_log and "expert" in eng.autoscale_log[-1]
    assert eng.autoscale_log == ref.autoscale_log
    assert eng.expert_store.pcfg.resident_max == \
        ref.expert_store.pcfg.resident_max
    eng.expert_store.close()
    ref.expert_store.close()


# -- store / pager units ----------------------------------------------------
def test_store_retarget_protects_routed_and_evicts_by_mass(moe_setup):
    a = moe_setup["deepseek-v3-671b"]
    pool = MemoryPool(2)
    store = ExpertParamStore(a.params, a.cfg, pool,
                             paging=ExpertPagingConfig(resident_max=2,
                                                       throttle=0.0))
    store.begin_step()
    store.fetch_sync(0, [0, 1, 2])
    # target = {2, 3}, but 1 was routed this step: 0 evicts, 1 survives
    store.retarget(0, [2, 3], protect={1, 2})
    store.begin_step()  # commits the prefetch of 3
    assert store.resident[0] == {1, 2, 3}
    # evicted rows are zeros again; resident rows match the real weights
    wg = store.params_view()["layers"]["moe"]["w_gate"]
    ref = a.params["layers"]["moe"]["w_gate"]
    assert not wg[0, 0].any()
    assert torch.equal(wg[0, 2], ref[0, 2])
    assert store.copy_bytes == 4 * store.slab_bytes
    store.teardown()
    pool.check_no_orphans()
    store.close()


def test_pager_ema_ranking():
    pager = ExpertPager(1, 4, decay=0.5)
    routing = {"top_i": np.array([[[[3, 1]]]]),
               "top_p": np.array([[[[0.9, 0.1]]]])}
    pager.observe(routing)
    assert pager.predict(0, 2) == [3, 1]
    # decay: a newly dominant expert overtakes after repeated observation
    routing2 = {"top_i": np.array([[[[2, 1]]]]),
                "top_p": np.array([[[[0.9, 0.1]]]])}
    for _ in range(4):
        pager.observe(routing2)
    assert pager.predict(0, 1) == [2]
    with pytest.raises(ValueError):
        ExpertPager(1, 4, decay=1.5)


# -- census + advisor -------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ["mamba2-130m", "zamba2-1.2b"])
def test_decode_state_census_matches_real_cache(arch):
    cfg = reduced_config(get_config(arch), dtype=torch.float32)
    cache = get_model(cfg).init_decode_cache(cfg, 2, 16, device="cpu")
    census = decode_state_census(cfg, 2, 16)
    for key, leaf in cache.items():
        name = f"cache[{key!r}]"
        if leaf.ndim == 0 or key == "pos":
            continue
        assert name in census, name
        assert census[name].size_bytes == leaf.numel() * leaf.element_size()
    if cfg.is_moe:
        slabs = [o for o in census if o.name.startswith("expert:")]
        n_moe = cfg.n_layers - cfg.first_k_dense
        assert len(slabs) == n_moe * cfg.n_experts
        assert all(o.pinned_remote for o in slabs)


def test_expert_slab_objects_naming():
    cfg = reduced_config(get_config("deepseek-v3-671b"), dtype=torch.float32)
    objs = expert_slab_objects(cfg)
    # layer index is MoE-relative (matches ExpertParamStore's layer axis)
    assert objs[0].name == expert_slab_name(0, 0)
    slab_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 4
    assert objs[0].size_bytes == slab_bytes
    dense = reduced_config(get_config("granite-8b"))
    assert expert_slab_objects(dense) == []


def test_advise_expert_residency_curve():
    # skewed mass: two hot experts out of eight
    mass = np.array([[8.0, 6.0, 0.5, 0.5, 0.2, 0.2, 0.1, 0.1]])
    adv = advise_expert_residency(
        mass, bytes_per_expert=1 << 20, fetch_us_per_expert=100.0,
        compute_us_per_step=1000.0, experts_per_step=2.0,
        degradation_target=0.16,
    )
    hit = [pt.hit_rate for pt in adv.curve]
    assert hit == sorted(hit) and hit[-1] == pytest.approx(1.0)
    assert adv.feasible
    assert adv.advised_resident <= 4  # the skew makes a small set enough
    # an HBM budget binds the advice even when degradation would allow more
    tight = advise_expert_residency(
        mass, bytes_per_expert=1 << 20, fetch_us_per_expert=5000.0,
        compute_us_per_step=1000.0, experts_per_step=2.0,
        degradation_target=0.0001, hbm_budget_bytes=2 << 20,
    )
    assert tight.advised_resident <= 2
    assert not tight.feasible


# -- benchmarks/fig_expert_paging.py: BENCH_pr10.json exactly ----------------
@pytest.mark.parametrize("arch,n_experts,resident_max", PG.CONFIGS,
                         ids=[c[0] for c in PG.CONFIGS])
def test_bench_pr10_reproduced(arch, n_experts, resident_max):
    """The benchmark's loop through the port, on the reference's weights
    with the router skewed as the benchmark skews it: every value of
    ``BENCH_pr10.json``'s row ``==``, and the paged waves' tokens equal the
    reference's untiered engine's too.

    The file was recorded under JAX's earlier default random bits
    (``jax_threefry_partitionable`` off; JAX 0.5 turned it on), so the
    weights and prompts are drawn with it off. Drawn with today's default,
    the reference's own loop gives other numbers (deepseek-v3 hit rate
    0.9084821428571429, mixtral-8x7b 0.9287469287469288), and the port
    gives the same ones as the reference there too."""
    with jax.threefry_partitionable(False):
        a = Arch(arch, skew=True, n_experts=n_experts, top_k=2)
        prompts = np.array(jax.random.randint(
            jax.random.PRNGKey(1), PG.PROMPT_SHAPE, 0, a.cfg.vocab_size),
            np.int32)
    row = PG.paging_row(P.package("repro_torch"), a.cfg, a.params, prompts,
                        resident_max=resident_max)
    untiered, wave1, wave2 = row.pop("tokens")
    assert row == P.committed("BENCH_pr10")["configs"][arch]
    ref_tokens = ref_serving.ServingEngine(
        a.ref_cfg, a.ref_params, ref_serving.EngineConfig(max_batch=2,
                                                          max_len=64)
    ).generate(prompts, max_new=PG.MAX_NEW)
    for toks in (untiered, wave1, wave2):
        np.testing.assert_array_equal(toks, ref_tokens)
