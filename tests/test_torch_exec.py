"""The port's streaming executor against the reference executor.

Chain data must be identical for the same seed, outputs allclose to the
reference's untiered oracle (Pallas in interpret mode), tiered and
untiered runs bit-identical inside the port, and the simulator's
predictions equal. The validation, bookkeeping and telemetry tests of
``tests/test_exec.py`` are ported with ``device="cpu"``. No wall-clock
speed is asserted here.
"""
import numpy as np
import pytest
import torch

from repro.core import exec as ref_exec
from repro.core.metadata import Tier as RefTier
from repro_torch.convert import stages_from_reference
from repro_torch.core.exec import (
    HostFetchEngine,
    StreamingExecutor,
    StreamStage,
    attention_chain,
    balanced_throttle,
    matmul_chain,
    untiered_oracle,
)
from repro_torch.core.fabric import INFINIBAND_100G
from repro_torch.core.metadata import Tier
from repro_torch.core.telemetry import Telemetry, validate_chrome_trace

CPU = "cpu"
MM = dict(m=128, k=256)
ATT = dict(seq=128, heads=4, kv_heads=2, head_dim=32)


@pytest.fixture
def mm_chain():
    return matmul_chain(4, **MM, seed=0, device=CPU)


def make_exec(stages, **kw):
    kw.setdefault("throttle", 0.0)  # no pacing: unit tests measure nothing
    kw.setdefault("device", CPU)
    return StreamingExecutor(stages, **kw)


def _same_stages(got, ref):
    assert [(s.name, s.op, s.kwargs, s.tier.value) for s in got] == \
        [(s.name, s.op, s.kwargs, s.tier.value) for s in ref]
    for g, r in zip(got, ref):
        assert g.params.keys() == r.params.keys()
        for k in g.params:
            assert g.params[k].dtype == torch.float32
            np.testing.assert_array_equal(g.params[k].numpy(), r.params[k])
        assert g.nbytes == r.nbytes


class TestChainParity:
    """Same seed, same chain — exactly."""

    @pytest.mark.parametrize("seed", [0, 3])
    def test_matmul_chain_identical(self, seed):
        got, x0 = matmul_chain(3, **MM, seed=seed, device=CPU)
        ref, rx0 = ref_exec.matmul_chain(3, **MM, seed=seed)
        _same_stages(got, ref)
        np.testing.assert_array_equal(x0.numpy(), rx0)

    @pytest.mark.parametrize("window", [None, 64])
    def test_attention_chain_identical(self, window):
        got, q0 = attention_chain(2, **ATT, window=window, seed=1, device=CPU)
        ref, rq0 = ref_exec.attention_chain(2, **ATT, window=window, seed=1)
        _same_stages(got, ref)
        np.testing.assert_array_equal(q0.numpy(), rq0)

    def test_stages_from_reference_roundtrip(self):
        ref, rx0 = ref_exec.matmul_chain(3, **MM, seed=2)
        ref[1].tier = RefTier.LOCAL
        got, x0 = stages_from_reference(ref, rx0, device=CPU)
        _same_stages(got, ref)
        assert got[1].tier is Tier.LOCAL and got[0].tier is Tier.REMOTE
        np.testing.assert_array_equal(x0.numpy(), rx0)
        ref_a, rq0 = ref_exec.attention_chain(2, **ATT, seed=2)
        got_a, q0 = stages_from_reference(ref_a, rq0, device=CPU)
        _same_stages(got_a, ref_a)
        mine, _ = attention_chain(2, **ATT, seed=2, device=CPU)
        for g, m in zip(got_a, mine):
            assert all(torch.equal(g.params[k], m.params[k]) for k in g.params)

    def test_bf16_chain_is_the_rounded_f32_draw(self):
        f32, x32 = matmul_chain(2, **MM, seed=5, device=CPU)
        bf, xbf = matmul_chain(2, **MM, seed=5, dtype=torch.bfloat16,
                               device=CPU)
        assert xbf.dtype == torch.bfloat16
        assert torch.equal(xbf, x32.to(torch.bfloat16))
        assert torch.equal(bf[1].params["w"], f32[1].params["w"].to(
            torch.bfloat16))


class TestAgainstReferenceOracle:
    """The port's output against the reference's untiered oracle."""

    def test_matmul_chain(self, mm_chain):
        stages, x0 = mm_chain
        ref, rx0 = ref_exec.matmul_chain(4, **MM, seed=0)
        want = ref_exec.untiered_oracle(ref, rx0, interpret=True)
        ex = make_exec(stages)
        ex.plan_tiers(0.0)
        got = ex.run(x0).output
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
        ex.engine.close()

    def test_attention_chain(self):
        stages, q0 = attention_chain(2, **ATT, device=CPU)
        ref, rq0 = ref_exec.attention_chain(2, **ATT)
        want = ref_exec.untiered_oracle(ref, rq0, interpret=True)
        ex = make_exec(stages)
        ex.plan_tiers(0.0)
        got = ex.run(q0).output
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        ex.engine.close()


class TestBitIdentity:
    """Streaming moves bytes, never changes math — for every config."""

    @pytest.mark.parametrize("prefetch", [True, False])
    @pytest.mark.parametrize("local_fraction", [0.0, 0.5])
    def test_matmul_chain(self, mm_chain, prefetch, local_fraction):
        stages, x0 = mm_chain
        oracle = untiered_oracle(stages, x0, device=CPU)
        ex = make_exec(stages, prefetch=prefetch)
        ex.plan_tiers(local_fraction)
        ex.warmup(x0)
        res = ex.run(x0)
        assert torch.equal(res.output, oracle)
        ex.engine.close()

    @pytest.mark.parametrize("prefetch", [True, False])
    @pytest.mark.parametrize("local_fraction", [0.0, 0.5])
    def test_attention_chain(self, prefetch, local_fraction):
        stages, q0 = attention_chain(2, **ATT, device=CPU)
        oracle = untiered_oracle(stages, q0, device=CPU)
        ex = make_exec(stages, prefetch=prefetch)
        ex.plan_tiers(local_fraction)
        ex.warmup(q0)
        res = ex.run(q0)
        assert torch.equal(res.output, oracle)
        ex.engine.close()

    def test_commit_output_roundtrip(self, mm_chain):
        stages, x0 = mm_chain
        ex = make_exec(stages, commit_output=True)
        ex.plan_tiers(0.0)
        res = ex.run(x0)
        assert ex.engine.bytes_written == res.output.numel() * 4
        ex.engine.close()


class TestSimulateParity:
    """simulate() replays the same control flow as the reference's."""

    @pytest.mark.parametrize("local_fraction", [0.0, 0.5])
    @pytest.mark.parametrize("prefetch", [True, False])
    @pytest.mark.parametrize("throttle", [0.0, 2.5])
    def test_predicted_us_equal(self, local_fraction, prefetch, throttle):
        stages, _ = matmul_chain(5, **MM, seed=0, device=CPU)
        ref, _ = ref_exec.matmul_chain(5, **MM, seed=0)
        kw = dict(throttle=throttle, commit_output=True)
        got_ex = make_exec(stages, **kw)
        ref_ex = ref_exec.StreamingExecutor(ref, interpret=True, **kw)
        got_plan = got_ex.plan_tiers(local_fraction)
        ref_plan = ref_ex.plan_tiers(local_fraction)
        assert got_plan.remote_names() == ref_plan.remote_names()
        compute = {st.name: 100.0 + 37.5 * i for i, st in enumerate(stages)}
        for commit in (0, 1 << 20):
            got = got_ex.simulate(compute_us=compute, prefetch=prefetch,
                                  commit_bytes=commit)
            want = ref_ex.simulate(compute_us=compute, prefetch=prefetch,
                                   commit_bytes=commit)
            assert got.predicted_us == want.predicted_us
            assert got.stage_stall_us == want.stage_stall_us
            assert got.fabric_name == want.fabric_name
        got_ex.engine.close()
        ref_ex.engine.close()


class TestPlacement:
    def test_plan_tiers_fractions(self, mm_chain):
        stages, _ = mm_chain
        ex = make_exec(stages)
        plan = ex.plan_tiers(0.0)
        assert len(plan.remote_names()) == len(stages)
        assert all(st.tier is Tier.REMOTE for st in ex.stages)
        plan = ex.plan_tiers(1.0)
        assert not plan.remote_names()
        assert all(st.tier is Tier.LOCAL for st in ex.stages)
        plan = ex.plan_tiers(0.5)
        assert 0 < len(plan.remote_names()) < len(stages)
        ex.engine.close()

    def test_local_stages_never_fetch(self, mm_chain):
        stages, x0 = mm_chain
        ex = make_exec(stages)
        ex.plan_tiers(1.0)
        res = ex.run(x0)
        assert ex.engine.n_ops == 0
        assert res.fetched_bytes == 0
        assert not res.stage_wait_us
        ex.engine.close()

    def test_result_bookkeeping(self, mm_chain):
        stages, x0 = mm_chain
        ex = make_exec(stages)
        ex.plan_tiers(0.0)
        res = ex.run(x0)
        assert set(res.stage_compute_us) == {st.name for st in stages}
        assert set(res.stage_wait_us) == {st.name for st in stages}
        assert res.fetched_bytes == sum(st.nbytes for st in stages)
        assert res.elapsed_us >= res.compute_us > 0
        ex.engine.close()


class TestValidation:
    def test_duplicate_stage_names(self):
        st = StreamStage("w0", "matmul", {"w": torch.zeros((8, 8))})
        with pytest.raises(ValueError, match="duplicate"):
            StreamingExecutor([st, st], device=CPU)

    def test_unknown_op(self):
        st = StreamStage("w0", "conv", {"w": torch.zeros((8, 8))})
        with pytest.raises(ValueError, match="unknown op"):
            StreamingExecutor([st], device=CPU)

    def test_negative_throttle(self):
        with pytest.raises(ValueError, match="throttle"):
            HostFetchEngine(throttle=-1.0, device=CPU)

    def test_matmul_chain_needs_square(self):
        with pytest.raises(ValueError, match="N == K"):
            matmul_chain(2, k=256, n=128, device=CPU)

    def test_balanced_throttle_needs_remote(self):
        stages, _ = matmul_chain(2, m=128, k=256, device=CPU)
        for st in stages:
            st.tier = Tier.LOCAL
        with pytest.raises(ValueError, match="no REMOTE"):
            balanced_throttle(stages, {})

    def test_engine_device_must_match(self, mm_chain):
        stages, _ = mm_chain
        eng = HostFetchEngine(throttle=0.0, device=CPU)
        eng.device = torch.device("meta")
        with pytest.raises(ValueError, match="engine moves bytes"):
            StreamingExecutor(stages, engine=eng, device=CPU)
        eng.close()

    def test_cuda_without_a_card_raises(self):
        """The entry points default to the card and never fall back."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: nothing to refuse")
        stages, x0 = matmul_chain(1, **MM, device=CPU)
        for call in (
            lambda: HostFetchEngine(),
            lambda: StreamingExecutor(stages),
            lambda: matmul_chain(1, **MM),
            lambda: attention_chain(1, **ATT),
            lambda: untiered_oracle(stages, x0),
            lambda: stages_from_reference([], np.zeros(4, np.float32)),
        ):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


class TestHostFetchEngine:
    def test_measurements_collected(self):
        eng = HostFetchEngine(throttle=0.0, device=CPU)
        host = {"w": torch.ones((64, 64))}
        out = eng.acquire(eng.fetch("obj", host))
        assert torch.equal(out["w"], host["w"])
        assert eng.measurements == [("read", 64 * 64 * 4,
                                     pytest.approx(eng.measurements[0][2]))]
        assert eng.bytes_read == 64 * 64 * 4
        eng.close()

    def test_unpaced_fetch_not_measured(self):
        eng = HostFetchEngine(throttle=0.0, device=CPU)
        eng.acquire(eng.fetch("obj", {"w": torch.ones(16)}, pace=False))
        assert eng.measurements == []
        assert eng.n_ops == 1  # still counted as traffic
        eng.close()

    def test_measure_sweep(self):
        eng = HostFetchEngine(throttle=0.0, device=CPU)
        new = eng.measure_sweep([1 << 10, 1 << 12], repeats=2)
        kinds = {k for k, _, _ in new}
        assert kinds == {"read", "write"}
        assert len(new) == 2 * 2 * 2  # sizes x repeats x kinds
        assert new == eng.measurements
        eng.close()

    def test_pace_us_scales_with_throttle(self):
        eng = HostFetchEngine(throttle=2.0, device=CPU)
        base = INFINIBAND_100G.stream_us("read", 1 << 20, eng.chunk_bytes,
                                         mode="pipelined")
        assert eng.pace_us("read", 1 << 20) == pytest.approx(2.0 * base)
        eng.throttle = 0.0
        assert eng.pace_us("read", 1 << 20) == 0.0
        eng.close()

    def test_prediction_model(self):
        eng = HostFetchEngine(throttle=4.0, device=CPU)
        assert eng.prediction_model().name == "infiniband-100g-x4"
        eng.throttle = 0.0
        assert eng.prediction_model() is eng.fabric
        eng.close()

    def test_wall_spans_recorded(self):
        tel = Telemetry()
        eng = HostFetchEngine(throttle=0.0, telemetry=tel, device=CPU)
        eng.acquire(eng.fetch("obj", {"w": torch.ones(64)}))
        spans = tel.spans_on("wall/fabric", cats=("io",))
        assert len(spans) == 1 and spans[0].name == "read"
        assert spans[0].dur_us >= 0
        eng.close()


class TestSimulate:
    def test_prefetch_beats_demand(self, mm_chain):
        stages, _ = mm_chain
        ex = make_exec(stages)
        ex.plan_tiers(0.0)
        compute = {st.name: 500.0 for st in stages}
        on = ex.simulate(compute_us=compute, prefetch=True)
        off = ex.simulate(compute_us=compute, prefetch=False)
        assert on.predicted_us < off.predicted_us
        fetch = INFINIBAND_100G.stream_us(
            "read", stages[0].nbytes, ex.engine.chunk_bytes, mode="pipelined")
        assert off.predicted_us == pytest.approx(
            sum(compute.values()) + 4 * fetch, rel=1e-6)
        assert on.predicted_us >= sum(compute.values()) + fetch
        ex.engine.close()

    def test_error_vs(self, mm_chain):
        stages, _ = mm_chain
        ex = make_exec(stages)
        ex.plan_tiers(0.0)
        rep = ex.simulate(compute_us={st.name: 100.0 for st in stages})
        assert rep.error_vs(rep.predicted_us) == 0.0
        assert rep.error_vs(rep.predicted_us / 2) == pytest.approx(1.0)
        ex.engine.close()

    def test_dual_track_trace(self, mm_chain):
        """Wall spans and sim spans land in one valid Chrome trace."""
        stages, x0 = mm_chain
        tel = Telemetry()
        ex = make_exec(stages, telemetry=tel)
        ex.plan_tiers(0.0)
        res = ex.run(x0)
        ex.simulate(compute_us=res.stage_compute_us, telemetry=tel)
        tracks = tel.tracks()
        assert "wall/exec" in tracks and "wall/fabric" in tracks
        assert "sim/exec" in tracks and "sim/fabric" in tracks
        validate_chrome_trace(tel.to_chrome_trace())
        ex.engine.close()

    def test_sim_mirrors_commit(self, mm_chain):
        stages, _ = mm_chain
        ex = make_exec(stages, commit_output=True)
        ex.plan_tiers(0.0)
        compute = {st.name: 100.0 for st in stages}
        plain = ex.simulate(compute_us=compute, commit_bytes=0)
        committed = ex.simulate(compute_us=compute, commit_bytes=1 << 20)
        assert committed.predicted_us > plain.predicted_us
        ex.engine.close()

    def test_balanced_throttle_balances(self):
        stages, _ = matmul_chain(3, m=128, k=256, device=CPU)
        compute = {st.name: 1000.0 for st in stages}
        thr = balanced_throttle(stages, compute)
        eng = HostFetchEngine(throttle=thr, device=CPU)
        assert eng.pace_us("read", stages[0].nbytes) == pytest.approx(1000.0)
        eng.close()
