"""B3 under autograd: the fused SSD scan on a card is differentiable through
``_B3Function`` (the kernels forward, the plain staged scan's VJP
backward), and the ssm and hybrid families train through it.

There is no card here: ``_on_cuda`` and ``_launch`` are replaced by the
plain staged scan run without grad (the kernels' plain version), so the
Function's forward and backward run as on the card. Its gradients must be
``torch.equal`` to plain autograd's through the same scan, for
``ops.ssd``, through ``ssm_block``, and in the reduced mamba2-130m and
zamba2-1.2b train steps; the three per-stage entry points still refuse a
grad-requiring input."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.tiering import map_leaves
from repro_torch.kernels import ops, ssd_scan
from repro_torch.models import ssm
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import (
    TrainStepConfig,
    init_train_state,
    make_train_step,
)

from _torch_model_parity import one_torch_thread  # noqa: F401


class _FakeCard:
    """``ssd_scan`` as on a card: every scan goes through ``_B3Function``,
    whose launches run the plain staged scan without grad and are
    counted."""

    def __init__(self, monkeypatch):
        self.launches = 0

        def launch(*chunks):
            self.launches += 1
            with torch.no_grad():
                return ssd_scan.ssd_staged_plain(*chunks)

        monkeypatch.setattr(ssd_scan, "_on_cuda", lambda what, t: True)
        monkeypatch.setattr(ssd_scan, "_launch", launch)


def _graph_nodes(t: torch.Tensor) -> set[str]:
    """The class names of every node of ``t``'s backward graph."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _ssd_inputs(seed=0, Bn=2, L=64, H=4, P=8, G=2, N=8):
    rng = np.random.default_rng(seed)
    xh, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((Bn, L, H, P), (Bn, L, G, N), (Bn, L, G, N)))
    dt = torch.from_numpy(rng.random((Bn, L, H)).astype(np.float32))
    A = -torch.from_numpy(rng.random(H).astype(np.float32)) - 0.5
    dy = torch.from_numpy(rng.standard_normal((Bn, L, H, P)).astype(
        np.float32))
    return [xh, Bm, Cm, dt, A], dy


def _ssd_grads(inputs, dy):
    ins = [t.clone().requires_grad_(True) for t in inputs]
    y = ops.ssd(*ins, chunk=16)
    return y, torch.autograd.grad(y, ins, dy)


def test_ops_ssd_grads_equal_plain_autograd(monkeypatch):
    """x, B, C, dt and A through ``ops.ssd_prep`` and the Function: y has a
    grad_fn that is the Function's, and every gradient equals plain
    autograd's through the staged scan."""
    inputs, dy = _ssd_inputs()
    y_plain, want = _ssd_grads(inputs, dy)
    card = _FakeCard(monkeypatch)
    y, got = _ssd_grads(inputs, dy)
    assert "_B3FunctionBackward" in _graph_nodes(y)
    assert "_B3FunctionBackward" not in _graph_nodes(y_plain)
    assert card.launches == 1
    assert torch.equal(y, y_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_backward_takes_only_the_grads_asked_for(monkeypatch):
    """Only the inputs that require grad get one; no launch without grad."""
    chunks = ops.ssd_prep(*_ssd_inputs()[0], chunk=16)
    card = _FakeCard(monkeypatch)
    xc = chunks[0].clone().requires_grad_(True)
    y = ssd_scan.ssd_chunk_scan_gpu(xc, *chunks[1:])
    (gx,) = torch.autograd.grad(y.sum(), [xc])
    xp = chunks[0].clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        ssd_scan.ssd_staged_plain(xp, *chunks[1:]).sum(), [xp])
    assert torch.equal(gx, want)
    with torch.no_grad():
        out = ssd_scan.ssd_chunk_scan_gpu(xc, *chunks[1:])
    assert out.grad_fn is None and card.launches == 2


def test_ssm_block_grads_equal_plain_autograd(monkeypatch):
    """The Mamba2 block of reduced mamba2-130m: the gradients of its
    parameters and input through the Function equal plain autograd's."""
    cfg = reduced_config(get_config("mamba2-130m"), dtype=torch.float32)
    params = map_leaves(lambda _k, t: t[0], ssm.ssm_init(
        torch.Generator().manual_seed(0), cfg, stack=1))
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def grads():
        leaves = {k: t.clone().requires_grad_(True)
                  for k, t in _leaves_with_keys(params)}
        xr = x.clone().requires_grad_(True)
        p = map_leaves(lambda k, _t: leaves[k], params)
        y = ssm.ssm_block(p, xr, cfg)
        return y, torch.autograd.grad((y * y).sum(), [xr, *leaves.values()])

    y_plain, want = grads()
    card = _FakeCard(monkeypatch)
    y, got = grads()
    assert card.launches == 1 and torch.equal(y, y_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch,remat,launches", [
    ("mamba2-130m", "full", 4),     # 2 layers, each forward and recompute
    ("mamba2-130m", "none", 2),
    ("zamba2-1.2b", "full", 8),     # 4 layers
])
def test_train_step_on_the_card_path_equals_the_cpu_path(
        monkeypatch, arch, remat, launches):
    """One train step of the reduced config: the loss, every updated
    parameter and moment ``torch.equal`` to the CPU path's; the scan
    launched once a layer forward and once more a recompute."""
    cfg = reduced_config(get_config(arch), dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step_cfg = TrainStepConfig(remat=remat)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}

    def one_step():
        p, o = init_train_state(torch.Generator().manual_seed(0), cfg,
                                step_cfg, opt_cfg, device="cpu")
        p, o, m = make_train_step(cfg, step_cfg, opt_cfg)(p, o, batch)
        return m["loss"], dict(_leaves_with_keys({"p": p, "o": o}))

    want_loss, want = one_step()
    card = _FakeCard(monkeypatch)
    loss, got = one_step()
    assert card.launches == launches
    assert torch.equal(loss, want_loss)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_stage_entry_points_still_refuse_grad_on_a_card(monkeypatch):
    """The per-stage kernels serve the stage checks, not the models: a
    grad-requiring input raises, naming the fused scan."""
    xc, bc, cc, dtc, cum = ops.ssd_prep(*_ssd_inputs()[0], chunk=16)
    monkeypatch.setattr(ssd_scan, "_on_cuda", lambda what, t: True)
    xr = xc.clone().requires_grad_(True)
    states = ssd_scan.ssd_chunk_state_plain(xc, bc, dtc, cum)
    for call in (lambda: ssd_scan.ssd_chunk_state_gpu(xr, bc, dtc, cum),
                 lambda: ssd_scan.ssd_state_passing_gpu(
                     states.requires_grad_(True), cum),
                 lambda: ssd_scan.ssd_chunk_output_gpu(xr, bc, cc, dtc, cum,
                                                       states)):
        with pytest.raises(NotImplementedError, match="fused scan"):
            call()


def test_grads_stay_finite_where_a_chunk_decays_past_float32():
    """ROADMAP C7: at chunk 256 with the reference test's distributions a
    chunk's decay passes e^88, so ``exp(cum_i - cum_j)`` of the masked
    j > i overflows. The reference's chunked scan takes the exp before the
    mask and its dt and A gradients are NaN there; the port's plain stage
    masks first, so its gradients are finite and match autograd through
    the O(L) recurrence (``kernels.ref.ssd_ref``, whose decays never
    exceed 1) at 1e-4 of each gradient's largest element, the training
    tests' gradient bound (A's, a sum over all 1024 positions, measured
    at 1.6e-5)."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models.ssm import _ssd_scan as ref_ssd_scan
    from repro_torch.kernels.ref import ssd_ref

    rng = np.random.default_rng(0)
    Bn, L, H, P, G, N = 1, 512, 2, 8, 1, 8
    arrs = [rng.standard_normal((Bn, L, H, P)),
            0.5 * rng.standard_normal((Bn, L, G, N)),
            0.5 * rng.standard_normal((Bn, L, G, N)),
            np.log1p(np.exp(rng.standard_normal((Bn, L, H)))),
            -np.exp(0.5 * rng.standard_normal(H))]
    arrs = [a.astype(np.float32) for a in arrs]
    ref_cfg = ref_reduced_config(ref_get_config("mamba2-130m"), ssm_chunk=256,
                                 ssm_state=N)
    ref_grads = jax.grad(lambda *a: ref_ssd_scan(*a, ref_cfg)[0].sum(),
                         argnums=(0, 1, 2, 3, 4))(*arrs)
    assert np.isnan(np.asarray(ref_grads[3])).any()   # the reference's dt

    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = torch.autograd.grad(ops.ssd(*ins, chunk=256).sum(), ins)
    y = ssd_ref(*ops.ssd_prep(*ins, chunk=256))
    want = torch.autograd.grad(y.sum(), ins)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
