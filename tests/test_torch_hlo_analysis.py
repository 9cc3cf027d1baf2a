"""The port's trace analysis (``repro_torch.launch.hlo_analysis``) against
the reference's HLO analysis and against hand counts.

* ``tests/test_hlo_analysis.py``'s four cases pointed at the port: a Python
  loop of L ``tanh(c @ w)`` layers counts ``2·M·K·K·L`` FLOPs exactly (and
  within the reference's own rel 0.25 of ``parse_module`` on its scan),
  nested loops compose, ``Collective.wire_bytes`` equals the reference's
  for its five ops at group sizes 1, 4 and 16, and an elementwise chain's
  bytes are the exact per-op sum (eager torch runs each op as a kernel, so
  the reference's fusion bound does not apply).
* Per-device counts on a (2, 4) fake mesh of 8 ranks: a split matmul, a
  replicated one, a contraction left ``Partial``, a redistribute's
  all-gather and a matmul inside ``local_call``.
* Each kernel's traced route (``repro_torch.kernels.traced``) on fake CPU
  and CUDA tensors: output shapes, FLOPs from ``kernels/work.py``, no
  launch.
* The memory tracker: a reduced train step's peak on fake tensors equals
  the same tracker's on real CPU tensors (on a mesh: ``test_torch_mesh``);
  the loss's gradient on rows split 8 ways holds no rank's copy of every
  row.
* A reduced granite-8b and mamba2-130m forward: the port's FLOPs within
  rel 0.25 of the reference's ``parse_module`` of the jitted forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.launch import hlo_analysis as REF
from repro.models import get_model as ref_get_model

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import _build, work
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import streaming_matmul as sm
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import get_model
from repro_torch.models.sharding import local_call

from _torch_dist import fake_group


def _ref_flops(fn, *args) -> float:
    return REF.parse_module(jax.jit(fn).lower(*args).compile().as_text()).flops


def test_loop_flops_exact_and_near_the_reference():
    L, M, K = 8, 32, 64

    def port(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    def ref(stacked_w, x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, stacked_w)
        return y.sum()

    a = H.analyze(port, [torch.zeros(K, K) for _ in range(L)],
                  torch.zeros(M, K))
    expect = 2 * M * K * K * L
    assert a.flops == expect
    assert a.flops == pytest.approx(
        _ref_flops(ref, jnp.zeros((L, K, K)), jnp.zeros((M, K))), rel=0.25)


def test_nested_loops_compose():
    M = K = 32

    def port(w, x):
        for _ in range(3):
            for _ in range(4):
                x = torch.tanh(x @ w)
        return x.sum()

    def ref(w, x):
        def outer(c, _):
            def inner(cc, _):
                return jnp.tanh(cc @ w), None
            c, _ = jax.lax.scan(inner, c, None, length=4)
            return c, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y.sum()

    a = H.analyze(port, torch.zeros(K, K), torch.zeros(M, K))
    assert a.flops == 2 * M * K * K * 12
    assert a.flops == pytest.approx(
        _ref_flops(ref, jnp.zeros((K, K)), jnp.zeros((M, K))), rel=0.25)


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
@pytest.mark.parametrize("group", [1, 4, 16])
def test_collective_wire_estimates(op, group):
    got = H.Collective(op=op, result_bytes=1000, group_size=group,
                       computation="e").wire_bytes
    want = REF.Collective(op=op, result_bytes=1000, group_size=group,
                          computation="e").wire_bytes
    assert got == want


def test_bytes_are_the_per_op_sum():
    """The reference holds ``tanh(x * 2 + 1).sum()`` under 4 x its input's
    bytes (XLA fuses the chain). Eager torch runs mul, add and tanh each as
    a kernel reading and writing the whole array, and sum reads it: the
    count is exactly that sum, and bytes_min keeps the reduction only."""
    n = 256 * 256 * 4
    a = H.analyze(lambda x: torch.tanh(x * 2 + 1).sum(),
                  torch.zeros(256, 256))
    assert a.bytes == 3 * 2 * n + n + 4
    assert a.bytes_min == n + 4
    assert a.flops == 0


# -- per device, on a (2, 4) fake mesh -----------------------------------------

@pytest.fixture
def mesh24():
    from torch.distributed.device_mesh import init_device_mesh

    with fake_group(8):
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


def _dt(tracer, mesh, shape, placements, dtype=torch.float32):
    """A DTensor of global ``shape`` whose local shard (rank 0's) is a fake
    tensor of its own."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    with tracer:
        return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                                  placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


GLOBAL = 2 * 64 * 128 * 256  # a (64, 128) @ (128, 256) product


@pytest.mark.parametrize("case,xp,wp,share", [
    ("split", (Shard(0), Replicate()), (Replicate(), Shard(1)), 8),
    ("replicated", (Replicate(), Replicate()), (Replicate(), Replicate()), 1),
    ("partial", (Replicate(), Shard(1)), (Replicate(), Shard(0)), 4),
])
def test_dtensor_matmul_counts_one_rank(mesh24, case, xp, wp, share):
    """A matmul on DTensors counts the rank's local product: split rows and
    columns over 2 x 4 ranks an eighth, a replicated one the whole, a
    contraction split over ``model`` (4) a quarter, left ``Partial``."""
    tr = H.Tracer()
    x = _dt(tr, mesh24, (64, 128), xp)
    w = _dt(tr, mesh24, (128, 256), wp)
    out = {}
    a = H.analyze(lambda x, w: out.setdefault("y", x @ w), x, w)
    assert a.flops == GLOBAL / share
    assert a.global_flops == GLOBAL
    assert not a.collectives
    if case == "partial":
        assert out["y"].placements == (Replicate(), Partial())


def test_redistribute_counts_the_all_gather(mesh24):
    """Rows split over ``data`` (2) gathered whole: one all-gather in a
    group of 2, its result the whole (64, 128) float32 on each rank."""
    tr = H.Tracer()
    x = _dt(tr, mesh24, (64, 128), (Shard(0), Replicate()))
    a = H.analyze(lambda x: x.redistribute(mesh24, (Replicate(),
                                                    Replicate())), x)
    assert [(c.op, c.group_size, c.result_bytes) for c in a.collectives] == [
        ("all-gather", 2, 64 * 128 * 4)]
    assert a.by_collective == {"all-gather": 64 * 128 * 4}
    assert a.collective_wire_bytes == 64 * 128 * 4 / 2


def test_local_call_counts_the_local_op(mesh24):
    """Inside ``local_call`` the op runs on each rank's shards as they
    are: rows split 2 ways and columns 4 ways, an eighth of the product."""
    tr = H.Tracer()
    x = _dt(tr, mesh24, (64, 128), (Shard(0), Replicate()))
    w = _dt(tr, mesh24, (128, 256), (Replicate(), Shard(1)))
    a = H.analyze(lambda x, w: local_call(
        "mm", torch.matmul, (x, w), ((Shard(0), Replicate()),
                                     (Replicate(), Shard(1))),
        (Shard(0), Shard(1)), mesh24), x, w)
    assert a.flops == GLOBAL / 8
    assert a.per_computation["aten.mm"]["count"] == 1


# -- the kernels' traced routes --------------------------------------------------

@pytest.fixture
def no_launch(monkeypatch):
    """Loading a kernel library (the first step of every launch) fails."""
    def refuse(*_a, **_k):
        raise AssertionError("a traced call reached a kernel launch")

    monkeypatch.setattr(_build, "load", refuse)
    counts = (sm.LAUNCHES, fa.LAUNCHES, ssd.LAUNCHES)
    yield
    assert (sm.LAUNCHES, fa.LAUNCHES, ssd.LAUNCHES) == counts


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_b1_traced_route(no_launch, device):
    M, K, N = 64, 96, 100  # N padded to 104 for the kernel
    tr = H.Tracer()
    with tr:
        x = torch.empty(M, K, dtype=torch.bfloat16, device=device)
        w = torch.empty(K, N, dtype=torch.bfloat16, device=device)
    out = {}
    a = H.analyze(lambda x, w: out.setdefault(
        "y", sm.streaming_matmul(x, w, block_m=64, block_n=100,
                                 block_k=96)), x, w)
    assert tuple(out["y"].shape) == (M, N)
    assert out["y"].device.type == device
    Np = sm.padded_columns(N, torch.bfloat16)
    assert a.flops == work.matmul_work(M, Np, K, 2)[0]
    assert a.launches("repro_torch.b1_matmul") == 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("window", [None, 24])
def test_b2_traced_route(no_launch, device, window):
    B, H_, KV, S, D = 2, 8, 2, 64, 32
    tr = H.Tracer()
    with tr:
        q = torch.empty(B, H_, S, D, dtype=torch.bfloat16, device=device)
        k = torch.empty(B, KV, S, D, dtype=torch.bfloat16, device=device)
    out = {}
    a = H.analyze(lambda q, k: out.setdefault("o", fa._launch(
        q, k, k, causal=True, window=window, scale=0.1, with_lse=True)),
        q, k)
    o, lse = out["o"]
    assert tuple(o.shape) == (B, H_, S, D) and o.stride(1) == D
    assert tuple(lse.shape) == (B, H_, S) and lse.dtype == torch.float32
    assert a.flops == work.flash_work(B, H_, S, S, KV, D, D, causal=True,
                                      window=window, itemsize=2)[0]
    assert a.launches("repro_torch.b2_flash") == 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_b3_traced_route(no_launch, device):
    B, H_, nc, Q, P, N = 2, 4, 3, 16, 8, 12
    tr = H.Tracer()
    with tr:
        xc = torch.empty(B, H_, nc, Q, P, device=device)
        bc = torch.empty(B, H_, nc, Q, N, device=device)
        dt = torch.empty(B, H_, nc, Q, device=device)
    out = {}
    a = H.analyze(lambda xc, bc, dt: out.setdefault(
        "y", ssd.ssd_chunk_scan_gpu(xc, bc, bc, dt, dt)), xc, bc, dt)
    assert tuple(out["y"].shape) == (B, H_, nc, Q, P)
    assert a.flops == work.ssd_work(B, H_, nc, Q, P, N)[0]
    assert a.launches("repro_torch.b3_scan") == 1
    # the launch's scratch (each chunk's state) is allocated and counted
    scratch = B * H_ * nc * P * N * 4
    assert a.memory["temp_bytes"] >= scratch


def test_b2_traced_backward_is_the_plain_one(no_launch):
    """Under autograd the traced forward is one B2 op and its backward one
    op of B2's backward kernels, as on the card: no plain blocked backward
    (its matmuls) is traced, and the trace counts the kernels'
    operations."""
    tr = H.Tracer()
    with tr:
        q = torch.empty(1, 4, 64, 16, requires_grad=True)
        k = torch.empty(1, 2, 64, 16, requires_grad=True)
    a = H.analyze(lambda q, k: torch.autograd.grad(
        fa.flash_attention_gpu(q, k, k, block_q=64, block_k=64).sum(),
        (q, k)), q, k)
    assert a.launches("repro_torch.b2_flash") == 1
    assert a.launches("repro_torch.b2_flash_bwd") == 1
    assert "aten.bmm" not in a.per_computation
    assert a.flops == sum(f(1, 4, 64, 64, 2, 16, 16, causal=True,
                            window=None, itemsize=4)[0]
                          for f in (work.flash_work, work.flash_bwd_work))


def test_loss_gradient_holds_no_global_rows():
    """``cross_entropy``'s gradient on (8, 1) (rows split 8 ways): no rank
    holds the logits of every row. DTensor's ``gather`` backward made its
    zeros at the global shape on each rank, the cause of the dry-run's
    train peaks rising when a second pod halved each rank's rows."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.sharding import use_mesh

    B, S, V = 64, 16, 256
    with fake_group(8):
        mesh = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data",
                                                               "model"))
        tr = H.Tracer()
        logit = _dt(tr, mesh, (B, S, V), (Shard(0), Replicate()))
        labels = _dt(tr, mesh, (B, S), (Shard(0), Replicate()),
                     torch.int32)
        with use_mesh(mesh):
            a = H.analyze(lambda lg, y: torch.autograd.grad(
                cross_entropy(lg, y), lg), logit.requires_grad_(), labels)
    assert a.memory["peak_bytes_est"] < B * S * V * 4


def test_loss_holds_no_whole_vocabulary():
    """C8: ``cross_entropy`` and its gradient on logits split 8 ways by
    vocabulary, (1, 8): each rank reduces its own slice, so its peak stays
    below one whole-vocabulary float32 copy of the logits (gathering the
    vocabulary first, as the loss did before, costs at least one)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.sharding import use_mesh

    B, S, V = 8, 16, 2048
    with fake_group(8):
        mesh = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data",
                                                               "model"))
        tr = H.Tracer()
        logit = _dt(tr, mesh, (B, S, V), (Replicate(), Shard(2)))
        labels = _dt(tr, mesh, (B, S), (Replicate(), Replicate()),
                     torch.int32)
        with use_mesh(mesh):
            a = H.analyze(lambda lg, y: torch.autograd.grad(
                cross_entropy(lg, y), lg), logit.requires_grad_(), labels)
    assert a.memory["peak_bytes_est"] < B * S * V * 4
    assert sum(c.op == "all-reduce" for c in a.collectives) >= 3


# -- memory and whole models ------------------------------------------------------

def _plain_routes(monkeypatch):
    """Every kernel wrapper takes its CPU route on fake tensors too: the
    same ops as on real CPU tensors."""
    import repro_torch.core.exec as ex
    import repro_torch.models.flash as mflash

    for mod in (sm, fa, ssd, mflash, ex):
        monkeypatch.setattr(mod, "is_traced", lambda *_t: False)


def test_memory_tracker_fake_equals_real(monkeypatch):
    """One reduced granite-8b train step (float32, remat full): the peak,
    argument and output bytes of the fake trace are the tracker's on real
    CPU tensors (the same code, the same lifetimes)."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step

    _plain_routes(monkeypatch)
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, TrainStepConfig(), opt_cfg)

    def state(gen):
        params = get_model(cfg).init_params(gen, cfg, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                               dtype=torch.int32)
        return params, adamw_init(opt_cfg, params), {"tokens": tokens,
                                                     "labels": tokens}

    real = H.measure_memory(step, *state(torch.Generator().manual_seed(0)))
    tr = H.Tracer()
    with tr:
        fake_args = state(torch.Generator().manual_seed(0))
    fake = H.analyze(step, *fake_args).memory
    assert fake == real
    assert real["temp_bytes"] > 0 and real["peak_bytes_est"] > (
        real["argument_bytes"])


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-130m"])
def test_reduced_forward_flops_near_the_reference(arch):
    B, S = 2, 64
    rcfg = ref_reduced_config(ref_get_config(arch), dtype=jnp.float32)
    model = ref_get_model(rcfg)
    rparams = model.init_params(jax.random.PRNGKey(0), rcfg)
    rbatch = {"tokens": jnp.zeros((B, S), jnp.int32),
              "labels": jnp.zeros((B, S), jnp.int32)}
    ref = _ref_flops(lambda p, b: model.forward(p, b, rcfg)[0], rparams,
                     rbatch)
    cfg = reduced_config(get_config(arch), dtype=torch.float32)
    tr = H.Tracer()
    with tr:
        params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                            cfg, device="cpu")
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
                 "labels": torch.zeros((B, S), dtype=torch.int32)}
    with torch.no_grad():
        a = H.analyze(lambda p, b: get_model(cfg).forward(p, b, cfg)[0],
                      params, batch)
    assert a.flops == pytest.approx(ref, rel=0.25)
    kernel = "b3_scan" if arch == "mamba2-130m" else "b2_flash"
    assert a.launches(f"repro_torch.{kernel}") == cfg.n_layers
    assert np.isfinite(a.bytes) and a.bytes_min <= a.bytes
