"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU the wrappers compute their plain PyTorch versions; the reference
runs its Pallas kernels in interpret mode. Same numpy inputs, the
reference's shapes and tolerances (``tests/test_kernels.py``). The one test
marked ``cuda`` holds the CUDA kernels against the plain versions on a card
and skips without one; it needs no JAX, so on a machine with a card and no
JAX it runs alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref
    from repro.kernels.flash_attention import flash_attention_tpu
    from repro.kernels.ssd_scan import ssd_chunk_scan_tpu
    from repro.kernels.streaming_matmul import streaming_matmul as ref_matmul
    from repro.models.flash import flash_attention as jnp_flash
    import jax
except ModuleNotFoundError:  # a card's machine without JAX: cuda test only
    jnp = None

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as pt_ssd
from repro_torch.kernels import streaming_matmul as pt_sm

DTYPES = {"float32": ("float32", torch.float32),
          "bfloat16": ("bfloat16", torch.bfloat16)}
MATMUL_SHAPES = [(128, 256, 128), (256, 512, 256), (128, 1024, 384),
                 (384, 256, 512)]
FLASH_CASES = [  # B, H, KV, Sq, Sk, D, Dv, causal, window
    (1, 4, 2, 128, 128, 32, 32, True, None),
    (2, 4, 1, 128, 128, 32, 16, True, 64),     # MQA + SWA + MLA-dv
    (1, 2, 2, 128, 256, 32, 32, False, None),  # cross attention
    (1, 8, 4, 256, 256, 64, 64, True, None),
]
SSD_CASES = [(L, chunk, G) for L, chunk in ((64, 32), (128, 32), (256, 64))
             for G in (1, 2)]  # TestSSDKernel's; B 2, H 4, P 32, N 32
# and one chunk (nc = 1), and L < chunk (Q = 16)
SSD_STAGED_CASES = SSD_CASES + [(32, 32, 1), (16, 32, 2)]


@pytest.fixture(autouse=True)
def _reference_present(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs the JAX reference package")


def _pair(rng, shape, dtype_name):
    """The same values as a jax array and a torch CPU tensor."""
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 0.5)])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_matmul_matches_reference_kernel(M, K, N, dtype, tol):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (M, K), dtype)
    wj, wt = _pair(rng, (K, N), dtype)
    want = ref_matmul(xj, wj, block_m=128, block_n=128, block_k=128,
                      interpret=True)
    got = ops.matmul(xt, wt, block_m=128, block_n=128, block_k=128)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_matmul_single_k_block():
    x = torch.ones((128, 128))
    got = pt_sm.streaming_matmul(x, torch.eye(128), block_m=128, block_n=128,
                                 block_k=128)
    np.testing.assert_allclose(got.numpy(), x.numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,Dv,causal,window", FLASH_CASES)
def test_flash_matches_reference_kernel(B, H, KV, Sq, Sk, D, Dv, causal,
                                        window, dtype, tol):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (B, H, Sq, D), dtype)
    kj, kt = _pair(rng, (B, KV, Sk, D), dtype)
    vj, vt = _pair(rng, (B, KV, Sk, Dv), dtype)
    want = flash_attention_tpu(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    got = pt_fa.flash_attention_gpu(qt, kt, vt, causal=causal, window=window,
                                    block_q=64, block_k=64)
    assert got.shape == (B, H, Sq, Dv) and got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_reference_oracles(dtype):
    """kernels/ref.py against repro.kernels.ref, element for element."""
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (64, 96), dtype)
    wj, wt = _pair(rng, (96, 32), dtype)
    # float32: the two frameworks sum the K products in different orders
    # (about K * eps); bf16: one rounding of the output or the scores
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(ref.matmul_ref(xt, wt)),
                               _np(ref_ref.matmul_ref(xj, wj)),
                               atol=tol, rtol=tol)
    qj, qt = _pair(rng, (2, 4, 64, 16), dtype)
    kj, kt = _pair(rng, (2, 2, 64, 16), dtype)
    vj, vt = _pair(rng, (2, 2, 64, 8), dtype)
    for causal, window in ((True, None), (True, 16), (False, None)):
        np.testing.assert_allclose(
            _np(ref.flash_ref(qt, kt, vt, causal=causal, window=window)),
            _np(ref_ref.flash_ref(qj, kj, vj, causal=causal, window=window)),
            atol=tol, rtol=tol)


def test_ops_attention_layout_roundtrip():
    """ops.attention matches the models-layer flash (same layout contract)."""
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (2, 128, 4, 32), "float32")
    kj, kt = _pair(rng, (2, 128, 2, 32), "float32")
    vj, vt = _pair(rng, (2, 128, 2, 32), "float32")
    got = ops.attention(qt, kt, vt, block_q=64, block_k=64)
    assert got.shape == (2, 128, 4, 32)
    np.testing.assert_allclose(_np(got), np.asarray(jnp_flash(qj, kj, vj,
                                                              block_k=64)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np(got), np.asarray(ref_ops.attention(qj, kj, vj, block_q=64,
                                               block_k=64, interpret=True)),
        atol=2e-5, rtol=2e-5)


def _ssd_chunks(rng, L, chunk, G, B=2, H=4, P=32, N=32):
    """TestSSDKernel's distributions through the reference's prep
    (``kernels/ops.py``), in numpy: the SSD kernel's five float32 inputs."""
    xh = rng.standard_normal((B, L, H, P)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)) * 0.5)).astype(np.float32)
    Q = min(chunk, L)

    def chunked(t):
        return np.ascontiguousarray(
            np.moveaxis(t.reshape(B, L // Q, Q, *t.shape[2:]), 3, 1))

    rep = H // G
    return (chunked(xh), chunked(np.repeat(Bm, rep, axis=2)),
            chunked(np.repeat(Cm, rep, axis=2)), chunked(dt),
            np.cumsum(chunked(dt * A), axis=-1, dtype=np.float32))


@pytest.mark.parametrize("L,chunk,G", SSD_CASES)
def test_ssd_matches_reference_kernel(L, chunk, G):
    chunks = _ssd_chunks(np.random.default_rng(6), L, chunk, G)
    want = ssd_chunk_scan_tpu(*[jnp.asarray(a) for a in chunks],
                              interpret=True)
    got = pt_ssd.ssd_chunk_scan_gpu(*[torch.from_numpy(a) for a in chunks])
    assert got.shape == chunks[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("L,chunk,G", SSD_STAGED_CASES)
def test_ssd_staged_plain_matches_one_loop_oracle(L, chunk, G):
    """The three plain stages (the CUDA kernels' layout: chunk states,
    state passing, chunk output) composed against the one-loop oracle, to
    float32 rounding; the CPU path of the scan is that composition."""
    chunks = [torch.from_numpy(a) for a in _ssd_chunks(
        np.random.default_rng(8), L, chunk, G)]
    want = pt_ssd.ssd_chunk_scan_plain(*chunks)
    got = pt_ssd.ssd_staged_plain(*chunks)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    assert torch.equal(pt_ssd.ssd_chunk_scan_gpu(*chunks), got)
    xc, bc, cc, dtc, cum = chunks
    states = pt_ssd.ssd_chunk_state_gpu(xc, bc, dtc, cum)
    assert states.shape == (*xc.shape[:3], xc.shape[-1], bc.shape[-1])
    entering, final = pt_ssd.ssd_state_passing_gpu(states, cum)
    assert not entering[:, :, 0].any()  # the first chunk enters with zero
    for c in range(1, xc.shape[2]):  # chunk c enters with the state after c-1
        assert torch.equal(entering[:, :, c], pt_ssd.ssd_state_passing_plain(
            states[:, :, :c], cum[:, :, :c])[1])
    assert torch.equal(
        pt_ssd.ssd_chunk_output_gpu(xc, bc, cc, dtc, cum, entering), got)


def test_ssd_stages_count_nothing_on_the_cpu():
    s0, st0 = pt_ssd.LAUNCHES, dict(pt_ssd.STAGE_LAUNCHES)
    chunks = [torch.from_numpy(a) for a in _ssd_chunks(
        np.random.default_rng(9), 64, 32, 1)]
    xc, bc, cc, dtc, cum = chunks
    entering, _ = pt_ssd.ssd_state_passing_gpu(
        pt_ssd.ssd_chunk_state_gpu(xc, bc, dtc, cum), cum)
    pt_ssd.ssd_chunk_output_gpu(xc, bc, cc, dtc, cum, entering)
    pt_ssd.ssd_chunk_scan_gpu(*chunks)
    assert pt_ssd.LAUNCHES == s0 and pt_ssd.STAGE_LAUNCHES == st0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 0.6)])
def test_matmul_grads_match_reference_vjp(dtype, tol):
    """The port's backward (``_StreamingMatmul``) against ``jax.grad``
    through the reference's custom VJP on the same inputs, with
    ``TestKernelGrads``' loss, scaling and tolerances."""
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (128, 256), dtype)
    wj, wt = _pair(rng, (256, 128), dtype)

    def loss_ref(x, w):
        y = ref_matmul(x, w, block_m=128, block_n=128, block_k=128,
                       interpret=True)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    rx, rw = jax.grad(loss_ref, argnums=(0, 1))(xj, wj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    y = pt_sm.streaming_matmul(xt, wt, block_m=128, block_n=128, block_k=128)
    (y.float() ** 2).sum().backward()
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    np.testing.assert_allclose(_np(xt.grad) / 256, _np(rx) / 256, atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_np(wt.grad) / 256, _np(rw) / 256, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES + [(4096, 4096, 4096)])
def test_matmul_variant_rule(M, K, N):
    """bf16 takes the tensor-core kernel, float32 the CUDA-core one; a bf16
    K that is no whole number of 16-byte units goes to the CUDA cores."""
    assert pt_sm._variant(torch.bfloat16, K, N) == "wgmma"
    assert pt_sm._variant(torch.float32, K, N) == "ffma"
    assert pt_sm._variant(torch.bfloat16, K + 4, N) == "ffma"


@pytest.mark.parametrize("N,dtype,want", [
    (100, torch.bfloat16, 104), (104, torch.bfloat16, 104),
    (1, torch.bfloat16, 8), (100, torch.float32, 100),
    (101, torch.float32, 104), (4096, torch.bfloat16, 4096)])
def test_matmul_pads_columns_to_whole_vectors(N, dtype, want):
    """The CUDA kernels compute w's columns padded with zeros to whole
    16-byte units (ROADMAP C5: a bf16 backward's dx = g @ w^T has N = K,
    which may be any width). Each output column reads its own column of w
    alone, so the first N columns are the product. A bf16 product whose K
    is whole 16-byte units then takes the tensor cores at any N."""
    assert pt_sm.padded_columns(N, dtype) == want
    if dtype == torch.bfloat16:
        assert pt_sm._variant(dtype, 128, want) == "wgmma"


@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,Dv,causal,window",
                         FLASH_CASES + [(1, 32, 8, 4096, 4096, 128, 128, True,
                                         None)])
def test_flash_variant_rule(B, H, KV, Sq, Sk, D, Dv, causal, window):
    """Every reference case and the full-width shape: bf16 takes the
    tensor-core kernel, float32 the CUDA-core one; head dims that are no
    multiple of 16, or a Dv above 128, go to the CUDA-core kernel (which
    raises above D 192 or Dv 128)."""
    assert pt_fa._variant(torch.bfloat16, D, Dv) == "wgmma"
    assert pt_fa._variant(torch.float32, D, Dv) == "ffma"
    assert pt_fa._variant(torch.bfloat16, D + 8, Dv) == "ffma"
    assert pt_fa._variant(torch.bfloat16, D, 144) == "ffma"


def test_build_target_tracks_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named after its source and every shared
    ``csrc/*.cuh`` header, so an edited header rebuilds it."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert _build._target("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k").name.startswith("k-")


def test_cpu_path_counts_no_variant():
    m0, f0 = dict(pt_sm.VARIANT_LAUNCHES), dict(pt_fa.VARIANT_LAUNCHES)
    x = torch.ones((128, 128), dtype=torch.bfloat16, requires_grad=True)
    pt_sm.streaming_matmul(x, x.detach()).float().sum().backward()
    q = torch.ones((1, 2, 64, 32), dtype=torch.bfloat16)
    pt_fa.flash_attention_gpu(q, q, q)
    assert pt_sm.VARIANT_LAUNCHES == m0 and pt_fa.VARIANT_LAUNCHES == f0


class TestShapeValidation:
    """Non-tile-divisible shapes fail fast, naming the offending dim."""

    def test_matmul_bad_k(self):
        with pytest.raises(ValueError, match=r"K=300.*block size 128"):
            pt_sm.streaming_matmul(torch.ones((128, 300)),
                                   torch.ones((300, 128)), block_m=128,
                                   block_n=128, block_k=128)

    def test_matmul_bad_m(self):
        with pytest.raises(ValueError, match=r"M=100"):
            pt_sm.streaming_matmul(torch.ones((100, 256)),
                                   torch.ones((256, 128)), block_m=64,
                                   block_n=128, block_k=128)

    def test_matmul_k_mismatch(self):
        with pytest.raises(ValueError, match="contracting dims"):
            pt_sm.streaming_matmul(torch.ones((128, 256)),
                                   torch.ones((128, 256)))

    def test_flash_bad_sq(self):
        q = torch.ones((1, 4, 100, 32))
        k = torch.ones((1, 2, 128, 32))
        with pytest.raises(ValueError, match=r"Sq=100"):
            pt_fa.flash_attention_gpu(q, k, k, block_q=64, block_k=64)

    def test_flash_bad_gqa_group(self):
        q = torch.ones((1, 3, 128, 32))
        k = torch.ones((1, 2, 128, 32))
        with pytest.raises(ValueError, match="GQA group size"):
            pt_fa.flash_attention_gpu(q, k, k, block_q=64, block_k=64)

    def test_ssd_bad_shapes(self):
        x, b = torch.ones((1, 2, 3, 16, 8)), torch.ones((1, 2, 3, 16, 4))
        d = torch.ones((1, 2, 3, 16))
        with pytest.raises(ValueError, match=r"expected xc \(B,H,nc,Q,P\)"):
            pt_ssd.ssd_chunk_scan_gpu(x[0], b, b, d, d)
        with pytest.raises(ValueError, match="bc .* and cc"):
            pt_ssd.ssd_chunk_scan_gpu(x, b, b[:, :, :, :8], d, d)
        with pytest.raises(ValueError, match="bc .* and cc"):
            pt_ssd.ssd_chunk_scan_gpu(x, b, torch.ones((1, 2, 3, 16, 5)), d, d)
        with pytest.raises(ValueError, match="cum must be"):
            pt_ssd.ssd_chunk_scan_gpu(x, b, b, d, d[..., :8])

    def test_ssd_takes_float32_only(self):
        x, b = torch.ones((1, 2, 3, 16, 8)), torch.ones((1, 2, 3, 16, 4))
        d = torch.ones((1, 2, 3, 16))
        with pytest.raises(TypeError, match="bc must be float32"):
            pt_ssd.ssd_chunk_scan_gpu(x, b.bfloat16(), b, d, d)
        with pytest.raises(TypeError, match="dtc must be float32"):
            pt_ssd.ssd_chunk_scan_gpu(x, b, b, d.double(), d)

    def test_ssd_stages_validate(self):
        x, b = torch.ones((1, 2, 3, 16, 8)), torch.ones((1, 2, 3, 16, 4))
        d = torch.ones((1, 2, 3, 16))
        s = torch.ones((1, 2, 3, 8, 4))
        with pytest.raises(ValueError, match="disagree"):
            pt_ssd.ssd_state_passing_gpu(s[:, :, :2], d)
        with pytest.raises(TypeError, match="must be float32"):
            pt_ssd.ssd_state_passing_gpu(s.double(), d)
        with pytest.raises(ValueError, match="states on cpu, cum on meta"):
            pt_ssd.ssd_state_passing_gpu(s, d.to("meta"))
        with pytest.raises(ValueError, match=r"expected \(B,H,nc,P,N\)"):
            pt_ssd.ssd_chunk_output_gpu(x, b, b, d, d, s[..., :2])

    def test_ssd_chunk_must_divide_length(self):
        with pytest.raises(ValueError, match="not divisible by the chunk 32"):
            ops.ssd(torch.ones((1, 48, 2, 8)), torch.ones((1, 48, 1, 4)),
                    torch.ones((1, 48, 1, 4)), torch.ones((1, 48, 2)),
                    -torch.ones(2), chunk=32)

    def test_no_kernel_for_other_devices(self):
        """Only a CPU tensor takes the plain version; any other device
        launches a kernel or raises."""
        x = torch.ones((128, 128), device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            pt_sm.streaming_matmul(x, x)
        q = torch.ones((1, 2, 64, 32), device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            pt_fa.flash_attention_gpu(q, q, q)
        x, b = (torch.ones(s, device="meta") for s in ((1, 2, 1, 16, 8),
                                                       (1, 2, 1, 16, 4)))
        d = torch.ones((1, 2, 1, 16), device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            pt_ssd.ssd_chunk_scan_gpu(x, b, b, d, d)

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="x on cpu, w on meta"):
            pt_sm.streaming_matmul(torch.ones((128, 128)),
                                   torch.ones((128, 128), device="meta"))
        x, b = torch.ones((1, 2, 1, 16, 8)), torch.ones((1, 2, 1, 16, 4))
        d = torch.ones((1, 2, 1, 16))
        with pytest.raises(ValueError, match="xc on cpu, cum on meta"):
            pt_ssd.ssd_chunk_scan_gpu(x, b, b, d, d.to("meta"))


def test_cpu_path_never_counts_launches():
    m0, f0, s0 = pt_sm.LAUNCHES, pt_fa.LAUNCHES, pt_ssd.LAUNCHES
    ops.matmul(torch.ones((128, 128)), torch.ones((128, 128)))
    ops.attention(torch.ones((1, 64, 2, 32)), torch.ones((1, 64, 2, 32)),
                  torch.ones((1, 64, 2, 32)))
    ops.ssd(torch.ones((1, 64, 2, 8)), torch.ones((1, 64, 1, 4)),
            torch.ones((1, 64, 1, 4)), torch.ones((1, 64, 2)), -torch.ones(2),
            chunk=32)
    assert (pt_sm.LAUNCHES, pt_fa.LAUNCHES, pt_ssd.LAUNCHES) == (m0, f0, s0)


@pytest.mark.parametrize("op", ["matmul", "flash"])
def test_bf16_bound_passes_rounding_and_fails_a_skipped_tile(op):
    """The bound the kernels are held to (``ref.outside_tolerance``) at
    bf16: an output that only rounds differently passes it; one that skips
    a 128-wide tile of the contraction fails it."""
    rng = np.random.default_rng(5)

    def bf16(shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(torch.bfloat16)

    tile = slice(512, 640)
    if op == "matmul":
        tol = 0.5
        x, w = bf16((256, 1024)), bf16((1024, 256), 1024 ** -0.5)
        want = ref.matmul_ref(x, w)
        rounded = torch.matmul(x.double(), w.double()).to(torch.bfloat16)
        w_skip = w.clone()
        w_skip[tile] = 0
        skipped = ref.matmul_ref(x, w_skip)
    else:
        tol = 3e-2
        q, k, v = bf16((1, 4, 256, 128)), bf16((1, 4, 1024, 128)), bf16(
            (1, 4, 1024, 128))
        want = ref.flash_ref(q, k, v, causal=False)
        rounded = ref.flash_ref(q.float(), k.float(), v.float(),
                                causal=False).to(torch.bfloat16)
        keep = torch.ones(1024, dtype=torch.bool)
        keep[tile] = False
        skipped = ref.flash_ref(q, k[:, :, keep], v[:, :, keep],
                                causal=False)
    assert not ref.outside_tolerance(rounded, want, tol).any()
    assert ref.outside_tolerance(skipped, want, tol).any()
    nan = want.clone()
    nan[(0,) * nan.ndim] = float("nan")
    assert ref.outside_tolerance(nan, want, tol).sum() == 1


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version, on the card, within
    ``ref.outside_tolerance``'s bound: the reference's test cases through
    both variants (bf16 through the tensor-core kernels, float32 and a bf16
    shape the rule sends to the CUDA cores through the FFMA kernels), the
    matmul's backward (K = 100 included: ROADMAP C5), and for the SSD scan also mamba2-130m's head shape
    (P 64, N 128, chunk 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)

    def dev(shape, dtype):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(dtype).cuda()

    ffma_bf16_mm = [(128, 100, 128)]               # K % 8 != 0
    ffma_bf16_fa = [(1, 2, 2, 128, 128, 40, 40, True, None)]  # D % 16 != 0
    for dtype, mm_tol, fa_tol in ((torch.float32, 1e-3, 2e-5),
                                  (torch.bfloat16, 0.5, 3e-2)):
        tc = dtype == torch.bfloat16
        pt_sm.reset_launches()
        for M, K, N in MATMUL_SHAPES + (ffma_bf16_mm if tc else []):
            x, w = dev((M, K), dtype), dev((K, N), dtype)
            got = pt_sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                         block_k=128)
            bad = ref.outside_tolerance(got, ref.matmul_ref(x, w), mm_tol)
            assert not bad.any(), (M, K, N, dtype, int(bad.sum()))
            # the backward: dx = g w^T, dw = x^T g through the same kernel
            x.requires_grad_(True)
            w.requires_grad_(True)
            g = dev((M, N), dtype)
            pt_sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                   block_k=128).backward(g)
            for got, want in ((x.grad, ref.matmul_ref(g, w.detach().t())),
                              (w.grad, ref.matmul_ref(x.detach().t(), g))):
                bad = ref.outside_tolerance(got, want, mm_tol)
                assert not bad.any(), ("grad", M, K, N, dtype, int(bad.sum()))
        # each shape: forward, forward again, dx and dw; the bf16 K = 100
        # forwards take the FFMA kernel, its dx (N = 100, padded to 104)
        # and dw the tensor cores
        n = 4 * len(MATMUL_SHAPES)
        assert pt_sm.VARIANT_LAUNCHES == (
            {"wgmma": n + 2 * len(ffma_bf16_mm),
             "ffma": 2 * len(ffma_bf16_mm)} if tc
            else {"wgmma": 0, "ffma": n})
        pt_fa.reset_launches()
        for case in FLASH_CASES + (ffma_bf16_fa if tc else []):
            B, H, KV, Sq, Sk, D, Dv, causal, window = case
            q, k = dev((B, H, Sq, D), dtype), dev((B, KV, Sk, D), dtype)
            v = dev((B, KV, Sk, Dv), dtype)
            got = pt_fa.flash_attention_gpu(q, k, v, causal=causal,
                                            window=window, block_q=64,
                                            block_k=64)
            want = ref.flash_ref(q, k, v, causal=causal, window=window)
            bad = ref.outside_tolerance(got, want, fa_tol)
            assert not bad.any(), (case, dtype, int(bad.sum()))
        assert pt_fa.VARIANT_LAUNCHES == (
            {"wgmma": len(FLASH_CASES), "ffma": 1} if tc
            else {"wgmma": 0, "ffma": len(FLASH_CASES)})
    pt_ssd.reset_launches()
    mamba_head = [(2048, 256, 1, 1, 24, 64, 128)]  # L, chunk, G, B, H, P, N
    ragged = [(96, 48, 1, 1, 2, 30, 20)]  # Q 48; P, N take the 4-byte copies
    cases = ([(*case, 2, 4, 32, 32) for case in SSD_STAGED_CASES] + ragged
             + mamba_head)
    for L, chunk, G, B, H, P, N in cases:
        chunks = [torch.from_numpy(a).cuda() for a in _ssd_chunks(
            rng, L, chunk, G, B=B, H=H, P=P, N=N)]
        got = pt_ssd.ssd_chunk_scan_gpu(*chunks)
        want = pt_ssd.ssd_chunk_scan_plain(*chunks)
        bad = ref.outside_tolerance(got, want, 2e-4)
        assert not bad.any(), (L, chunk, G, int(bad.sum()))
        # each kernel against its plain stage, on the same inputs
        xc, bc, cc, dtc, cum = chunks
        states = pt_ssd.ssd_chunk_state_gpu(xc, bc, dtc, cum)
        bad = ref.outside_tolerance(
            states, pt_ssd.ssd_chunk_state_plain(xc, bc, dtc, cum), 2e-4)
        assert not bad.any(), ("chunk_state", L, chunk, G, int(bad.sum()))
        entering, final = pt_ssd.ssd_state_passing_gpu(states, cum)
        for got, want in zip((entering, final),
                             pt_ssd.ssd_state_passing_plain(states, cum)):
            bad = ref.outside_tolerance(got, want, 2e-4)
            assert not bad.any(), ("state_passing", L, chunk, int(bad.sum()))
        got = pt_ssd.ssd_chunk_output_gpu(xc, bc, cc, dtc, cum, entering)
        want = pt_ssd.ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering)
        bad = ref.outside_tolerance(got, want, 2e-4)
        assert not bad.any(), ("chunk_output", L, chunk, G, int(bad.sum()))
    n = len(cases)
    assert pt_ssd.LAUNCHES == n
    assert pt_ssd.STAGE_LAUNCHES == {"chunk_state": 2 * n,
                                     "state_passing": 2 * n,
                                     "chunk_output": 2 * n}
    torch.cuda.synchronize()
