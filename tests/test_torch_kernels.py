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
    from repro.kernels.streaming_matmul import streaming_matmul as ref_matmul
    from repro.models.flash import flash_attention as jnp_flash
except ModuleNotFoundError:  # a card's machine without JAX: cuda test only
    jnp = None

from repro_torch.kernels import flash_attention as pt_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
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

    def test_no_kernel_for_other_devices(self):
        """Only a CPU tensor takes the plain version; any other device
        launches a kernel or raises."""
        x = torch.ones((128, 128), device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            pt_sm.streaming_matmul(x, x)
        q = torch.ones((1, 2, 64, 32), device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            pt_fa.flash_attention_gpu(q, q, q)

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="x on cpu, w on meta"):
            pt_sm.streaming_matmul(torch.ones((128, 128)),
                                   torch.ones((128, 128), device="meta"))


def test_cpu_path_never_counts_launches():
    m0, f0 = pt_sm.LAUNCHES, pt_fa.LAUNCHES
    ops.matmul(torch.ones((128, 128)), torch.ones((128, 128)))
    ops.attention(torch.ones((1, 64, 2, 32)), torch.ones((1, 64, 2, 32)),
                  torch.ones((1, 64, 2, 32)))
    assert (pt_sm.LAUNCHES, pt_fa.LAUNCHES) == (m0, f0)


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
    ``ref.outside_tolerance``'s bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)

    def dev(shape, dtype):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(dtype).cuda()

    for dtype, mm_tol, fa_tol in ((torch.float32, 1e-3, 2e-5),
                                  (torch.bfloat16, 0.5, 3e-2)):
        n0 = pt_sm.LAUNCHES
        for M, K, N in MATMUL_SHAPES:
            x, w = dev((M, K), dtype), dev((K, N), dtype)
            got = pt_sm.streaming_matmul(x, w, block_m=128, block_n=128,
                                         block_k=128)
            bad = ref.outside_tolerance(got, ref.matmul_ref(x, w), mm_tol)
            assert not bad.any(), (M, K, N, dtype, int(bad.sum()))
        assert pt_sm.LAUNCHES == n0 + len(MATMUL_SHAPES)
        n0 = pt_fa.LAUNCHES
        for case in FLASH_CASES:
            B, H, KV, Sq, Sk, D, Dv, causal, window = case
            q, k = dev((B, H, Sq, D), dtype), dev((B, KV, Sk, D), dtype)
            v = dev((B, KV, Sk, Dv), dtype)
            got = pt_fa.flash_attention_gpu(q, k, v, causal=causal,
                                            window=window, block_q=64,
                                            block_k=64)
            want = ref.flash_ref(q, k, v, causal=causal, window=window)
            bad = ref.outside_tolerance(got, want, fa_tol)
            assert not bad.any(), (case, dtype, int(bad.sum()))
        assert pt_fa.LAUNCHES == n0 + len(FLASH_CASES)
    torch.cuda.synchronize()
