"""The port's SSD kernel path and Mamba2 block against the JAX reference.

Same numpy inputs, made from a seed, through both packages. The reference
runs its Pallas SSD kernel in interpret mode (as ``tests/test_kernels.py``
does); the port's wrappers take their plain versions on the CPU. The
tolerances are the reference's own: 2e-4 for the kernel path
(``TestSSDKernel``), 1e-4 for the plain chunked scan (``TestSSD``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import ssm as ref_ssm

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan
from repro_torch.models import ssm

SSD_KERNEL_CASES = [(64, 32), (128, 32), (256, 64),  # TestSSDKernel's
                    (32, 32),                        # one chunk (nc = 1)
                    (16, 32)]                        # L < chunk


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _ssd_inputs(seed, Bsz, L, H, P, G, N):
    """TestSSDKernel's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bsz, L, H, P)).astype(np.float32)
    Bm = (rng.standard_normal((Bsz, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((Bsz, L, G, N)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((Bsz, L, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)) * 0.5)).astype(np.float32)
    return xh, Bm, Cm, dt, A


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _cfg_pair(ref_dtype=jnp.float32, dtype=torch.float32, **overrides):
    """The reduced mamba2-130m config of both packages."""
    return (ref_reduced_config(ref_get_config("mamba2-130m"), dtype=ref_dtype,
                               **overrides),
            reduced_config(get_config("mamba2-130m"), dtype=dtype, **overrides))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L,chunk", SSD_KERNEL_CASES)
def test_ops_ssd_matches_reference_kernel_and_oracle(L, chunk, G):
    arrays = _ssd_inputs(2, 2, L, 4, 32, G, 32)
    (xj, bj, cj, dj, aj), (xt, bt, ct, dtt, at) = _both(arrays)
    got = ops.ssd(xt, bt, ct, dtt, at, chunk=chunk)
    assert got.shape == (2, L, 4, 32) and got.dtype == torch.float32
    want_kernel = ref_ops.ssd(xj, bj, cj, dj, aj, chunk=chunk, interpret=True)
    want_oracle = ref_ssm.ssd_reference_recurrent(xj, bj, cj, dj, aj)
    np.testing.assert_allclose(_np(got), _np(want_kernel), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(got), _np(want_oracle), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(
        _np(ssm.ssd_reference_recurrent(xt, bt, ct, dtt, at)),
        _np(want_oracle), atol=2e-4, rtol=2e-4)


def _chunk_tensors(arrays, chunk):
    """The reference's prep (``kernels/ops.py``) in numpy: the kernel's five
    (B,H,nc,Q,...) float32 inputs."""
    xh, Bm, Cm, dt, A = arrays
    B, L, H, _ = xh.shape
    Q = min(chunk, L)
    nc, rep = L // Q, H // Bm.shape[2]

    def chunked(t):
        return np.ascontiguousarray(
            np.moveaxis(t.reshape(B, nc, Q, *t.shape[2:]), 3, 1))

    cum = np.cumsum(chunked(dt * A), axis=-1, dtype=np.float32)
    return (chunked(xh), chunked(np.repeat(Bm, rep, axis=2)),
            chunked(np.repeat(Cm, rep, axis=2)), chunked(dt), cum)


@pytest.mark.parametrize("L,chunk,G", [(128, 32, 1), (256, 64, 2)])
def test_plain_versions_match_reference_oracles(L, chunk, G):
    """The plain chunk loop (the CUDA kernel's ground truth) and the
    recurrent oracle on chunk tensors, against the reference's."""
    chunks = _chunk_tensors(_ssd_inputs(3, 2, L, 4, 32, G, 32), chunk)
    js, ts = _both(chunks)
    want = ref_ref.ssd_ref(*js)
    plain = ssd_scan.ssd_chunk_scan_plain(*ts)
    assert plain.shape == chunks[0].shape
    np.testing.assert_allclose(_np(plain), _np(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(ref.ssd_ref(*ts)), _np(want), atol=2e-4,
                               rtol=2e-4)


def test_plain_scan_masks_by_selection():
    """A chunk whose cumsum falls steeply makes exp(cum_i - cum_j) overflow
    to inf above the diagonal; selecting (not multiplying by) the causal
    mask keeps y finite and equal to the recurrent oracle."""
    arrays = list(_ssd_inputs(4, 1, 64, 2, 16, 1, 16))
    arrays[3] = arrays[3] * 40.0   # dt ~ 40: cum falls by ~40 a step
    chunks = [torch.from_numpy(a) for a in _chunk_tensors(arrays, 64)]
    assert torch.isinf(torch.exp(chunks[4][..., :1] - chunks[4])).any()
    got = ssd_scan.ssd_chunk_scan_plain(*chunks)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(ref.ssd_ref(*chunks)), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("L,chunk", [(64, 16), (128, 32), (96, 32)])
def test_ssd_scan_matches_reference(L, chunk, with_init):
    """TestSSD's cases: y and the final state, with and without an initial
    state, at the reference's 1e-4."""
    ref_cfg, cfg = _cfg_pair(ssm_chunk=chunk)
    H, P, G, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    arrays = _ssd_inputs(11, 2, L, H, P, G, N)
    (xj, bj, cj, dj, aj), (xt, bt, ct, dtt, at) = _both(arrays)
    init = (np.random.default_rng(12).standard_normal((2, H, P, N))
            .astype(np.float32) if with_init else None)
    y_ref, s_ref = ref_ssm._ssd_scan(
        xj, bj, cj, dj, aj, ref_cfg,
        init_state=None if init is None else jnp.asarray(init))
    y, s = ssm._ssd_scan(xt, bt, ct, dtt, at, cfg,
                         init_state=None if init is None else torch.from_numpy(init))
    assert y.dtype == torch.float32 and s.shape == (2, H, P, N)
    np.testing.assert_allclose(_np(y), _np(y_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(s), _np(s_ref), atol=1e-4, rtol=1e-4)
    if not with_init:  # the kernel path gives the same y
        np.testing.assert_allclose(
            _np(ops.ssd(xt, bt, ct, dtt, at, chunk=chunk)), _np(y_ref),
            atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("L,chunk", [(64, 16), (128, 32), (96, 32)])
def test_staged_final_state_matches_reference(L, chunk):
    """TestSSD's cases through the port's staged plain versions (the CUDA
    kernels' layout) from a zero state: the state after the last chunk and
    y against the reference's ``_ssd_scan``, at its 1e-4."""
    ref_cfg, cfg = _cfg_pair(ssm_chunk=chunk)
    H, P, G, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    (xj, bj, cj, dj, aj), (xt, bt, ct, dtt, at) = _both(
        _ssd_inputs(11, 2, L, H, P, G, N))
    y_ref, s_ref = ref_ssm._ssd_scan(xj, bj, cj, dj, aj, ref_cfg)
    xc, bc, cc, dtc, cum = ops.ssd_prep(xt, bt, ct, dtt, at, chunk=chunk)
    states = ssd_scan.ssd_chunk_state_plain(xc, bc, dtc, cum)
    entering, final = ssd_scan.ssd_state_passing_plain(states, cum)
    assert final.shape == (2, H, P, N) and final.dtype == torch.float32
    np.testing.assert_allclose(_np(final), _np(s_ref), atol=1e-4, rtol=1e-4)
    y = ssd_scan.ssd_chunk_output_plain(xc, bc, cc, dtc, cum, entering)
    np.testing.assert_allclose(_np(y.movedim(1, 3).reshape(2, L, H, P)),
                               _np(y_ref), atol=1e-4, rtol=1e-4)


def _block_setup(dtype_name, seed=0, L=32):
    import jax

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    ref_cfg, cfg = _cfg_pair(ref_dtype=jdt, dtype=tdt)
    ref_p = ref_ssm.ssm_init(jax.random.PRNGKey(seed), ref_cfg)
    ref_p = {**ref_p, "A_log": ref_p["A_log"] + 0.3,  # exercise A, D, dt_bias
             "D": ref_p["D"] * 0.5, "dt_bias": ref_p["dt_bias"] - 0.2}
    p = params_from_reference(ref_p, device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, L, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, ref_p, p, jnp.asarray(x).astype(jdt), \
        torch.from_numpy(x).to(tdt)


def test_params_from_reference_keeps_dtypes_and_values():
    _, _, ref_p, p, _, _ = _block_setup("bfloat16")
    assert p["in_proj"].dtype == torch.bfloat16
    assert p["A_log"].dtype == torch.float32
    for k in ("in_proj", "conv_w", "A_log", "out_proj"):
        np.testing.assert_array_equal(_np(p[k]), _np(ref_p[k]))
    np.testing.assert_array_equal(_np(p["norm"]["scale"]),
                                  _np(ref_p["norm"]["scale"]))


def test_ssm_block_matches_reference_f32():
    ref_cfg, cfg, ref_p, p, xj, xt = _block_setup("float32")
    want = ref_ssm.ssm_block(ref_p, xj, ref_cfg)
    got = ssm.ssm_block(p, xt, cfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


#: bf16 bound: max |diff| <= BF16_MAX * max |want| and ||diff|| / ||want||
#: <= BF16_L2. Reason: XLA-CPU's bf16 logistic (inside silu) rounds
#: differently from torch's sigmoid in about a third of the elements, by one
#: bf16 unit (2^-8 relative); those flips pass through the SSD sums and the
#: gated norm. Measured over seeds 0-7: max |diff| up to 0.027 of max |want|,
#: relative L2 up to 0.0086. A wrong term (a dropped carry, the D skip, the
#: gate) moves the output by a large share of its scale.
BF16_MAX, BF16_L2 = 5e-2, 2e-2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ssm_block_matches_reference_bf16(seed):
    ref_cfg, cfg, ref_p, p, xj, xt = _block_setup("bfloat16", seed=seed)
    want = _np(ref_ssm.ssm_block(ref_p, xj, ref_cfg))
    got = ssm.ssm_block(p, xt, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    diff = _np(got) - want
    assert np.abs(diff).max() <= BF16_MAX * np.abs(want).max()
    assert np.linalg.norm(diff) <= BF16_L2 * np.linalg.norm(want)


def test_causal_conv_matches_reference():
    ref_cfg, cfg, ref_p, p, _, _ = _block_setup("float32")
    C = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    xbc = np.random.default_rng(5).standard_normal((2, 24, C)).astype(np.float32)
    np.testing.assert_allclose(
        _np(ssm._causal_conv(p, torch.from_numpy(xbc), cfg)),
        _np(ref_ssm._causal_conv(ref_p, jnp.asarray(xbc), ref_cfg)),
        atol=1e-5, rtol=1e-5)


def test_softplus_matches_reference_within_its_switch():
    """``F.softplus`` returns x itself above 20; ``jax.nn.softplus`` keeps
    ``log1p(exp(-x)) + x``. exp(-20) ~ 2e-9 is below half a float32 unit,
    so above the switch both give x exactly; below it the two round their
    exp/log1p differently, by at most two units (2.4e-7 relative)."""
    import jax

    x = np.linspace(-30, 60, 2001).astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(got[x > 20], want[x > 20])
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)


def test_ssm_decode_step_matches_reference():
    """Eight decode steps of one block: outputs, conv ring and state."""
    ref_cfg, cfg, ref_p, p, _, _ = _block_setup("float32")
    ref_cache = ref_ssm.ssm_decode_init(ref_cfg, 2)
    cache = ssm.ssm_decode_init(cfg, 2, device="cpu")
    xs = np.random.default_rng(6).standard_normal(
        (8, 2, 1, cfg.d_model)).astype(np.float32)
    for x in xs:
        want, ref_cache = ref_ssm.ssm_decode_step(ref_p, jnp.asarray(x),
                                                  ref_cache, ref_cfg)
        got, cache = ssm.ssm_decode_step(p, torch.from_numpy(x), cache, cfg)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    for k in ("conv", "state"):
        assert cache[k].dtype == {"conv": torch.float32,
                                  "state": torch.float32}[k]
        np.testing.assert_allclose(_np(cache[k]), _np(ref_cache[k]),
                                   atol=1e-4, rtol=1e-4)


def test_block_decode_matches_its_chunked_forward():
    """Token-by-token decode of one block reproduces the chunked block (the
    kernel path) over a sequence that crosses a chunk boundary."""
    _, cfg, _, p, _, xt = _block_setup("float32", L=48)
    cfg = dataclasses.replace(cfg, ssm_chunk=16)
    full = ssm.ssm_block(p, xt, cfg)
    cache = ssm.ssm_decode_init(cfg, 2, device="cpu")
    for t in range(xt.shape[1]):
        out, cache = ssm.ssm_decode_step(p, xt[:, t:t + 1], cache, cfg)
        np.testing.assert_allclose(_np(out[:, 0]), _np(full[:, t]),
                                   atol=1e-4, rtol=1e-4)
