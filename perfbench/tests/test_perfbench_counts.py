"""The frozen yardstick against counts worked out by hand at granite-8b's
train shape (and the frozen copy's SSD count at zamba2-1.2b's scan)."""
import pytest

from perfbench.counts import calls, categories, mfu, peaks, work

GRANITE = dict(family="dense", n_layers=12, d_model=4096, n_heads=32,
               n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=49152)
PAIRS = 2048 * 2049 // 2  # causal pairs of one 2048-token row


def test_flash_at_granites_train_shape():
    f, b = work.flash_work(2, 32, 2048, 2048, 8, 128, 128, causal=True,
                           window=None, itemsize=2)
    assert f == 2 * 32 * PAIRS * 2 * 256 == 68_753_031_168
    assert b == 83_886_080
    f, b = work.flash_bwd_work(2, 32, 2048, 2048, 8, 128, 128, causal=True,
                               window=None, itemsize=2)
    assert f == 171_882_577_920
    assert b == 167_772_160 + 2 * 32 * 2048 * 4


def test_ssd_at_zamba2s_train_shape():
    f, b = work.ssd_work(4, 64, 8, 256, 64, 64)
    assert f == 4 * 64 * 8 * (2 * 32_896 * 128 + 4 * 256 * 64 * 64)
    assert f == 25_836_912_640
    assert b == 541_065_216
    f, b = work.ssd_bwd_work(4, 64, 8, 256, 64, 64)
    assert f == 2048 * (2 * 32_896 * (3 * 64 + 2 * 64) + 12 * 256 * 64 * 64)
    assert b == 2048 * 256 * (3 * 64 + 4 * 64 + 4) * 4


def test_bounds_take_the_larger_side():
    t = {"batch": 2, "seq": 2048}
    assert calls.b2_fwd_bound_s(GRANITE, t) == pytest.approx(
        68_753_031_168 / 989e12)
    assert calls.b2_bwd_bound_s(GRANITE, t) == pytest.approx(
        171_882_577_920 / 989e12)
    assert peaks.bound_s(1.0, 3.35e12, 1e30) == pytest.approx(1.0)


def test_roofline_share_reads_nothing_without_calls():
    assert calls.roofline_share(0, 1.0, 5) is None
    assert calls.roofline_share(4, 1e-3, 8_000_000) == pytest.approx(50.0)


def test_granite_step_flops():
    T, d = 4096, 4096
    proj = 2 * T * d * (4096 + 2048) + 2 * T * 4096 * d
    mlp = 3 * 2 * T * d * 14336
    block = proj + mlp + 68_753_031_168
    fwd = 12 * block + 2 * T * d * 49152
    assert fwd == 23_914_780_557_312
    assert mfu.step_flops(GRANITE, 2, 2048) == 3 * fwd


def test_unknown_family_has_no_count():
    assert mfu.step_flops({"family": "hybrid"}, 1, 1) is None


@pytest.mark.parametrize("name,cat", [
    ("void flash_wgmma_kernel<__nv_bfloat16, 128>(CUtensorMap)", "b2_fwd"),
    ("void tcb::flash_bwd_dq_wgmma<128, 128>(CUtensorMap)", "b2_bwd"),
    ("void flash_bwd_delta_vec(__nv_bfloat16 const*)", "b2_bwd"),
    ("void ssd_chunk_state_kernel<64, true>(float const*)", "b3_bwd"),
    ("void ssd_chunk_state_kernel<128, false>(float const*)", "b3_fwd"),
    ("void ssd_bwd_key_kernel<64>(float const*)", "b3_bwd"),
    ("ssd_chunk_output_kernel", "b3_fwd"),
    ("nvjet_tst_192x192_64x4_1x2_h_bz_coopB_NTN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("Memcpy HtoD (Pinned -> Device)", "copy_h2d"),
    ("Memcpy DtoH (Device -> Pinned)", "copy_d2h"),
    ("Memcpy DtoD (Device -> Device)", "copy_other"),
    ("Memset (Device)", "copy_other"),
    ("void at::native::vectorized_elementwise_kernel<4, float>", "elementwise"),
])
def test_categories(name, cat):
    assert categories.category(name) == cat
