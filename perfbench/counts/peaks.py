"""The card's peaks: NVIDIA H100 SXM, the data sheet's dense rates at its
700 W power limit (a card set lower runs slower under load; each run prints
its power limit). A frozen copy of ``repro_torch/launch/mesh.py``'s
constants."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16
F32_FLOPS = 67e12          # CUDA cores, float32
TF32_FLOPS = 495e12        # tensor cores, TF32
TF32_PASSES = 3            # the SSD kernels' split TF32 ("3xTF32"): 3 a product
HBM_BYTES_PER_S = 3.35e12  # HBM3


def bound_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    """The least time the card could take for one call: the larger of its
    operations over the compute peak and its bytes over HBM's."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)
