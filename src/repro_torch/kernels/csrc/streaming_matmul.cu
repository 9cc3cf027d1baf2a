// Dual-buffered streaming matmul for Hopper (sm_90a): out = x @ w.
//
// Replaces: src/repro/kernels/streaming_matmul.py::_kernel (Pallas, TPU),
// which keeps w in HBM and DMAs its K-tiles into two alternating VMEM
// buffers, posting tile k+1 before contracting tile k.
//
// Bound on the H100: at the streaming executor's shape (M = K = N = 4096,
// bf16) the product does 2*M*N*K = 137 GFLOP on 101 MB, about 1360 FLOP per
// byte, far above the card's ~295 FLOP/byte balance point: it is bound by
// operations, 0.139 ms at the bf16 tensor-core peak (989 TFLOP/s).
//
// Two variants; the wrapper picks one by a plain rule on dtype and shape
// (kernels/streaming_matmul.py::_variant):
//
// (1) "wgmma", bf16 with K and N multiples of 8 (16-byte TMA strides):
//   * a CTA computes a 128x256 output tile; warpgroup 0 is the producer
//     (one thread issues TMA), warpgroups 1 and 2 are consumers that own 64
//     rows each and issue wgmma.m64n256k16, the accumulators (128 floats a
//     thread) in registers; setmaxnreg moves registers from the producer to
//     the consumers;
//   * x's (128 x 64) and w's (64 x 256) K-tiles stream through a FOUR-STAGE
//     ring of 128-byte-swizzled shared-memory tiles with one "full" and one
//     "empty" mbarrier a stage: the producer posts tile k+1.. k+3 while the
//     consumers contract tile k, and a consumer waits on a tile's barrier
//     right before its first wgmma — the TPU kernel's two VMEM slots grown to
//     four stages, one memory level down (HBM -> SMEM);
//   * x is a K-major A operand; w (K, N) row-major is an MN-major B operand,
//     read with wgmma's transpose bit: no copy of w;
//   * every output sums its K products in one order, k-tile by k-tile in one
//     CTA: no split-K, no atomics, so tiered and untiered runs are
//     bit-identical; float32 accumulation, rounded to bf16 once;
//   * TMA reads zeros beyond the ragged edges of M, N and K; the store is
//     masked.
//
// (2) "ffma", float32 (no TF32: the reference's float32 tolerance is 1e-3),
//   and bf16 shapes the first variant does not take, on the CUDA cores:
//   * one 256-thread block per 128x128 output tile; each thread owns an
//     8x8 register tile of float32 accumulators;
//   * w's K-tiles (8 x 128) stream through a TWO-SLOT ring in shared memory
//     with cp.async: tile k+1 is posted before tile k is contracted and the
//     wait (cp.async.wait_group) is deferred to just before first use;
//   * x's tile for step k+1 is loaded into registers during step k and
//     stored (transposed, as float) into the other x slot afterwards;
//   * every output element sums its K products in order k = 0, 1, ... in
//     one thread: no split-K, no atomics;
//   * bf16 inputs are widened to float32; the output is rounded to the
//     input type; ragged edges are zero-filled (cp.async src-size 0) and
//     masked on store. The wrapper requires N to be a multiple of the
//     16-byte vector width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int TM = 8;  // rows per thread
constexpr int TN = 8;  // columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// eight consecutive elements of a w row in shared memory, widened to float
__device__ __forceinline__ void load8(const float* p, float* b) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
  b[4] = v.x; b[5] = v.y; b[6] = v.z; b[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* b) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    b[2 * i] = f.x;
    b[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
streaming_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, int M, int N, int K) {
  constexpr int VEC = 16 / sizeof(T);          // elements per cp.async
  constexpr int XPT = BM * BK / THREADS;       // x elements per thread
  __shared__ __align__(16) float xs[2][BK][BM];  // x tiles, transposed
  __shared__ __align__(16) T ws[2][BK][BN];      // the dual buffer of w

  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  auto post_w = [&](int kt, int slot) {
    for (int c = tid; c < BK * BN / VEC; c += THREADS) {
      const int r = c / (BN / VEC);
      const int col = (c % (BN / VEC)) * VEC;
      const int gk = kt * BK + r;
      const int gn = n0 + col;
      const bool ok = gk < K && gn < N;
      cp_async16(&ws[slot][r][col], ok ? w + (size_t)gk * N + gn : w, ok);
    }
    cp_async_commit();
  };
  float xr[XPT];
  auto load_x = [&](int kt) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      const int gm = m0 + e / BK;
      const int gk = kt * BK + e % BK;
      xr[i] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
  };
  auto store_x = [&](int slot) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * THREADS;
      xs[slot][e % BK][e / BK] = xr[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: the first tile cannot be hidden
  post_w(0, 0);
  load_x(0);
  store_x(0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int slot = kt & 1;
    const bool more = kt + 1 < n_k;
    if (more) {
      // dual buffer: post tile k+1 into the idle slot before contracting k
      post_w(kt + 1, slot ^ 1);
      load_x(kt + 1);
      cp_async_wait<1>();  // access barrier for tile k, deferred to here
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float b[TN];
      load8(&xs[slot][k][ty * TM], a);
      load8(&ws[slot][k][tx * TN], b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_x(slot ^ 1);
    __syncthreads();  // both slots free for the next post
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) store_out(out + (size_t)gm * N + gn, acc[i][j]);
    }
  }
}

}  // namespace

// ---- (1) the tensor-core variant ---------------------------------------------

namespace tc {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;                  // 128 bytes of bf16: one swizzle row
constexpr int STAGES = 4;
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int X_BYTES = BM * BK * 2;    // 16 KiB
constexpr int W_BOX_BYTES = BK * 64 * 2;  // one 64-wide box of w: 8 KiB
constexpr int W_BYTES = BK * BN * 2;    // 32 KiB
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__global__ void __launch_bounds__(THREADS, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  auto x_tile = [&](int s) { return smem + s * STAGE_BYTES; };
  auto w_tile = [&](int s) { return smem + s * STAGE_BYTES + X_BYTES; };

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_2d(x_tile(s), &xmap, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(w_tile(s) + j * W_BOX_BYTES, &wmap, &full[s],
                              n0 + j * 64, kt * BK);
      }
    }
  } else {  // consumers: 64 rows x 256 columns each
    hopper::regs_alloc<232>();
    const int cw = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      hopper::mbar_wait(&full[s], (kt / STAGES) & 1);  // access barrier
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = hopper::smem_desc(
            x_tile(s) + cw * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = hopper::smem_desc(
            w_tile(s) + kk * 16 * 128, W_BOX_BYTES, 1024);
        hopper::wgmma_ss_m64n256k16<1>(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[s]);
    }

    const int t = threadIdx.x % 128;
    const int r = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = n0 + i * 8 + 2 * (t % 4);
      if (c >= N) continue;  // N is even: c < N means c + 1 < N
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c) =
            __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
      if (r + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8) * N + c) =
            __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16. x (M,K), w (K,N), out (M,N), all
// row-major and contiguous. The FFMA variant. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int streaming_matmul(int dtype, const void* x, const void* w, void* out,
                                int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    streaming_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K);
  } else if (dtype == 1) {
    streaming_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core variant: bf16 x (M,K), w (K,N), out (M,N), row-major and
// contiguous, 16-byte aligned, K and N multiples of 8. Launches on `stream`;
// returns 0, a CUDA error code, or one above hopper::kTensorMapError.
extern "C" int streaming_matmul_wgmma(const void* x, const void* w, void* out,
                                      int M, int N, int K, void* stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {tc::BK, tc::BM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t w_box[2] = {64, tc::BK};
  int err = hopper::make_map(&xmap, x, 2, x_dims, x_strides, x_box);
  if (err == 0) err = hopper::make_map(&wmap, w, 2, w_dims, w_strides, w_box);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      tc::matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
  tc::matmul_wgmma_kernel<<<grid, tc::THREADS, tc::SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return hopper::error_string(code);
}
