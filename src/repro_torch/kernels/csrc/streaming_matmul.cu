// Dual-buffered streaming matmul for Hopper (sm_90a): out = x @ w.
//
// Replaces: src/repro/kernels/streaming_matmul.py::_kernel (Pallas, TPU),
// which keeps w in HBM and DMAs its K-tiles into two alternating VMEM
// buffers, posting tile k+1 before contracting tile k.
//
// Bound on the H100: at the streaming executor's shape (M = K = N = 4096,
// bf16) the product does 2*M*N*K = 137 GFLOP on 101 MB, about 1360 FLOP per
// byte, far above the card's ~295 FLOP/byte balance point: it is bound by
// operations. This first version runs on the CUDA cores (FFMA, float32
// accumulation, ~67 TFLOP/s peak), not on the tensor cores, so it cannot
// come near the bf16 tensor-core bound; wgmma and TMA are later work.
//
// Design:
//   * one 256-thread block per 128x128 output tile; each thread owns an
//     8x8 register tile of float32 accumulators;
//   * w's K-tiles (8 x 128) stream through a TWO-SLOT ring in shared memory
//     with cp.async: tile k+1 is posted before tile k is contracted and the
//     wait (cp.async.wait_group) is deferred to just before first use —
//     the TPU kernel's dual buffer, one memory level down (HBM -> SMEM);
//   * x's tile for step k+1 is loaded into registers during step k and
//     stored (transposed, as float) into the other x slot afterwards;
//   * every output element sums its K products in order k = 0, 1, ... in
//     one thread: no split-K, no atomics, so the result is deterministic
//     and tiered/untiered runs are bit-identical;
//   * float32 inputs are multiplied in float32 (no TF32); bf16 inputs are
//     widened to float32; the output is rounded to the input type;
//   * ragged edges are zero-filled (cp.async src-size 0) and masked on store.
//     The wrapper requires N to be a multiple of the 16-byte vector width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// dtype: 0 = float32, 1 = bfloat16. x (M,K), w (K,N), out (M,N), all
// row-major and contiguous. Launches on `stream`; returns cudaGetLastError().
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
