// Forward flash attention for Hopper (sm_90a), online softmax in float32.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (Pallas, TPU),
// which walks a (batch, head, q-block, kv-block) grid with the kv axis run
// in order on one core, carrying (m, l, acc) in VMEM scratch.
//
// Bound on the H100: at the streaming executor's shape (B=1, H=32, KV=8,
// S=4096, D=Dv=128, causal, bf16) the live half of the score matrix costs
// 4*H*D*S*(S+1)/2 = 137 GFLOP on about 84 MB of q, k, v and o: bound by
// operations. This first version computes on the CUDA cores (FFMA), not on
// the tensor cores, so it cannot reach the bf16 tensor-core bound; a
// wgmma/TMA version is later work.
//
// Design:
//   * one 256-thread block per (b, h, 64-row q-block); a loop over 32-key
//     tiles takes the place of the TPU's sequential kv grid axis;
//   * each warp owns 8 query rows for the whole kernel: lane j computes the
//     score of key j of the tile for its 8 rows, the row max and row sum are
//     warp shuffles, and (m, l) and the row's float32 accumulator (Dv <= 128
//     spread over the 32 lanes) stay in registers — no block-wide reduction;
//   * q is held in shared memory as float32 for the whole kernel, k and v
//     tiles are staged per step; GQA reads K/V head h // (H / KV);
//   * tiles that the causal or window mask kills entirely are skipped, as
//     the reference does; masks are applied per element with the reference's
//     finite NEG_INF (-0.7 * float32 max), so exp(s - m) never forms inf-inf;
//   * p is rounded to the input type before the p @ v product, as the
//     reference casts p to v's dtype; rows that meet no live tile output 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 32;      // keys per tile (one per lane)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BQ / WARPS;  // query rows per warp
constexpr int MAX_DV = 128;
constexpr int DV_PER_LANE = MAX_DV / 32;
constexpr float NEG_INF = static_cast<float>(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {  // element strides of the batch, head and sequence dims
  long long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int KV, int Sq, int Sk, int D, int Dv,
                 Strides qs_, Strides ks_, Strides vs_, Strides os_,
                 float scale, int causal, int has_window, int window) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BQ][D]
  float* ks = qs + BQ * D;             // [BKV][D + 1] (padded: no bank conflicts)
  float* vs = ks + BKV * (D + 1);      // [BKV][Dv]
  float* ps = vs + BKV * Dv;           // [BQ][BKV]

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_lo = qb * BQ;
  const int row0 = warp * ROWS;  // this warp's first row in the block

  const T* qp = q + b * qs_.b + h * qs_.h;
  const T* kp = k + b * ks_.b + kvh * ks_.h;
  const T* vp = v + b * vs_.b + kvh * vs_.h;
  T* op = o + b * os_.b + h * os_.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int qi = q_lo + e / D;
    qs[e] = qi < Sq ? to_f32(qp[qi * qs_.s + e % D]) : 0.f;
  }

  float m[ROWS];
  float l[ROWS];
  float acc[ROWS][DV_PER_LANE];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV_PER_LANE; ++j) acc[i][j] = 0.f;
  }

  const int n_kb = (Sk + BKV - 1) / BKV;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_lo = kb * BKV;
    // tile-level causal/window skip (block-uniform, so the barriers below
    // are reached by every thread or by none)
    if (causal && k_lo > q_lo + BQ - 1) break;
    if (has_window && k_lo + BKV <= q_lo - window + 1) continue;

    __syncthreads();  // the previous tile's k/v/p reads are done
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D;
      const int key = k_lo + r;
      ks[r * (D + 1) + e % D] = key < Sk ? to_f32(kp[key * ks_.s + e % D]) : 0.f;
    }
    for (int e = tid; e < BKV * Dv; e += THREADS) {
      const int key = k_lo + e / Dv;
      vs[e] = key < Sk ? to_f32(vp[key * vs_.s + e % Dv]) : 0.f;
    }
    __syncthreads();

    // s[i] = q[row0 + i] . k[lane]
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float* krow = ks + lane * (D + 1);
    for (int d = 0; d < D; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (row0 + i) * D + d);
        s[i] = fmaf(qv.x, k0, s[i]);
        s[i] = fmaf(qv.y, k1, s[i]);
        s[i] = fmaf(qv.z, k2, s[i]);
        s[i] = fmaf(qv.w, k3, s[i]);
      }
    }

    // online softmax, one row per step, reductions across the warp
    const int ki = k_lo + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qi = q_lo + row0 + i;
      const bool live = ki < Sk && !(causal && ki > qi) &&
                        !(has_window && ki <= qi - window);
      const float sv = live ? s[i] * scale : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float p = ki < Sk ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      ps[(row0 + i) * BKV + lane] = round_to<T>(p);
#pragma unroll
      for (int j = 0; j < DV_PER_LANE; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // the warp's p rows are written

    // acc[i][j] += sum_k p[row0 + i][k] * v[k][lane + 32 j]
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (row0 + i) * BKV + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int j = 0; j < DV_PER_LANE; ++j) {
          const int c = lane + 32 * j;
          const float vv = c < Dv ? vs[(kk + t) * Dv + c] : 0.f;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float pt = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
            acc[i][j] = fmaf(pt, vv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q_lo + row0 + i;
    if (qi >= Sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DV_PER_LANE; ++j) {
      const int c = lane + 32 * j;
      if (c < Dv) store_out(op + qi * os_.s + c, acc[i][j] / l_safe);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, int D, int Dv, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BQ * D + BKV * (D + 1) + BKV * Dv + BQ * BKV);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Sk, D, Dv, qs, ks, vs, os, scale, causal,
      has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,H,Sq,D), k (B,KV,Sk,D),
// v (B,KV,Sk,Dv), o (B,H,Sq,Dv), each given by its base pointer and the
// element strides of its batch, head and sequence dims (the last dim is
// contiguous). D % 4 == 0, D <= 128 and Dv <= 128. Launches on `stream`;
// returns the CUDA error code (0 on success).
extern "C" int flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int B, int H, int KV, int Sq, int Sk, int D, int Dv,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    float scale, int causal, int has_window, int window, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, H, KV, Sq, Sk, D, Dv, qs, ks, vs, os,
                         scale, causal, has_window, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, D, Dv, qs, ks, vs,
                                 os, scale, causal, has_window, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
