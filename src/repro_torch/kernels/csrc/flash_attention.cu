// Forward flash attention for Hopper (sm_90a), online softmax in float32.
//
// Replaces: src/repro/kernels/flash_attention.py::_kernel (Pallas, TPU),
// which walks a (batch, head, q-block, kv-block) grid with the kv axis run
// in order on one core, carrying (m, l, acc) in VMEM scratch.
//
// Bound on the H100: at the streaming executor's shape (B=1, H=32, KV=8,
// S=4096, D=Dv=128, causal, bf16) the live half of the score matrix costs
// 4*H*D*S*(S+1)/2 = 137 GFLOP on about 84 MB of q, k, v and o: bound by
// operations, 0.139 ms at the bf16 tensor-core peak.
//
// Semantics both variants keep from the reference: online softmax in
// float32; p rounded to v's type before p @ v, while l sums the unrounded p;
// GQA (K/V head h // (H / KV)); causal, sliding-window and cross attention
// (Sq != Sk, no offset: query row i is position i); Dv != D; whole tiles
// that the reference's `live` test kills are skipped; per-element masks with
// the finite NEG_INF = -0.7 * float32 max, so exp(s - m) never forms inf-inf;
// a row that meets no live tile outputs 0 (l_safe).
//
// Two variants; the wrapper picks one by a plain rule on dtype and shape
// (kernels/flash_attention.py::_variant):
//
// (1) "wgmma", bf16 with D and Dv multiples of 16, D at most 192 and Dv at
//   most 128 (MLA's prefill: D 192 = 128 nope + 64 rope, Dv 128):
//   * one CTA per (b, h, 128 query rows): warpgroup 0 is the producer (one
//     thread issues TMA), warpgroups 1 and 2 are consumers owning 64 query
//     rows each; the grid runs over heads fastest and over query blocks from
//     the last, so every head's longest (causal) rows are launched first and
//     the short ones fill the tail;
//   * Q (128 x D) is loaded once by TMA; K and V tiles (128 keys x D, x Dv)
//     stream through a TWO-STAGE ring with a "full" and an "empty" mbarrier
//     for each K and each V slot: tile j+1 is in flight while tile j is
//     contracted, a consumer waits on a tile's barrier right before its
//     first use, and a K slot is given back as soon as its Q K^T is done —
//     DOLMA's dual buffer at the HBM -> shared-memory edge;
//   * S = Q K^T: wgmma.m64n128k16 with Q and K both K-major in 128-byte-
//     swizzled shared memory, one (128 rows x 64 columns) box per 64 columns
//     of D (D is zero-padded to 64, 128 or 192 by TMA, which adds exact
//     zeros): D/16 k-steps, 12 at D 192. At D 192 / Dv 128 the Q tile and
//     the two-stage K, V ring take 1024 + 49152 + 2 x (49152 + 32768) + 72 =
//     214,088 bytes of the 232,448 a block may use;
//   * O += P V: wgmma.m64n{64,128}k16 with A = P in registers (the S
//     accumulator layout is the A-fragment layout of a 16-bit operand, so
//     P is packed to bf16 in place, no shared-memory round trip) and B = V
//     from shared memory, MN-major (Dv contiguous) through the transpose bit;
//   * inside a warpgroup, tile j+1's S is issued before tile j's P V, and
//     tile j+1's softmax runs while P V is on the tensor cores (the
//     accumulator is rescaled only after P V is done);
//   * softmax in the log2 domain (exp2f of s * scale * log2(e)); masks are
//     applied only on tiles that cross the diagonal, the window's edge or
//     Sk; row max over the 4 lanes that share a row, l summed per thread
//     and reduced across those lanes once at the end;
//   * q, k and v are read through their strides (TMA maps of rank 4), so the
//     executor's (B, S, H, D) tensors transposed to (B, H, S, D) need no
//     copy; o is written through its strides;
//   * each output tile belongs to one CTA, which walks the keys in
//     increasing order: no split-KV, no atomics, deterministic.
//
// (2) "ffma", float32 and the shapes the first variant does not take, on the
//   CUDA cores:
//   * one 256-thread block per (b, h, 64-row q-block); a loop over 32-key
//     tiles takes the place of the TPU's sequential kv grid axis;
//   * each warp owns 8 query rows for the whole kernel: lane j computes the
//     score of key j of the tile for its 8 rows, the row max and row sum are
//     warp shuffles, and (m, l) and the row's float32 accumulator (Dv <= 128
//     spread over the 32 lanes) stay in registers;
//   * q is held in shared memory as float32 for the whole kernel, k and v
//     tiles are staged per step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---- (1) the tensor-core variant ---------------------------------------------

namespace tc {

constexpr int BQ = 128;          // query rows per CTA, 64 per consumer warpgroup
constexpr int BKV = 128;         // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int BOX_BYTES = 128 * 128;  // one (128 rows x 64 cols) bf16 box
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, int DVP>  // D and Dv rounded up to 64 or 128
struct Layout {
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int K_BYTES = BKV * DP * 2;
  static constexpr int V_BYTES = BKV * DVP * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int BARRIERS = 1 + 4 * STAGES;  // q; k, v full; k, v empty
  static constexpr int SMEM_BYTES =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + BARRIERS * 8;
};

struct OutStrides {  // element strides of o's batch, head and sequence dims
  long long b, h, s;
};

template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, OutStrides os, int H, int KV,
                   int Sq, int Sk, int Dv, float scale_log2, int causal,
                   int has_window, int window) {
  using L = Layout<DP, DVP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* q_tile = smem;
  auto k_tile = [&](int s) { return smem + L::Q_BYTES + s * L::STAGE_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + L::K_BYTES; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + L::Q_BYTES + STAGES * L::STAGE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int h = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_lo = qb * BQ;
  // the key tiles the reference's `live` test keeps for this CTA's rows
  int kb_lo = 0;
  int kb_hi = (Sk + BKV - 1) / BKV;
  if (causal) kb_hi = min(kb_hi, (q_lo + BQ - 1) / BKV + 1);
  if (has_window) {
    const int x = q_lo - window - (BKV - 1);  // live iff kb * BKV > x
    if (x >= 0) kb_lo = x / BKV + 1;
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        hopper::tma_load_4d(q_tile + c * BOX_BYTES, &qmap, q_full, c * 64,
                            q_lo, h, b);
      for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
        const int s = i % STAGES;
        const uint32_t ph = ((i / STAGES) & 1) ^ 1;
        hopper::mbar_wait(&k_empty[s], ph);
        hopper::mbar_expect_tx(&k_full[s], L::K_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          hopper::tma_load_4d(k_tile(s) + c * BOX_BYTES, &kmap, &k_full[s],
                              c * 64, kb * BKV, kvh, b);
        hopper::mbar_wait(&v_empty[s], ph);
        hopper::mbar_expect_tx(&v_full[s], L::V_BYTES);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          hopper::tma_load_4d(v_tile(s) + c * BOX_BYTES, &vmap, &v_full[s],
                              c * 64, kb * BKV, kvh, b);
      }
    }
  } else {  // consumers
    hopper::regs_alloc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q_lo + cw * 64;           // this warpgroup's rows
    const int r0 = row_lo + (t / 32) * 16 + lane / 4;  // this thread's rows
    const int r1 = r0 + 8;
    const int col = 2 * (lane % 4);              // + 8 j (+ 1): its columns

    float acc[DVP / 2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    // S = Q K^T of the tile in stage s, issued and committed, not waited for
    float sc[BKV / 2];
    auto issue_qk = [&](int s) {
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int sub = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        const uint64_t da = hopper::smem_desc(q_tile + sub + cw * 64 * 128,
                                              16, 1024);
        const uint64_t db = hopper::smem_desc(k_tile(s) + sub, 16, 1024);
        hopper::wgmma_ss_m64n128k16<0>(sc, da, db, 1);
      }
      hopper::wgmma_commit();
    };

    // Online softmax of the scores in sc (key tile kb): scale, mask (only
    // where the tile crosses an edge), new row max, p = exp(s - max) in
    // place, l updated; returns the factors that rescale the accumulator.
    auto softmax = [&](int kb, float& alpha0, float& alpha1) {
      const int k_lo = kb * BKV;
      const bool edge = k_lo + BKV > Sk ||
                        (causal && k_lo + BKV - 1 > row_lo) ||
                        (has_window && k_lo <= row_lo + 63 - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int ki = k_lo + 8 * j + col + (e & 1);
            const int qi = e < 2 ? r0 : r1;
            const bool live = ki < Sk && !(causal && ki > qi) &&
                              !(has_window && ki <= qi - window);
            if (!live) v = NEG_INF;
          }
          sc[4 * j + e] = v;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      alpha0 = exp2f(m0 - n0);
      alpha1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sc[4 * j + e] - (e < 2 ? n0 : n1));
          if (edge && k_lo + 8 * j + col + (e & 1) >= Sk) p = 0.f;
          sc[4 * j + e] = p;
        }
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
    };

    // p rounded to bf16, packed as the A fragments of 8 k-steps of 16 keys
    uint32_t pa[BKV / 16][4];
    auto rescale_and_pack = [&](float alpha0, float alpha1) {
#pragma unroll
      for (int j = 0; j < DVP / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = hopper::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = hopper::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = hopper::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = hopper::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // O += P V of the tile in stage s, issued and committed
    auto issue_pv = [&](int s) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = hopper::smem_desc(v_tile(s) + kk * 16 * 128,
                                              BOX_BYTES, 1024);
        if constexpr (DVP == 128)
          hopper::wgmma_rs_m64n128k16<1>(acc, pa[kk], db, 1);
        else
          hopper::wgmma_rs_m64n64k16<1>(acc, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
    };

    // a slot of the ring goes back to the producer once all 8 consumer
    // warps are done with it
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };

    hopper::mbar_wait(q_full, 0);
    if (kb_lo < kb_hi) {
      float alpha0, alpha1;
      hopper::mbar_wait(&k_full[0], 0);  // access barrier of the first K tile
      issue_qk(0);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(&k_empty[0]);
      softmax(kb_lo, alpha0, alpha1);
      rescale_and_pack(alpha0, alpha1);
    }
    // Tile j (all but the last): pa holds P_j and acc is rescaled for it.
    // Issue S_{j+1}, then P_j V_j; wait for S_{j+1} only and run its softmax
    // while P_j V_j is on the tensor cores; wait for P_j V_j before acc is
    // rescaled. No branch around a wgmma inside the loop: ptxas proves from
    // the straight line which group a wait leaves in flight (with a branch
    // it serialises every wgmma).
    int i = 0;
    for (int kb = kb_lo; kb + 1 < kb_hi; ++kb, ++i) {
      const int s = i % STAGES;
      const int s1 = (i + 1) % STAGES;
      hopper::mbar_wait(&k_full[s1], ((i + 1) / STAGES) & 1);
      issue_qk(s1);
      hopper::mbar_wait(&v_full[s], (i / STAGES) & 1);  // V tile j's barrier
      issue_pv(s);
      float alpha0, alpha1;
      hopper::wgmma_wait<1>();  // S_{j+1} is done, P_j V_j may run on
      hopper::fence_regs(sc);
      release(&k_empty[s1]);    // K tile j+1 is read: its slot is free
      softmax(kb + 1, alpha0, alpha1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      release(&v_empty[s]);     // V tile j is read: its slot is free
      rescale_and_pack(alpha0, alpha1);
    }
    if (kb_lo < kb_hi) {  // the last tile: P V alone
      hopper::mbar_wait(&v_full[i % STAGES], (i / STAGES) & 1);
      issue_pv(i % STAGES);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float ls0 = l0 == 0.f ? 1.f : l0;
    const float ls1 = l1 == 0.f ? 1.f : l1;
    __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= Dv) continue;  // Dv is a multiple of 16
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + r0 * os.s + c) =
            __floats2bfloat162_rn(acc[4 * j] / ls0, acc[4 * j + 1] / ls0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + r1 * os.s + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] / ls1, acc[4 * j + 3] / ls1);
    }
  }
}

// a rank-4 map over (B, heads, S, width) given by element strides,
// innermost first as TMA wants it: (width, S, heads, B)
int head_map(CUtensorMap* map, const void* base, int B, int heads, int S,
             int width, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

template <int DP, int DVP>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
           void* o, OutStrides os, int B, int H, int KV, int Sq, int Sk,
           int Dv, float scale, int causal, int has_window, int window,
           cudaStream_t stream) {
  const int smem = Layout<DP, DVP>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  flash_wgmma_kernel<DP, DVP><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), os, H, KV, Sq, Sk, Dv,
      scale * LOG2E, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16. q (B,H,Sq,D), k (B,KV,Sk,D),
// v (B,KV,Sk,Dv), o (B,H,Sq,Dv), each given by its base pointer and the
// element strides of its batch, head and sequence dims (the last dim is
// contiguous). D % 4 == 0, D <= 192 and Dv <= 128 (q staged as float32
// [64][D]: 98,432 bytes of dynamic shared memory at D 192). The FFMA variant.
// Launches on `stream`;
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

// The tensor-core variant: bf16 q, k, v, o as above; D and Dv multiples of
// 16, D at most 192 and Dv at most 128; every stride a multiple of 8 elements and q, k, v
// 16-byte aligned (TMA). Launches on `stream`; returns 0, a CUDA error code,
// or one above hopper::kTensorMapError.
extern "C" int flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int KV, int Sq, int Sk, int D, int Dv,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss,
    float scale, int causal, int has_window, int window, void* stream) {
  CUtensorMap qm, km, vm;
  int err = tc::head_map(&qm, q, B, H, Sq, D, qsb, qsh, qss);
  if (err == 0) err = tc::head_map(&km, k, B, KV, Sk, D, ksb, ksh, kss);
  if (err == 0) err = tc::head_map(&vm, v, B, KV, Sk, Dv, vsb, vsh, vss);
  if (err != 0) return err;
  const tc::OutStrides os{osb, osh, oss};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 128)  // MLA: three 64-column boxes of Q and K per row
    return tc::launch<192, 128>(qm, km, vm, o, os, B, H, KV, Sq, Sk, Dv,
                                scale, causal, has_window, window, s);
  if (D <= 64 && Dv <= 64)
    return tc::launch<64, 64>(qm, km, vm, o, os, B, H, KV, Sq, Sk, Dv, scale,
                              causal, has_window, window, s);
  if (D <= 64)
    return tc::launch<64, 128>(qm, km, vm, o, os, B, H, KV, Sq, Sk, Dv, scale,
                               causal, has_window, window, s);
  if (Dv <= 64)
    return tc::launch<128, 64>(qm, km, vm, o, os, B, H, KV, Sq, Sk, Dv, scale,
                               causal, has_window, window, s);
  return tc::launch<128, 128>(qm, km, vm, o, os, B, H, KV, Sq, Sk, Dv, scale,
                              causal, has_window, window, s);
}

extern "C" const char* kernel_error_string(int code) {
  return hopper::error_string(code);
}
