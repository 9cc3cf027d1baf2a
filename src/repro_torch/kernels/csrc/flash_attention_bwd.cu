// Backward of flash attention (kernel B2) for Hopper (sm_90a): dq, dk and dv
// from the forward's saved (q, k, v, o, lse) and dO.
//
// Replaces no TPU kernel: the reference's `_flash_vjp`
// (src/repro/kernels/flash_attention.py) recomputes its backward through
// jnp, and the port's plain version of this kernel is that backward in
// torch (kernels/flash_attention.py::_plain_bwd, which runs
// models/flash.py::_flash_bwd). This file computes the same blocked
// backward on the card:
//
//   delta_i = sum_d dO_id o_id                       (float32, a pre-pass)
//   p_ij    = exp(s_ij scale - lse_i), s = q k^T     (float32 scores, C2)
//   dv_j   += sum_i p_ij dO_i
//   dp_ij   = dO_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i) scale
//   dq_i   += sum_j ds_ij k_j
//   dk_j   += sum_i ds_ij q_i
//
// over the live (query, key) pairs of the forward's masks (GQA, causal,
// sliding window, full, cross attention with Sq != Sk, Dv != D); a masked
// pair has p = 0 exactly, so a row or key that meets no live pair gets zero
// gradients.
//
// Bound on the H100: at granite-8b's train shape (B 2, H 32, KV 8, S 2048,
// D = Dv = 128, causal, bf16) the five products over the live half of the
// score matrix (the recomputed q k^T, dO v^T, p^T dO, ds k, ds^T q: 2.5x the
// forward's two) are 2.5 x 4 x 2 x 32 x 128 x 2048 x 2049 / 2 = 171.9 GFLOP
// on 168 MB of q, k, v, o, dO, lse, dq, dk and dv: bound by operations,
// 0.174 ms at the bf16 tensor-core peak (989 TFLOP/s).
//
// Two variants, picked by the wrapper's plain rule on dtype and shape
// (kernels/flash_attention.py::_bwd_variant):
//
// (1) "wgmma", bf16 with D and Dv multiples of 16, D at most 192 and Dv at
//   most 128, three kernels launched back to back:
//   * delta, the bf16 rows read 16 bytes a lane (dO . o in float32);
//   * dk and dv: one CTA per (KV head, 128 keys, b); warpgroup 0 is the
//     producer (one thread issues TMA, one warp stages each tile's lse and
//     delta in shared memory), warpgroups 1 and 2 own 64 keys each. The
//     CTA's K and V tiles are loaded once; the query tiles (64 rows of q and
//     dO) of the G query heads of its group stream through a THREE-STAGE
//     ring with a "full" and an "empty" mbarrier per slot, in a fixed order
//     (head, then query tile). Each warpgroup works on the transposed
//     tiles, keys as rows, so that every product is a wgmma:
//       S^T  = K Q^T    wgmma.m64n64k16, both operands K-major in shared
//                       memory (128-byte swizzle, as the forward's Q K^T);
//       dP^T = V dO^T   the same, over Dv;
//       dV  += P^T dO   register A (the S^T accumulator layout is the A
//                       fragment layout of a 16-bit operand: P^T is packed
//                       to bf16 in place) and B = dO MN-major (the transpose
//                       bit), m64n{Dv}k16;
//       dK  += dS^T Q   the same with dS^T and Q (dS / scale: the scale is
//                       applied once, to dk, as to dq).
//     S^T and dP^T are two commit groups, so the exp runs while dP^T is on
//     the tensor cores, and dS^T while dV is; where the registers allow
//     (runs_ahead: every padded (D, Dv) but (128, 128)), the next tile's
//     S^T and dP^T are issued before this tile's dK is done, and a ring
//     slot is given back as soon as its last product has finished. dk and
//     dv are summed in registers over every query tile and head and written
//     once;
//   * dq: one CTA per (head, 128 query rows, b), the longest rows first:
//     the Q and dO tiles loaded once, K and V tiles (128 keys at D <= 64,
//     else 64) streamed through a two-stage ring; S = Q K^T and dP = dO
//     V^T (wgmma.m64n128k16 at D <= 64, m64n64k16 above, both K-major) as
//     two commit groups, then dQ += dS K (register A, K MN-major); always
//     running ahead: the next tile's S and dP queue behind this tile's dQ.
//     Its rows' lse and delta are read once.
//   Where the dk/dv grid is short of the card (few KV heads: glm4-9b's 2,
//   granite-34b's 1, at a train batch of 2 that is 64 and 32 CTAs for 132
//   SMs, each CTA over a group of 16 or 48 heads) the wrapper splits each
//   group's query heads into parts (kernels/flash_attention.py::_bwd_parts,
//   about two CTAs an SM): a CTA a (KV head, part, 128 keys, b) sums its
//   part's heads into a float32 scratch, and flash_bwd_dkdv_reduce adds the
//   parts in order, scales dk and writes both in bf16. At one part (every
//   grid of 88 CTAs or more) no scratch is used and dk, dv are written as
//   before.
//   p and ds are float32 until they are packed to bf16 as wgmma's A operand
//   (the plain version multiplies them in float32: a rounding of 2^-9 per
//   element, averaged over the keys); exp2 on the special-function unit
//   (ex2.approx). The masks are applied element by element only where the
//   tile crosses an edge, in a copy of the exp loop of its own (a mask
//   test left in the loop, even behind the tile's flag, cost a fifth of the
//   time); whole tiles the masks kill are never loaded. No
//   wgmma sits under a branch (ptxas would serialise them all), and ptxas
//   spills nothing in these kernels.
//   What holds it back: the dq kernel recomputes S and dP, 2 of the 5
//   products a second time (7 in all, 1.4x the bound's count); the two
//   score products of the dk/dv kernel read both operands from shared
//   memory at m64n64, which takes all of its 128 bytes a cycle; and at
//   D = Dv = 128 the dk and dv accumulators (128 floats a thread) leave no
//   room to run ahead, so each warpgroup drains its tensor-core queue at the
//   end of every tile and relies on the other warpgroup to fill the gap.
//   At D > 128 (MLA's 192, D padded to 192 by TMA's zeros in three 64-column
//   boxes) the dk/dv accumulators do not fit one warpgroup beside its score
//   tiles: a CTA owns 64 keys and its two consumer warpgroups split each
//   tile's products, S^T, P^T and dV in one and dP^T, dS^T and dK in the
//   other, P^T handed over through shared memory in float32
//   (flash_bwd_dkdv_split); the dq kernel is the same at 64-key tiles, its
//   dQ += dS K an n128 and an n64 product. Both grids put a head's tiles
//   next to each other there, so that the stream they share stays in L2.
//   PERF.md's Findings list the variants measured on the card and not kept.
//
// (2) "ffma", float32 and the shapes the first variant does not take, on
//   the CUDA cores, in the forward's "ffma" layout: dq with one
//   256-thread block per (b, head, 64 query rows), each warp owning 8 rows
//   and lane j computing key j of a 32-key tile; dk and dv with one block
//   per (b, KV head, 32 keys), each warp owning 4 keys and lane i computing
//   query i of a 32-row tile, over the group's heads. The sums run in
//   three levels: a tile's 32 rows, then the head's tiles (in registers),
//   then the group's heads (in shared memory): one float32 chain over all
//   G x Sq query rows loses the plain version's accuracy from a group of 9
//   heads on (C10), and 32 keys a block leave registers for the tile's
//   sums. float32
//   scores and exp as the plain version; its sums run in another order.
//
// Deterministic: every output element is summed by one thread in one fixed
// order (the query tiles and heads of a key tile, or the key tiles of a
// query tile, each walked in increasing order; a split group's parts each
// so, then added in part order by one thread of the reduce kernel); no
// atomics, and the order does not depend on timing, so two launches on the
// same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Strides {  // element strides of the batch, head and sequence dims
  long long b, h, s;
};

struct Mask {
  int Sq, Sk, causal, has_window, window;
  __device__ __forceinline__ bool live(int qi, int ki) const {
    return qi < Sq && ki < Sk && !(causal && ki > qi) &&
           !(has_window && ki <= qi - window);
  }
};

// ---- delta = rowsum(dO o), one warp per (b, h, row) -------------------------

constexpr int DELTA_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq, int Dv,
                       Strides os, Strides ds, long long rows) {
  const long long row = (long long)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = static_cast<int>(row % Sq);
  const int h = static_cast<int>((row / Sq) % H);
  const long long b = row / ((long long)Sq * H);
  const T* op = o + b * os.b + h * os.h + i * os.s;
  const T* dp = dout + b * ds.b + h * ds.h + i * ds.s;
  float acc = 0.f;
  for (int c = lane; c < Dv; c += 32) acc = fmaf(to_f32(dp[c]), to_f32(op[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// the same for bf16 rows of 16-byte aligned chunks (Dv % 8 == 0, Dv <= 128):
// 16 lanes a row, 8 columns a lane, two rows a warp
__global__ void __launch_bounds__(DELTA_THREADS)
flash_bwd_delta_vec(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, int H, int Sq, int Dv, Strides os, Strides ds,
                    long long rows) {
  const long long row = (long long)blockIdx.x * (DELTA_THREADS / 16) + threadIdx.x / 16;
  const int c = 8 * (threadIdx.x % 16);
  float acc = 0.f;
  if (row < rows && c < Dv) {
    const int i = static_cast<int>(row % Sq);
    const int h = static_cast<int>((row / Sq) % H);
    const long long b = row / ((long long)Sq * H);
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + i * os.s + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * ds.b + h * ds.h + i * ds.s + c);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(op[e]), y = __bfloat1622float2(dp[e]);
      acc = fmaf(y.x, x.x, acc);
      acc = fmaf(y.y, x.y, acc);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && threadIdx.x % 16 == 0) delta[row] = acc;
}

// ---- (2) ffma: dq -------------------------------------------------------------

constexpr int FB_THREADS = 256;
constexpr int FB_WARPS = FB_THREADS / 32;
constexpr int FQ_ROWS = 64;               // query rows of a dq block
constexpr int FQ_KT = 32;                 // keys of a tile (one per lane)
constexpr int FQ_PER_WARP = FQ_ROWS / FB_WARPS;
constexpr int FK_KEYS = 32;               // keys of a dk/dv block
constexpr int FK_QT = 32;                 // query rows of a tile (one per lane)
constexpr int FK_PER_WARP = FK_KEYS / FB_WARPS;
constexpr int MAX_D = 192;
constexpr int MAX_DV = 128;
constexpr int D_PER_LANE = MAX_D / 32;
constexpr int DV_PER_LANE = MAX_DV / 32;

struct Args {
  int H, KV, Sq, Sk, D, Dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  float scale;
  Mask mask;
};

template <typename T>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_ffma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  T* __restrict__ dq, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, Dv = a.Dv;
  float* qsm = smem;                        // [64][D]
  float* dosm = qsm + FQ_ROWS * D;          // [64][Dv]
  float* ksm = dosm + FQ_ROWS * Dv;         // [32][D + 1]
  float* vsm = ksm + FQ_KT * (D + 1);       // [32][Dv + 1]
  float* dss = vsm + FQ_KT * (Dv + 1);      // [64][32]

  const int q_lo = blockIdx.x * FQ_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * FQ_PER_WARP;
  const T* qp = q + b * a.qs.b + h * a.qs.h;
  const T* dop = dout + b * a.dos.b + h * a.dos.h;
  const T* kp = k + b * a.ks.b + kvh * a.ks.h;
  const T* vp = v + b * a.vs.b + kvh * a.vs.h;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;
  const float* delta = a.delta + ((long long)b * a.H + h) * a.Sq;

  for (int e = tid; e < FQ_ROWS * D; e += FB_THREADS) {
    const int qi = q_lo + e / D;
    qsm[e] = qi < a.Sq ? to_f32(qp[qi * a.qs.s + e % D]) : 0.f;
  }
  for (int e = tid; e < FQ_ROWS * Dv; e += FB_THREADS) {
    const int qi = q_lo + e / Dv;
    dosm[e] = qi < a.Sq ? to_f32(dop[qi * a.dos.s + e % Dv]) : 0.f;
  }
  float lse_r[FQ_PER_WARP], delta_r[FQ_PER_WARP];
  float acc[FQ_PER_WARP][D_PER_LANE];
#pragma unroll
  for (int i = 0; i < FQ_PER_WARP; ++i) {
    const int qi = min(q_lo + row0 + i, a.Sq - 1);
    lse_r[i] = lse[qi];
    delta_r[i] = delta[qi];
#pragma unroll
    for (int j = 0; j < D_PER_LANE; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (a.Sk + FQ_KT - 1) / FQ_KT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_lo = kt * FQ_KT;
    if (a.mask.causal && k_lo > q_lo + FQ_ROWS - 1) break;
    if (a.mask.has_window && k_lo + FQ_KT <= q_lo - a.mask.window + 1) continue;
    __syncthreads();  // the previous tile's reads are done
    for (int e = tid; e < FQ_KT * D; e += FB_THREADS) {
      const int r = e / D, key = k_lo + r;
      ksm[r * (D + 1) + e % D] = key < a.Sk ? to_f32(kp[key * a.ks.s + e % D]) : 0.f;
    }
    for (int e = tid; e < FQ_KT * Dv; e += FB_THREADS) {
      const int r = e / Dv, key = k_lo + r;
      vsm[r * (Dv + 1) + e % Dv] = key < a.Sk ? to_f32(vp[key * a.vs.s + e % Dv]) : 0.f;
    }
    __syncthreads();

    float s[FQ_PER_WARP], dp[FQ_PER_WARP];
#pragma unroll
    for (int i = 0; i < FQ_PER_WARP; ++i) s[i] = dp[i] = 0.f;
    const float* krow = ksm + lane * (D + 1);
    for (int d = 0; d < D; d += 4) {
      const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2], k3 = krow[d + 3];
#pragma unroll
      for (int i = 0; i < FQ_PER_WARP; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qsm + (row0 + i) * D + d);
        s[i] = fmaf(qv.x, k0, s[i]);
        s[i] = fmaf(qv.y, k1, s[i]);
        s[i] = fmaf(qv.z, k2, s[i]);
        s[i] = fmaf(qv.w, k3, s[i]);
      }
    }
    const float* vrow = vsm + lane * (Dv + 1);
    for (int d = 0; d < Dv; ++d) {
      const float vv = vrow[d];
#pragma unroll
      for (int i = 0; i < FQ_PER_WARP; ++i)
        dp[i] = fmaf(dosm[(row0 + i) * Dv + d], vv, dp[i]);
    }
    const int ki = k_lo + lane;
#pragma unroll
    for (int i = 0; i < FQ_PER_WARP; ++i) {
      const int qi = q_lo + row0 + i;
      const float p = a.mask.live(qi, ki) ? expf(s[i] * a.scale - lse_r[i]) : 0.f;
      dss[(row0 + i) * FQ_KT + lane] = p * (dp[i] - delta_r[i]) * a.scale;
    }
    __syncwarp();
    for (int kk = 0; kk < FQ_KT; ++kk) {
#pragma unroll
      for (int j = 0; j < D_PER_LANE; ++j) {
        const int c = lane + 32 * j;
        const float kv = c < D ? ksm[kk * (D + 1) + c] : 0.f;
#pragma unroll
        for (int i = 0; i < FQ_PER_WARP; ++i)
          acc[i][j] = fmaf(dss[(row0 + i) * FQ_KT + kk], kv, acc[i][j]);
      }
    }
  }

  T* dqp = dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < FQ_PER_WARP; ++i) {
    const int qi = q_lo + row0 + i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < D_PER_LANE; ++j) {
      const int c = lane + 32 * j;
      if (c < D) store_out(dqp + qi * a.dqs.s + c, acc[i][j]);
    }
  }
}

// ---- (2) ffma: dk and dv ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkdv_ffma(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    T* __restrict__ dk, T* __restrict__ dv, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, Dv = a.Dv;
  float* ksm = smem;                        // [32][D]
  float* vsm = ksm + FK_KEYS * D;           // [32][Dv]
  float* qsm = vsm + FK_KEYS * Dv;          // [32][D + 1]
  float* dosm = qsm + FK_QT * (D + 1);      // [32][Dv + 1]
  float* ps = dosm + FK_QT * (Dv + 1);      // [32][32]
  float* dss = ps + FK_KEYS * FK_QT;        // [32][32]
  float* tot = dss + FK_KEYS * FK_QT;       // [32][D + Dv]: the heads done

  const int k_lo = blockIdx.x * FK_KEYS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * FK_PER_WARP;
  const T* kp = k + b * a.ks.b + kvh * a.ks.h;
  const T* vp = v + b * a.vs.b + kvh * a.vs.h;
  for (int e = tid; e < FK_KEYS * D; e += FB_THREADS) {
    const int key = k_lo + e / D;
    ksm[e] = key < a.Sk ? to_f32(kp[key * a.ks.s + e % D]) : 0.f;
  }
  for (int e = tid; e < FK_KEYS * Dv; e += FB_THREADS) {
    const int key = k_lo + e / Dv;
    vsm[e] = key < a.Sk ? to_f32(vp[key * a.vs.s + e % Dv]) : 0.f;
  }
  // this head's sums; a thread's (key, column) elements of tot are its own
  float dk_acc[FK_PER_WARP][D_PER_LANE], dv_acc[FK_PER_WARP][DV_PER_LANE];
  auto head_done = [&](bool first) {  // tot (=)+= the head's sums, which restart
#pragma unroll
    for (int i = 0; i < FK_PER_WARP; ++i) {
      float* t = tot + (row0 + i) * (D + Dv);
#pragma unroll
      for (int j = 0; j < D_PER_LANE; ++j) {
        const int c = lane + 32 * j;
        if (c < D) t[c] = first ? dk_acc[i][j] : t[c] + dk_acc[i][j];
        dk_acc[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < DV_PER_LANE; ++j) {
        const int c = lane + 32 * j;
        if (c < Dv) t[D + c] = first ? dv_acc[i][j] : t[D + c] + dv_acc[i][j];
        dv_acc[i][j] = 0.f;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < FK_PER_WARP; ++i) {
#pragma unroll
    for (int j = 0; j < D_PER_LANE; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DV_PER_LANE; ++j) dv_acc[i][j] = 0.f;
  }

  // the query tiles that meet these keys
  const int k_max = min(k_lo + FK_KEYS, a.Sk) - 1;
  int qt_lo = 0, qt_hi = (a.Sq + FK_QT - 1) / FK_QT;
  if (a.mask.causal) qt_lo = k_lo / FK_QT;
  if (a.mask.has_window) qt_hi = min(qt_hi, (k_max + a.mask.window - 1) / FK_QT + 1);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qp = q + b * a.qs.b + h * a.qs.h;
    const T* dop = dout + b * a.dos.b + h * a.dos.h;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;
    const float* delta = a.delta + ((long long)b * a.H + h) * a.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q_lo = qt * FK_QT;
      __syncthreads();  // the previous tile's reads are done (and k, v loaded)
      for (int e = tid; e < FK_QT * D; e += FB_THREADS) {
        const int r = e / D, qi = q_lo + r;
        qsm[r * (D + 1) + e % D] = qi < a.Sq ? to_f32(qp[qi * a.qs.s + e % D]) : 0.f;
      }
      for (int e = tid; e < FK_QT * Dv; e += FB_THREADS) {
        const int r = e / Dv, qi = q_lo + r;
        dosm[r * (Dv + 1) + e % Dv] = qi < a.Sq ? to_f32(dop[qi * a.dos.s + e % Dv]) : 0.f;
      }
      __syncthreads();

      float s[FK_PER_WARP], dp[FK_PER_WARP];
#pragma unroll
      for (int i = 0; i < FK_PER_WARP; ++i) s[i] = dp[i] = 0.f;
      const float* qrow = qsm + lane * (D + 1);
      for (int d = 0; d < D; d += 4) {
        const float q0 = qrow[d], q1 = qrow[d + 1], q2 = qrow[d + 2], q3 = qrow[d + 3];
#pragma unroll
        for (int i = 0; i < FK_PER_WARP; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(ksm + (row0 + i) * D + d);
          s[i] = fmaf(q0, kv.x, s[i]);
          s[i] = fmaf(q1, kv.y, s[i]);
          s[i] = fmaf(q2, kv.z, s[i]);
          s[i] = fmaf(q3, kv.w, s[i]);
        }
      }
      const float* dorow = dosm + lane * (Dv + 1);
      for (int d = 0; d < Dv; ++d) {
        const float dv_ = dorow[d];
#pragma unroll
        for (int i = 0; i < FK_PER_WARP; ++i)
          dp[i] = fmaf(dv_, vsm[(row0 + i) * Dv + d], dp[i]);
      }
      const int qi = q_lo + lane;
      const int qc = min(qi, a.Sq - 1);
      const float lse_q = lse[qc], delta_q = delta[qc];
#pragma unroll
      for (int i = 0; i < FK_PER_WARP; ++i) {
        const int ki = k_lo + row0 + i;
        const float p = a.mask.live(qi, ki) ? expf(s[i] * a.scale - lse_q) : 0.f;
        ps[(row0 + i) * FK_QT + lane] = p;
        dss[(row0 + i) * FK_QT + lane] = p * (dp[i] - delta_q) * a.scale;
      }
      __syncwarp();
      // the tile's 32 rows summed apart, then added to the head's sums
      float tk[FK_PER_WARP][D_PER_LANE], tv[FK_PER_WARP][DV_PER_LANE];
#pragma unroll
      for (int i = 0; i < FK_PER_WARP; ++i) {
#pragma unroll
        for (int j = 0; j < D_PER_LANE; ++j) tk[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < DV_PER_LANE; ++j) tv[i][j] = 0.f;
      }
      for (int qq = 0; qq < FK_QT; ++qq) {
#pragma unroll
        for (int j = 0; j < DV_PER_LANE; ++j) {
          const int c = lane + 32 * j;
          const float dov = c < Dv ? dosm[qq * (Dv + 1) + c] : 0.f;
#pragma unroll
          for (int i = 0; i < FK_PER_WARP; ++i)
            tv[i][j] = fmaf(ps[(row0 + i) * FK_QT + qq], dov, tv[i][j]);
        }
#pragma unroll
        for (int j = 0; j < D_PER_LANE; ++j) {
          const int c = lane + 32 * j;
          const float qv = c < D ? qsm[qq * (D + 1) + c] : 0.f;
#pragma unroll
          for (int i = 0; i < FK_PER_WARP; ++i)
            tk[i][j] = fmaf(dss[(row0 + i) * FK_QT + qq], qv, tk[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < FK_PER_WARP; ++i) {
#pragma unroll
        for (int j = 0; j < D_PER_LANE; ++j) dk_acc[i][j] += tk[i][j];
#pragma unroll
        for (int j = 0; j < DV_PER_LANE; ++j) dv_acc[i][j] += tv[i][j];
      }
    }
    head_done(g == 0);
  }

  T* dkp = dk + b * a.dks.b + kvh * a.dks.h;
  T* dvp = dv + b * a.dvs.b + kvh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < FK_PER_WARP; ++i) {
    const int ki = k_lo + row0 + i;
    if (ki >= a.Sk) continue;
    const float* t = tot + (row0 + i) * (D + Dv);
#pragma unroll
    for (int j = 0; j < D_PER_LANE; ++j) {
      const int c = lane + 32 * j;
      if (c < D) store_out(dkp + ki * a.dks.s + c, t[c]);
    }
#pragma unroll
    for (int j = 0; j < DV_PER_LANE; ++j) {
      const int c = lane + 32 * j;
      if (c < Dv) store_out(dvp + ki * a.dvs.s + c, t[D + c]);
    }
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool chunks_of_16_bytes(const void* p, Strides st) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && st.b % 8 == 0 && st.h % 8 == 0 &&
         st.s % 8 == 0;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int H,
                 int Sq, int Dv, Strides os, Strides ds, cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  if (sizeof(T) == 2 && Dv % 8 == 0 && Dv <= 128 && chunks_of_16_bytes(o, os) &&
      chunks_of_16_bytes(dout, ds)) {
    const int per_block = DELTA_THREADS / 16;
    flash_bwd_delta_vec<<<(unsigned)((rows + per_block - 1) / per_block), DELTA_THREADS, 0,
                           stream>>>(static_cast<const __nv_bfloat16*>(o),
                                     static_cast<const __nv_bfloat16*>(dout), delta, H, Sq, Dv,
                                     os, ds, rows);
    return static_cast<int>(cudaGetLastError());
  }
  const int per = DELTA_THREADS / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, Sq, Dv, os, ds, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ffma(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, int B, const Args& a,
                cudaStream_t stream) {
  const int D = a.D, Dv = a.Dv;
  const size_t dq_smem = sizeof(float) *
      (size_t)(FQ_ROWS * D + FQ_ROWS * Dv + FQ_KT * (D + 1) + FQ_KT * (Dv + 1) + FQ_ROWS * FQ_KT);
  const size_t kv_smem = sizeof(float) *
      (size_t)(FK_KEYS * D + FK_KEYS * Dv + FK_QT * (D + 1) + FK_QT * (Dv + 1) +
               2 * FK_KEYS * FK_QT + FK_KEYS * (D + Dv));
  cudaError_t err = set_smem(reinterpret_cast<const void*>(flash_bwd_dkdv_ffma<T>), kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem(reinterpret_cast<const void*>(flash_bwd_dq_ffma<T>), dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_ffma<T><<<dim3((a.Sk + FK_KEYS - 1) / FK_KEYS, a.KV, B), FB_THREADS, kv_smem,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_ffma<T><<<dim3((a.Sq + FQ_ROWS - 1) / FQ_ROWS, a.H, B), FB_THREADS, dq_smem,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- (1) the tensor-core variant ---------------------------------------------

namespace tcb {

constexpr int THREADS = 384;
constexpr int BIG = 128;             // keys of a dk/dv CTA, query rows of a dq CTA
constexpr int BIG_BOX = BIG * 128;   // one (128 rows x 64 cols) bf16 box
constexpr int BQ = 64;               // query rows of a dk/dv tile
constexpr int BQ_BOX = BQ * 128;     // one (64 rows x 64 cols) bf16 box
constexpr int KV_STAGES = 3;         // the dk/dv kernel's ring of query tiles
constexpr int Q_STAGES = 2;          // the dq kernel's ring of key tiles

// D(64x64, f32) (+)= A(64x16, bf16, shared) * B(16x64, bf16, shared), both K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// acc (64 x N) = A (the 64 rows from a_row of a tile of a_box-byte boxes) *
// B^T (the N rows of a tile of b_box-byte boxes), both K-major over KP
// columns; the first k-step overwrites acc (scale-d 0)
template <int N, int KP>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], const unsigned char* a_tile,
                                           int a_box, int a_row, const unsigned char* b_tile,
                                           int b_box) {
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    const int sub = (kk % 4) * 32;
    const uint64_t da = hopper::smem_desc(a_tile + (kk / 4) * a_box + a_row * 128 + sub, 16, 1024);
    const uint64_t db = hopper::smem_desc(b_tile + (kk / 4) * b_box + sub, 16, 1024);
    if constexpr (N == 128)
      hopper::wgmma_ss_m64n128k16<0>(acc, da, db, kk > 0);
    else
      wgmma_ss_m64n64k16(acc, da, db, kk > 0);
  }
}

// acc (64 x N) += A (registers, KS k-steps of 16) * B (an MN-major tile in
// shared memory: KS * 16 rows of K; N = 64, 128 or 192 in boxes of `box`
// bytes). N = 192 is an n128 product over the first two boxes and an n64
// over the third: their accumulators are acc's first 64 and last 32 floats
// in the layout of one n192 product.
template <int N, int KS>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2], const uint32_t (&a)[KS][4],
                                           const unsigned char* tile, int box) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = hopper::smem_desc(tile + kk * 16 * 128, box, 1024);
    if constexpr (N == 192) {
      hopper::wgmma_rs_m64n128k16<1>(*reinterpret_cast<float(*)[64]>(&acc[0]), a[kk], db, 1);
      hopper::wgmma_rs_m64n64k16<1>(*reinterpret_cast<float(*)[32]>(&acc[64]), a[kk],
                                    hopper::smem_desc(tile + 2 * box + kk * 16 * 128, box, 1024),
                                    1);
    } else if constexpr (N == 128) {
      hopper::wgmma_rs_m64n128k16<1>(acc, a[kk], db, 1);
    } else {
      hopper::wgmma_rs_m64n64k16<1>(acc, a[kk], db, 1);
    }
  }
}

// an accumulator of KS * 16 columns packed to bf16 as KS k-steps of register A
template <int KS>
__device__ __forceinline__ void pack(uint32_t (&a)[KS][4], const float (&x)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = hopper::pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = hopper::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = hopper::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = hopper::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// 2^x on the special-function unit (flushes denormal results to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

struct TcArgs {
  int H, KV, Sq, Sk, D, Dv;
  Strides dqs, dks, dvs;
  const float* lse;
  const float* delta;
  float scale, scale_log2;
  Mask mask;
  // the parts a group's query heads are split into (dk/dv at D <= 128), and
  // where parts > 1 their float32 scratch (parts, B, Sk, KV, D + Dv)
  int parts;
  float* part;
};

// Whether a consumer runs ahead: issues the next tile's S^T and dP^T (S and
// dP) before this tile's last product (dK, dQ) is done. That keeps the last
// product's dS operand and accumulator (`acc` floats a thread) in flight
// beside the two new score tiles (`tile` columns each), so it is done only
// where they fit in a consumer's registers: about 192 live floats, above
// which ptxas serialises the wgmma (C7512). Granite-8b's D = Dv = 128 does
// not fit.
constexpr bool runs_ahead(int acc, int tile) { return acc + tile + tile / 4 <= 192; }

template <int DP, int DVP>
struct KvLayout {
  static constexpr bool AHEAD = runs_ahead((DP + DVP) / 2, BQ);
  static constexpr int K_BYTES = BIG * DP * 2;
  static constexpr int V_BYTES = BIG * DVP * 2;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int O_BYTES = BQ * DVP * 2;
  static constexpr int STAGE_BYTES = Q_BYTES + O_BYTES;
  static constexpr int ROWS = 2 * BQ;  // a tile's lse * log2(e), then its delta
  static constexpr int BARRIERS = 1 + 2 * KV_STAGES;
  static constexpr int SMEM_BYTES = 1024 + K_BYTES + V_BYTES + KV_STAGES * STAGE_BYTES +
                                    KV_STAGES * ROWS * 4 + BARRIERS * 8;
};

// dk, dv: grid (KV x parts, key tiles of 128, B), the key tiles with the
// most query tiles (the first, under the causal mask) launched first. A
// CTA streams the query heads of its part of the group (all of them at one
// part); with more than one part it writes its unscaled float32 sums to the
// scratch, which flash_bwd_dkdv_reduce adds up.
template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     TcArgs a) {
  using L = KvLayout<DP, DVP>;
  constexpr bool AHEAD = L::AHEAD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* k_tile = smem;
  unsigned char* v_tile = smem + L::K_BYTES;
  unsigned char* ring = v_tile + L::V_BYTES;
  auto q_tile = [&](int s) { return ring + s * L::STAGE_BYTES; };
  auto do_tile = [&](int s) { return q_tile(s) + L::Q_BYTES; };
  float* rows = reinterpret_cast<float*>(ring + KV_STAGES * L::STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + KV_STAGES * L::ROWS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + KV_STAGES;

  const int kvh = blockIdx.x / a.parts, part = blockIdx.x % a.parts;
  const int kb = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  // this part's heads of the group, g_lo .. g_hi - 1 (all G at one part)
  const int g_lo = part * G / a.parts, g_hi = (part + 1) * G / a.parts;
  const int h_lo = kvh * G + g_lo;
  const int k_lo = kb * BIG;
  const int k_max = min(k_lo + BIG, a.Sk) - 1;
  int qt_lo = 0, qt_hi = (a.Sq + BQ - 1) / BQ;
  if (a.mask.causal) qt_lo = k_lo / BQ;
  if (a.mask.has_window) qt_hi = min(qt_hi, (k_max + a.mask.window - 1) / BQ + 1);
  const int nq = max(qt_hi - qt_lo, 0);
  const int n_tiles = (g_hi - g_lo) * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA thread's and the row warp's lanes
      hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {  // TMA: K and V once, then the ring
      hopper::mbar_expect_tx(kv_full, L::K_BYTES + L::V_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        hopper::tma_load_4d(k_tile + c * BIG_BOX, &kmap, kv_full, c * 64, k_lo, kvh, b);
#pragma unroll
      for (int c = 0; c < DVP / 64; ++c)
        hopper::tma_load_4d(v_tile + c * BIG_BOX, &vmap, kv_full, c * 64, k_lo, kvh, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % KV_STAGES;
        const int h = h_lo + it / nq;
        const int q_lo = (qt_lo + it % nq) * BQ;
        hopper::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          hopper::tma_load_4d(q_tile(s) + c * BQ_BOX, &qmap, &full[s], c * 64, q_lo, h, b);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          hopper::tma_load_4d(do_tile(s) + c * BQ_BOX, &domap, &full[s], c * 64, q_lo, h, b);
      }
    } else if (threadIdx.x / 32 == 1) {  // the row warp: each tile's lse and delta
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % KV_STAGES;
        const int h = h_lo + it / nq;
        const int q_lo = (qt_lo + it % nq) * BQ;
        const long long base = ((long long)b * a.H + h) * a.Sq;
        hopper::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        float* r = rows + s * L::ROWS;
        for (int i = lane; i < BQ; i += 32) {
          const int qi = min(q_lo + i, a.Sq - 1);
          r[i] = a.lse[base + qi] * LOG2E;
          r[BQ + i] = a.delta[base + qi];
        }
        hopper::mbar_arrive(&full[s]);  // releases the rows' stores to the consumers
      }
    }
  } else {  // consumers: 64 keys each, keys as the rows of every tile
    hopper::regs_alloc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = k_lo + cw * 64;                 // this warpgroup's keys
    const int k0 = row_lo + (t / 32) * 16 + lane / 4;  // this thread's keys
    const int k1 = k0 + 8;
    const int col = 2 * (lane % 4);                    // + 8 j (+ 1): its queries

    float dk_acc[DP / 2], dv_acc[DVP / 2];
    zero(dk_acc);
    zero(dv_acc);
    float st[BQ / 2], dpt[BQ / 2];
    uint32_t da[BQ / 16][4];  // dS^T, read by dK's product
    auto wait_full = [&](int it) {
      hopper::mbar_wait(&full[it % KV_STAGES], (it / KV_STAGES) & 1);
    };
    auto issue_s = [&](int it) {  // S^T = K Q^T, a commit group
      hopper::wgmma_fence();
      ss_product<BQ, DP>(st, k_tile, BIG_BOX, cw * 64, q_tile(it % KV_STAGES), BQ_BOX);
      hopper::wgmma_commit();
    };
    auto issue_dp = [&](int it) {  // dP^T = V dO^T, a commit group
      hopper::wgmma_fence();
      ss_product<BQ, DVP>(dpt, v_tile, BIG_BOX, cw * 64, do_tile(it % KV_STAGES), BQ_BOX);
      hopper::wgmma_commit();
    };
    auto release = [&](int it) {  // every product that reads tile `it` is done
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[it % KV_STAGES]);
    };
    // No wgmma may sit under a branch: ptxas would serialise them all (C7518).
    if (n_tiles > 0) hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % KV_STAGES;
      wait_full(it);
      issue_s(it);  // running ahead, queued behind the previous tile's dK
      issue_dp(it);
      if constexpr (AHEAD) {
        hopper::wgmma_wait<2>();  // the previous tile's dK is done
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(da);
        if (it > 0) release(it - 1);
      }
      const int q_lo = (qt_lo + it % nq) * BQ;
      const int q_hi = q_lo + BQ - 1;
      // the tile crosses an edge of a mask (else every pair is live)
      const bool edge = q_hi >= a.Sq || row_lo + 64 > a.Sk ||
                        (a.mask.causal && row_lo + 63 > q_lo) ||
                        (a.mask.has_window && row_lo <= q_hi - a.mask.window);
      const float* l2r = rows + s * L::ROWS;
      const float* dlr = l2r + BQ;
      hopper::wgmma_wait<1>();  // S^T is done, dP^T may still run
      hopper::fence_regs(st);
      // P^T, its mask evaluated only on a tile that crosses an edge
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(l2r + 8 * j + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int x = 4 * j + 2 * r + e;
              float p = exp2_approx(st[x] * a.scale_log2 - (e ? l2.y : l2.x));
              if constexpr (decltype(masked)::value)
                if (!a.mask.live(q_lo + 8 * j + col + e, r ? k1 : k0)) p = 0.f;
              st[x] = p;
            }
          }
        }
      };
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      uint32_t pa[BQ / 16][4];
      pack(pa, st);
      hopper::wgmma_fence();
      rs_product<DVP, BQ / 16>(dv_acc, pa, do_tile(s), BQ_BOX);  // dV += P^T dO
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dP^T is done, dV may still run
      hopper::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(dlr + 8 * j + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 4 * j + 2 * r + e;
            dpt[x] = st[x] * (dpt[x] - (e ? dl.y : dl.x));  // dS^T / scale
          }
        }
      }
      pack(da, dpt);
      hopper::wgmma_fence();
      rs_product<DP, BQ / 16>(dk_acc, da, q_tile(s), BQ_BOX);  // dK += dS^T Q / scale
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // dV is done: P^T's registers are free
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(pa);
      if constexpr (!AHEAD) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(da);
        release(it);
      }
    }
    if constexpr (AHEAD) {  // the last tile's slot needs no release
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(da);
    }

    if (a.part != nullptr) {  // this part's unscaled sums, in float32
      const int W = a.D + a.Dv;
      const long long row = (long long)a.KV * W;  // a key's stride
      float* pp = a.part + ((long long)part * gridDim.z + b) * a.Sk * row + kvh * W;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + col;
        if (c >= a.D) continue;
        if (k0 < a.Sk)
          *reinterpret_cast<float2*>(pp + k0 * row + c) =
              make_float2(dk_acc[4 * j], dk_acc[4 * j + 1]);
        if (k1 < a.Sk)
          *reinterpret_cast<float2*>(pp + k1 * row + c) =
              make_float2(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
      }
#pragma unroll
      for (int j = 0; j < DVP / 8; ++j) {
        const int c = 8 * j + col;
        if (c >= a.Dv) continue;
        if (k0 < a.Sk)
          *reinterpret_cast<float2*>(pp + k0 * row + a.D + c) =
              make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
        if (k1 < a.Sk)
          *reinterpret_cast<float2*>(pp + k1 * row + a.D + c) =
              make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
      return;
    }
    __nv_bfloat16* dkp = dk + b * a.dks.b + kvh * a.dks.h;
    __nv_bfloat16* dvp = dv + b * a.dvs.b + kvh * a.dvs.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= a.D) continue;  // D is a multiple of 16
      if (k0 < a.Sk)
        *reinterpret_cast<__nv_bfloat162*>(dkp + k0 * a.dks.s + c) =
            __floats2bfloat162_rn(dk_acc[4 * j] * a.scale, dk_acc[4 * j + 1] * a.scale);
      if (k1 < a.Sk)
        *reinterpret_cast<__nv_bfloat162*>(dkp + k1 * a.dks.s + c) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2] * a.scale, dk_acc[4 * j + 3] * a.scale);
    }
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= a.Dv) continue;
      if (k0 < a.Sk)
        *reinterpret_cast<__nv_bfloat162*>(dvp + k0 * a.dvs.s + c) =
            __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
      if (k1 < a.Sk)
        *reinterpret_cast<__nv_bfloat162*>(dvp + k1 * a.dvs.s + c) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// dk and dv from the parts' float32 sums (the scratch (parts, B, Sk, KV, D
// + Dv)): four columns a thread, the parts added in the order 0 .. parts -
// 1 (no atomics: two launches give the same bits), dk scaled once, both
// written in bf16 into their strided (B, S, KV, .) layout. D and Dv are
// multiples of 16, so no four columns straddle dk and dv. Bound by bytes:
// it reads the scratch once and writes dk and dv.
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS)
flash_bwd_dkdv_reduce(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int parts, int B, int Sk, int KV,
                      int D, int Dv, Strides dks, Strides dvs, float scale) {
  const int W4 = (D + Dv) / 4;
  const long long n = (long long)B * Sk * KV * W4;  // groups of four columns
  const long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= n) return;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4 s = p4[i];
  for (int p = 1; p < parts; ++p) {
    const float4 x = p4[p * n + i];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  const int c = 4 * static_cast<int>(i % W4);
  const long long r = i / W4;  // (b, key, KV head)
  const int kvh = static_cast<int>(r % KV);
  const int k = static_cast<int>((r / KV) % Sk);
  const long long b = r / ((long long)KV * Sk);
  __nv_bfloat16* out;
  if (c < D) {
    out = dk + b * dks.b + kvh * dks.h + k * dks.s + c;
    s.x *= scale;
    s.y *= scale;
    s.z *= scale;
    s.w *= scale;
  } else {
    out = dv + b * dvs.b + kvh * dvs.h + k * dvs.s + (c - D);
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

// dk, dv at D > 128 (MLA's 192): one warpgroup would hold dK's 96 and dV's
// 64 floats beside S^T's and dP^T's 32 each, past the registers where ptxas
// serialises the wgmma. So a CTA owns 64 keys and its two consumer
// warpgroups split the products of every tile: the first computes S^T = K
// Q^T, P^T and dV += P^T dO, the second dP^T = V dO^T, dS^T and dK += dS^T
// Q. P^T goes from the first to the second through shared memory in
// float32 (a two-slot ring with a "full" and an "empty" mbarrier a slot,
// each thread reading the 32 floats its twin in the other warpgroup
// wrote), so dS^T is computed from the float32 probabilities as in the
// kernel above. Each side runs ahead (its next score tile issued before
// its last product is done): 112 and 144 live floats a thread.
constexpr int P_STAGES = 2;

template <int DP, int DVP>
struct SplitLayout {
  static constexpr int K_BYTES = BQ * DP * 2;
  static constexpr int V_BYTES = BQ * DVP * 2;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int O_BYTES = BQ * DVP * 2;
  static constexpr int STAGE_BYTES = Q_BYTES + O_BYTES;
  static constexpr int P_FLOATS = BQ * BQ;  // a tile's P^T, 32 floats a thread
  static constexpr int ROWS = 2 * BQ;
  static constexpr int BARRIERS = 1 + 2 * KV_STAGES + 2 * P_STAGES;
  static constexpr int SMEM_BYTES = 1024 + K_BYTES + V_BYTES + KV_STAGES * STAGE_BYTES +
                                    P_STAGES * P_FLOATS * 4 + KV_STAGES * ROWS * 4 +
                                    BARRIERS * 8;
  static_assert(SMEM_BYTES <= 232448, "the split dk/dv kernel's shared memory");
};

// grid (key tiles of 64, KV, B): a head's key tiles are adjacent, so the
// stream of its query tiles (1.3 MB of q and dO a head at MLA's widths) is
// read from L2 by all of them; heads fastest, the resident CTAs would span
// ~132 heads and read it from HBM. Within a head the key tiles with the
// most query tiles go first.
template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_split(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     TcArgs a) {
  using L = SplitLayout<DP, DVP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* k_tile = smem;
  unsigned char* v_tile = smem + L::K_BYTES;
  unsigned char* ring = v_tile + L::V_BYTES;
  auto q_tile = [&](int s) { return ring + s * L::STAGE_BYTES; };
  auto do_tile = [&](int s) { return q_tile(s) + L::Q_BYTES; };
  float* p_ring = reinterpret_cast<float*>(ring + KV_STAGES * L::STAGE_BYTES);
  float* rows = p_ring + P_STAGES * L::P_FLOATS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + KV_STAGES * L::ROWS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + KV_STAGES;
  uint64_t* p_full = empty + KV_STAGES;
  uint64_t* p_empty = p_full + P_STAGES;

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int k_lo = kb * BQ;
  const int k_max = min(k_lo + BQ, a.Sk) - 1;
  int qt_lo = 0, qt_hi = (a.Sq + BQ - 1) / BQ;
  if (a.mask.causal) qt_lo = k_lo / BQ;
  if (a.mask.has_window) qt_hi = min(qt_hi, (k_max + a.mask.window - 1) / BQ + 1);
  const int nq = max(qt_hi - qt_lo, 0);
  const int n_tiles = G * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA thread's and the row warp's lanes
      hopper::mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    for (int s = 0; s < P_STAGES; ++s) {
      hopper::mbar_init(&p_full[s], 128);   // every thread of the first consumer
      hopper::mbar_init(&p_empty[s], 128);  // every thread of the second
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer, as the kernel above's
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      hopper::mbar_expect_tx(kv_full, L::K_BYTES + L::V_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        hopper::tma_load_4d(k_tile + c * BQ_BOX, &kmap, kv_full, c * 64, k_lo, kvh, b);
#pragma unroll
      for (int c = 0; c < DVP / 64; ++c)
        hopper::tma_load_4d(v_tile + c * BQ_BOX, &vmap, kv_full, c * 64, k_lo, kvh, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % KV_STAGES;
        const int h = kvh * G + it / nq;
        const int q_lo = (qt_lo + it % nq) * BQ;
        hopper::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], L::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          hopper::tma_load_4d(q_tile(s) + c * BQ_BOX, &qmap, &full[s], c * 64, q_lo, h, b);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          hopper::tma_load_4d(do_tile(s) + c * BQ_BOX, &domap, &full[s], c * 64, q_lo, h, b);
      }
    } else if (threadIdx.x / 32 == 1) {  // the row warp: each tile's lse and delta
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % KV_STAGES;
        const int h = kvh * G + it / nq;
        const int q_lo = (qt_lo + it % nq) * BQ;
        const long long base = ((long long)b * a.H + h) * a.Sq;
        hopper::mbar_wait(&empty[s], ((it / KV_STAGES) & 1) ^ 1);
        float* r = rows + s * L::ROWS;
        for (int i = lane; i < BQ; i += 32) {
          const int qi = min(q_lo + i, a.Sq - 1);
          r[i] = a.lse[base + qi] * LOG2E;
          r[BQ + i] = a.delta[base + qi];
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {  // consumers: both own the CTA's 64 keys, keys as the rows of every tile
    hopper::regs_alloc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int k0 = k_lo + (t / 32) * 16 + lane / 4;  // this thread's keys
    const int k1 = k0 + 8;
    const int col = 2 * (lane % 4);                  // + 8 j (+ 1): its queries
    auto wait_full = [&](int it) {
      hopper::mbar_wait(&full[it % KV_STAGES], (it / KV_STAGES) & 1);
    };
    auto release = [&](int it) {  // every product of this warpgroup that reads tile `it` is done
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[it % KV_STAGES]);
    };
    // this thread's 8 float4 of a P^T slot, interleaved by thread
    auto p_slot = [&](int it) {
      return reinterpret_cast<float4*>(p_ring + (it % P_STAGES) * L::P_FLOATS) + t;
    };
    if (n_tiles > 0) hopper::mbar_wait(kv_full, 0);
    // No wgmma may sit under a branch inside a role: ptxas would serialise them.
    if (wg == 1) {  // S^T -> P^T -> dV
      float dv_acc[DVP / 2];
      zero(dv_acc);
      float st[BQ / 2];
      uint32_t pa[BQ / 16][4];  // P^T, read by dV's product (into the next tile)
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % KV_STAGES;
        wait_full(it);
        hopper::wgmma_fence();
        ss_product<BQ, DP>(st, k_tile, BQ_BOX, 0, q_tile(s), BQ_BOX);  // S^T = K Q^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous tile's dV is done
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(pa);
        if (it > 0) release(it - 1);
        const int q_lo = (qt_lo + it % nq) * BQ;
        const int q_hi = q_lo + BQ - 1;
        const bool edge = q_hi >= a.Sq || k_lo + BQ > a.Sk ||
                          (a.mask.causal && k_lo + BQ - 1 > q_lo) ||
                          (a.mask.has_window && k_lo <= q_hi - a.mask.window);
        const float* l2r = rows + s * L::ROWS;
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        auto probs = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(l2r + 8 * j + col);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int x = 4 * j + 2 * r + e;
                float p = exp2_approx(st[x] * a.scale_log2 - (e ? l2.y : l2.x));
                if constexpr (decltype(masked)::value)
                  if (!a.mask.live(q_lo + 8 * j + col + e, r ? k1 : k0)) p = 0.f;
                st[x] = p;
              }
            }
          }
        };
        if (edge)
          probs(std::true_type{});
        else
          probs(std::false_type{});
        hopper::mbar_wait(&p_empty[it % P_STAGES], ((it / P_STAGES) & 1) ^ 1);
        float4* pp = p_slot(it);
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c)
          pp[c * 128] = make_float4(st[4 * c], st[4 * c + 1], st[4 * c + 2], st[4 * c + 3]);
        hopper::mbar_arrive(&p_full[it % P_STAGES]);
        pack(pa, st);
        hopper::wgmma_fence();
        rs_product<DVP, BQ / 16>(dv_acc, pa, do_tile(s), BQ_BOX);  // dV += P^T dO
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();  // the last tile's slot needs no release
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(pa);
      __nv_bfloat16* dvp = dv + b * a.dvs.b + kvh * a.dvs.h;
#pragma unroll
      for (int j = 0; j < DVP / 8; ++j) {
        const int c = 8 * j + col;
        if (c >= a.Dv) continue;
        if (k0 < a.Sk)
          *reinterpret_cast<__nv_bfloat162*>(dvp + k0 * a.dvs.s + c) =
              __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
        if (k1 < a.Sk)
          *reinterpret_cast<__nv_bfloat162*>(dvp + k1 * a.dvs.s + c) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    } else {  // dP^T -> dS^T -> dK
      float dk_acc[DP / 2];
      zero(dk_acc);
      float dpt[BQ / 2];
      uint32_t da[BQ / 16][4];  // dS^T, read by dK's product (into the next tile)
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % KV_STAGES;
        wait_full(it);
        hopper::wgmma_fence();
        ss_product<BQ, DVP>(dpt, v_tile, BQ_BOX, 0, do_tile(s), BQ_BOX);  // dP^T = V dO^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous tile's dK is done
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(da);
        if (it > 0) release(it - 1);
        const float* dlr = rows + s * L::ROWS + BQ;
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dpt);
        hopper::mbar_wait(&p_full[it % P_STAGES], (it / P_STAGES) & 1);
        const float4* pp = p_slot(it);
#pragma unroll
        for (int c = 0; c < BQ / 8; ++c) {  // x = 4c + 2r + e: query 8c + col + e
          const float4 p = pp[c * 128];
          const float2 dl = *reinterpret_cast<const float2*>(dlr + 8 * c + col);
          dpt[4 * c] = p.x * (dpt[4 * c] - dl.x);  // dS^T / scale
          dpt[4 * c + 1] = p.y * (dpt[4 * c + 1] - dl.y);
          dpt[4 * c + 2] = p.z * (dpt[4 * c + 2] - dl.x);
          dpt[4 * c + 3] = p.w * (dpt[4 * c + 3] - dl.y);
        }
        hopper::mbar_arrive(&p_empty[it % P_STAGES]);
        pack(da, dpt);
        hopper::wgmma_fence();
        rs_product<DP, BQ / 16>(dk_acc, da, q_tile(s), BQ_BOX);  // dK += dS^T Q / scale
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(da);
      __nv_bfloat16* dkp = dk + b * a.dks.b + kvh * a.dks.h;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + col;
        if (c >= a.D) continue;
        if (k0 < a.Sk)
          *reinterpret_cast<__nv_bfloat162*>(dkp + k0 * a.dks.s + c) =
              __floats2bfloat162_rn(dk_acc[4 * j] * a.scale, dk_acc[4 * j + 1] * a.scale);
        if (k1 < a.Sk)
          *reinterpret_cast<__nv_bfloat162*>(dkp + k1 * a.dks.s + c) =
              __floats2bfloat162_rn(dk_acc[4 * j + 2] * a.scale, dk_acc[4 * j + 3] * a.scale);
      }
    }
  }
}

template <int DP, int DVP>
struct QLayout {
  // keys of a tile: 128 where dQ's accumulator leaves room (D <= 64), else 64
  static constexpr int BK = DP <= 64 ? 128 : 64;
  static_assert(runs_ahead(DP / 2, BK), "the dq kernel runs ahead");
  static constexpr int K_BOX = BK * 128;  // one (BK rows x 64 cols) bf16 box
  static constexpr int Q_BYTES = BIG * DP * 2;
  static constexpr int O_BYTES = BIG * DVP * 2;
  static constexpr int K_BYTES = BK * DP * 2;
  static constexpr int V_BYTES = BK * DVP * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int BARRIERS = 1 + 4 * Q_STAGES;
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + O_BYTES + Q_STAGES * STAGE_BYTES + BARRIERS * 8;
};

// dq: grid (H, query tiles of 128, B), the longest rows first; at D > 128
// (query tiles, H, B), a head's query tiles adjacent so that its K and V
// stay in L2, as the split dk/dv kernel's key tiles
template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   __nv_bfloat16* __restrict__ dq, TcArgs a) {
  using L = QLayout<DP, DVP>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* q_tile = smem;
  unsigned char* do_tile = smem + L::Q_BYTES;
  auto k_tile = [&](int s) { return smem + L::Q_BYTES + L::O_BYTES + s * L::STAGE_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + L::K_BYTES; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::Q_BYTES + L::O_BYTES +
                                               Q_STAGES * L::STAGE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + Q_STAGES;
  uint64_t* k_empty = v_full + Q_STAGES;
  uint64_t* v_empty = k_empty + Q_STAGES;

  constexpr bool HEAD_MAJOR = DP > 128;
  const int h = HEAD_MAJOR ? blockIdx.y : blockIdx.x, b = blockIdx.z;
  const int qb = HEAD_MAJOR ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int kvh = h / (a.H / a.KV);
  const int q_lo = qb * BIG;
  int kb_lo = 0, kb_hi = (a.Sk + BK - 1) / BK;
  if (a.mask.causal) kb_hi = min(kb_hi, (q_lo + BIG - 1) / BK + 1);
  if (a.mask.has_window) {
    const int x = q_lo - a.mask.window - (BK - 1);  // live iff kb * BK > x
    if (x >= 0) kb_lo = x / BK + 1;
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < Q_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 0 && kb_lo < kb_hi) {
      hopper::mbar_expect_tx(q_full, L::Q_BYTES + L::O_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        hopper::tma_load_4d(q_tile + c * BIG_BOX, &qmap, q_full, c * 64, q_lo, h, b);
#pragma unroll
      for (int c = 0; c < DVP / 64; ++c)
        hopper::tma_load_4d(do_tile + c * BIG_BOX, &domap, q_full, c * 64, q_lo, h, b);
      for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
        const int s = i % Q_STAGES;
        const uint32_t ph = ((i / Q_STAGES) & 1) ^ 1;
        hopper::mbar_wait(&k_empty[s], ph);
        hopper::mbar_expect_tx(&k_full[s], L::K_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          hopper::tma_load_4d(k_tile(s) + c * L::K_BOX, &kmap, &k_full[s], c * 64, kb * BK,
                              kvh, b);
        hopper::mbar_wait(&v_empty[s], ph);
        hopper::mbar_expect_tx(&v_full[s], L::V_BYTES);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          hopper::tma_load_4d(v_tile(s) + c * L::K_BOX, &vmap, &v_full[s], c * 64, kb * BK,
                              kvh, b);
      }
    }
  } else {  // consumers: 64 query rows each
    hopper::regs_alloc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q_lo + cw * 64;
    const int r0 = row_lo + (t / 32) * 16 + lane / 4;
    const int r1 = r0 + 8;
    const int col = 2 * (lane % 4);
    const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;
    const float* delta = a.delta + ((long long)b * a.H + h) * a.Sq;
    const float l2_0 = lse[min(r0, a.Sq - 1)] * LOG2E, l2_1 = lse[min(r1, a.Sq - 1)] * LOG2E;
    const float d0 = delta[min(r0, a.Sq - 1)], d1 = delta[min(r1, a.Sq - 1)];
    float dq_acc[DP / 2];
    zero(dq_acc);
    float sc[BK / 2], dp[BK / 2];
    // S = Q K^T and dP = dO V^T of key tile `i`, one commit group each
    auto issue_scores = [&](int i) {
      const int s = i % Q_STAGES;
      const uint32_t ph = (i / Q_STAGES) & 1;
      hopper::mbar_wait(&k_full[s], ph);
      hopper::mbar_wait(&v_full[s], ph);
      hopper::wgmma_fence();
      ss_product<BK, DP>(sc, q_tile, BIG_BOX, cw * 64, k_tile(s), L::K_BOX);
      hopper::wgmma_commit();
      ss_product<BK, DVP>(dp, do_tile, BIG_BOX, cw * 64, v_tile(s), L::K_BOX);
      hopper::wgmma_commit();
    };
    const int n_kb = max(kb_hi - kb_lo, 0);
    uint32_t da[BK / 16][4];  // dS, read by dQ's product (into the next tile)
    if (n_kb > 0) hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n_kb; ++i) {
      const int s = i % Q_STAGES;
      issue_scores(i);  // queued behind the previous tile's dQ
      hopper::wgmma_wait<2>();  // the previous tile's dQ is done
      hopper::fence_regs(dq_acc);
      hopper::fence_regs(da);
      __syncwarp();
      if (i > 0 && lane == 0) hopper::mbar_arrive(&k_empty[(i - 1) % Q_STAGES]);
      const int k_lo = (kb_lo + i) * BK;
      const bool edge = k_lo + BK > a.Sk || row_lo + 64 > a.Sq ||
                        (a.mask.causal && k_lo + BK - 1 > row_lo) ||
                        (a.mask.has_window && k_lo <= row_lo + 63 - a.mask.window);
      hopper::wgmma_wait<1>();  // S is done, dP may still run
      hopper::fence_regs(sc);
      // P, its mask evaluated only on a tile that crosses an edge
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            float p = exp2_approx(sc[x] * a.scale_log2 - (e < 2 ? l2_0 : l2_1));
            if constexpr (decltype(masked)::value)
              if (!a.mask.live(e < 2 ? r0 : r1, k_lo + 8 * j + col + (e & 1))) p = 0.f;
            sc[x] = p;
          }
        }
      };
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&v_empty[s]);  // V is read
#pragma unroll
      for (int x = 0; x < BK / 2; ++x)
        sc[x] = sc[x] * (dp[x] - ((x & 2) ? d1 : d0));  // dS / scale
      pack(da, sc);
      hopper::wgmma_fence();
      rs_product<DP, BK / 16>(dq_acc, da, k_tile(s), L::K_BOX);  // dQ += dS K / scale
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();  // the last tile's slot needs no release
    hopper::fence_regs(dq_acc);
    hopper::fence_regs(da);

    __nv_bfloat16* dqp = dq + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c >= a.D) continue;
      if (r0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqp + r0 * a.dqs.s + c) =
            __floats2bfloat162_rn(dq_acc[4 * j] * a.scale, dq_acc[4 * j + 1] * a.scale);
      if (r1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(dqp + r1 * a.dqs.s + c) =
            __floats2bfloat162_rn(dq_acc[4 * j + 2] * a.scale, dq_acc[4 * j + 3] * a.scale);
    }
  }
}

// a rank-4 map over (B, heads, S, width) by element strides, `rows` rows a box
int head_map(CUtensorMap* map, const void* base, int B, int heads, int S, int width,
             Strides st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, int B, Strides qs, Strides ks, Strides vs, Strides dos,
           const TcArgs& a, cudaStream_t stream) {
  constexpr int BK = QLayout<DP, DVP>::BK;
  // D > 128: the dk/dv kernel whose warpgroups split the products, 64 keys a CTA
  constexpr bool SPLIT = DP > 128;
  constexpr int KEYS = SPLIT ? BQ : BIG;
  // _t: the dk/dv kernel's query tiles; _k: the dq kernel's key tiles
  CUtensorMap qm_t, dom_t, km, vm, qm, dom, km_k, vm_k;
  int err = head_map(&qm_t, q, B, a.H, a.Sq, a.D, qs, BQ);
  if (err == 0) err = head_map(&dom_t, dout, B, a.H, a.Sq, a.Dv, dos, BQ);
  if (err == 0) err = head_map(&km, k, B, a.KV, a.Sk, a.D, ks, KEYS);
  if (err == 0) err = head_map(&vm, v, B, a.KV, a.Sk, a.Dv, vs, KEYS);
  if (err == 0) err = head_map(&qm, q, B, a.H, a.Sq, a.D, qs, BIG);
  if (err == 0) err = head_map(&dom, dout, B, a.H, a.Sq, a.Dv, dos, BIG);
  if (err == 0) err = head_map(&km_k, k, B, a.KV, a.Sk, a.D, ks, BK);
  if (err == 0) err = head_map(&vm_k, v, B, a.KV, a.Sk, a.Dv, vs, BK);
  if (err != 0) return err;
  // only the kernel of this width is instantiated (the other would not fit its registers)
  auto kv_kernel = [] {
    if constexpr (SPLIT) return flash_bwd_dkdv_split<DP, DVP>;
    else return flash_bwd_dkdv_wgmma<DP, DVP>;
  }();
  const int kv_smem = SPLIT ? SplitLayout<DP, DVP>::SMEM_BYTES : KvLayout<DP, DVP>::SMEM_BYTES;
  const int q_smem = QLayout<DP, DVP>::SMEM_BYTES;
  cudaError_t e = set_smem(reinterpret_cast<const void*>(kv_kernel), kv_smem);
  if (e == cudaSuccess)
    e = set_smem(reinterpret_cast<const void*>(flash_bwd_dq_wgmma<DP, DVP>), q_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // at D > 128 a head's tiles adjacent in both grids (see the kernels); at
  // D <= 128 the parts of a KV head's group next to each other
  const int n_kt = (a.Sk + KEYS - 1) / KEYS, n_qt = (a.Sq + BIG - 1) / BIG;
  const dim3 kv_grid = SPLIT ? dim3(n_kt, a.KV, B) : dim3(a.KV * a.parts, n_kt, B);
  const dim3 q_grid = SPLIT ? dim3(n_qt, a.H, B) : dim3(a.H, n_qt, B);
  kv_kernel<<<kv_grid, THREADS, kv_smem, stream>>>(
      qm_t, km, vm, dom_t, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.parts > 1) {
    const long long groups = (long long)B * a.Sk * a.KV * ((a.D + a.Dv) / 4);
    flash_bwd_dkdv_reduce<<<(unsigned)((groups + REDUCE_THREADS - 1) / REDUCE_THREADS),
                            REDUCE_THREADS, 0, stream>>>(
        a.part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.parts, B,
        a.Sk, a.KV, a.D, a.Dv, a.dks, a.dvs, a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_bwd_dq_wgmma<DP, DVP><<<q_grid, THREADS, q_smem, stream>>>(
      qm, km_k, vm_k, dom, static_cast<__nv_bfloat16*>(dq), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcb

namespace {

int bwd_entry(int variant, int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int H, int KV, int Sq, int Sk, int D, int Dv,
              const long long* st, float scale, int causal, int has_window, int window,
              int parts, float* part, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]}, dos{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  if (D % 4 || D > MAX_D || Dv > MAX_DV || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // a split of each group's heads: the wgmma dk/dv kernel at D <= 128
  // alone, at most a part a head, with its scratch
  if (parts < 1 || parts > H / KV ||
      (parts > 1 && (variant != 1 || D > 128 || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{Sq, Sk, causal, has_window, window};
  int err = dtype == 0
      ? launch_delta<float>(o, dout, delta, B, H, Sq, Dv, os, dos, stream)
      : launch_delta<__nv_bfloat16>(o, dout, delta, B, H, Sq, Dv, os, dos, stream);
  if (err != 0) return err;
  if (variant == 1) {
    if (dtype != 1 || D % 16 || Dv % 16 || Dv > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    const tcb::TcArgs a{H, KV, Sq, Sk, D, Dv, dqs, dks, dvs, lse, delta,
                        scale, scale * LOG2E, mask, parts, parts > 1 ? part : nullptr};
    if (D > 128 && Dv <= 64)  // D padded to 192 by TMA's zeros, as the forward's
      return tcb::launch<192, 64>(q, k, v, dout, dq, dk, dv, B, qs, ks, vs, dos, a, stream);
    if (D > 128)
      return tcb::launch<192, 128>(q, k, v, dout, dq, dk, dv, B, qs, ks, vs, dos, a, stream);
    if (D <= 64 && Dv <= 64)
      return tcb::launch<64, 64>(q, k, v, dout, dq, dk, dv, B, qs, ks, vs, dos, a, stream);
    if (D <= 64)
      return tcb::launch<64, 128>(q, k, v, dout, dq, dk, dv, B, qs, ks, vs, dos, a, stream);
    if (Dv <= 64)
      return tcb::launch<128, 64>(q, k, v, dout, dq, dk, dv, B, qs, ks, vs, dos, a, stream);
    return tcb::launch<128, 128>(q, k, v, dout, dq, dk, dv, B, qs, ks, vs, dos, a, stream);
  }
  const Args a{H, KV, Sq, Sk, D, Dv, qs, ks, vs, dos, dqs, dks, dvs, lse, delta, scale, mask};
  if (dtype == 0) return launch_ffma<float>(q, k, v, dout, dq, dk, dv, B, a, stream);
  return launch_ffma<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, B, a, stream);
}

}  // namespace

// variant: 0 = ffma, 1 = wgmma; dtype: 0 = float32, 1 = bfloat16.
// q (B,H,Sq,D), k (B,KV,Sk,D), v (B,KV,Sk,Dv), o and dout (B,H,Sq,Dv) and
// the gradients dq, dk, dv (the shapes of q, k, v), each given by its base
// pointer and the element strides of its batch, head and sequence dims (the
// last dim contiguous); lse (B,H,Sq) float32 contiguous, the forward's;
// delta (B,H,Sq) float32 contiguous, scratch the launch writes; `parts`
// (1, or up to H / KV for the wgmma variant at D <= 128) splits each group's
// query heads over that many dk/dv CTAs, which write their sums to `part`,
// float32 contiguous (parts, B, Sk, KV, D + Dv) (NULL at one part), and a
// reduce kernel adds them up in order. D % 4 == 0,
// D <= 192, Dv <= 128; the wgmma variant takes bf16 with D and Dv multiples
// of 16, every stride of q, k, v, dout a multiple of 8
// elements and those tensors 16-byte aligned (TMA). Launches the delta
// pre-pass, the dk/dv kernel (then the reduce) and the dq kernel on
// `stream`; returns 0, a
// CUDA error code, or one above hopper::kTensorMapError.
extern "C" int flash_attention_bwd(
    int variant, int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
    int B, int H, int KV, int Sq, int Sk, int D, int Dv,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, long long dosb, long long dosh, long long doss,
    long long dqsb, long long dqsh, long long dqss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss, float scale,
    int causal, int has_window, int window, int parts, float* part, void* stream) {
  const long long st[24] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                            dosb, dosh, doss, dqsb, dqsh, dqss, dksb, dksh, dkss,
                            dvsb, dvsh, dvss};
  return bwd_entry(variant, dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KV, Sq,
                   Sk, D, Dv, st, scale, causal, has_window, window, parts, part,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return hopper::error_string(code);
}
