// Mamba2 SSD chunk scan for Hopper (sm_90a), float32 in and out, as three
// chunk-parallel kernels on the tensor cores.
//
// Replaces: src/repro/kernels/ssd_scan.py::_kernel (Pallas, TPU), whose grid
// (batch, head, chunk) runs the chunk axis in order and carries the (P, N)
// state in VMEM scratch from one chunk to the next. Per chunk, with cum the
// inclusive cumsum of dt*A inside the chunk and total = cum[Q-1]:
//
//   y     = (C B^T o L) x + (C S^T) o exp(cum),  L[i,j] = exp(cum_i - cum_j) dt_j
//                                                  for i >= j, else 0
//   S    <- exp(total) S + x^T (exp(total - cum) dt o B)
//
// Only the (P, N) recurrence needs the chunks in order, so the work is laid
// out as the reference's plain `_ssd_scan` (src/repro/models/ssm.py) lays it
// out, in three kernels launched back to back by `ssd_chunk_scan_staged`:
//
//   1. chunk state, one block per (b, h, chunk): S_local[c] = x^T (w o B),
//      w_j = exp(total - cum_j) dt_j, a (P x N) product over K = Q keys;
//   2. state passing, one thread per state element, in order over the
//      chunks: write the state ENTERING chunk c (zero for c = 0) over
//      S_local[c] in the scratch buffer, then S <- exp(total_c) S +
//      S_local[c]. The last chunk's update is never read by y;
//   3. chunk output, one block per (64-row query tile, chunk, b, h), the
//      heaviest row tiles (most causal key tiles) numbered first:
//      y_i = sum over causal key tiles j of (C_i B_j^T o L_ij) x_j
//            + (C_i S_in^T) o exp(cum_i).
//
// Bound on the H100: at the mamba2-130m path's shape (B 4, H 24, L 2048,
// chunk Q = 256, P = 64, N = 128) the function needs 16.14 GFLOP (per
// (b, h, chunk) the causal half of C B^T and of its product with x, plus
// C S^T and x^T (w o B): 21 MFLOP) on 304 MB of float32 inputs and output.
// On the CUDA cores' float32 (67 TFLOP/s) that is 0.241 ms, bound by
// operations. Here every product runs on the tensor cores in split TF32
// ("3xTF32", three passes at 495 TFLOP/s): 3 x 16.14 GFLOP in 0.098 ms,
// against 0.091 ms for the bytes, so still bound by operations, but 2.5x
// lower. The scratch state (B, H, nc, P, N) float32, 25.2 MB at that shape,
// is written by kernel 1, read and written by kernel 2 and read by kernel 3
// (about 100 MB, 0.030 ms); it is not part of the function's bytes.
//
// Instruction: mma.sync.aligned.m16n8k8 with TF32 operands and float32
// accumulators, for all four products (C B^T, (scores o L) x, C S_in^T and
// x^T (w o B)). wgmma takes TF32 only with both operands K-major, and x and
// w o B are MN-major in two of the four products, so wgmma would need
// transposed copies in shared memory; mma.sync reads its fragments from
// padded shared memory in either orientation. (C B^T and C S_in^T, the bulk
// of kernel 3's products, have both operands K-major: they are the ones a
// wgmma version would take first.) Each operand a is split into
// a_hi = cvt.rna.tf32(a) and a_lo = cvt.rna.tf32(a - a_hi), with a - a_hi
// computed in float32, and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi,
// accumulated in float32: about float32's accuracy (a dropped a_lo b_lo and
// lo's rounding are near 2^-22 of a product), where one TF32 pass (2^-11)
// would miss the reference's 2e-4 + 2e-4 |want|.
//
// Design:
//   * the dual buffer of the key tiles: kernels 1 and 3 stream 32-key tiles
//     of x and B through two shared-memory slots with cp.async; tile j+1 is
//     posted before tile j is contracted and waited for (cp.async.wait_group)
//     just before its first use, as the TPU kernels' VMEM double buffers do;
//   * kernel 3: four warps own 16 query rows each. The scores of a key tile
//     stay in registers: the accumulator of key columns (8t + 2q, 8t + 2q + 1)
//     is the A fragment of P x's k-step t with its K order permuted, and the
//     B fragment reads x's rows in the same order, so P never goes through
//     shared memory. For C B^T and C S_in^T, whose operands both lie along
//     N, a lane reads 16 bytes that hold its fragments of two k-steps (K
//     permuted alike in A and B). S_in is loaded over both key slots before
//     the key loop. The loops have compile-time bounds (N and P padded to
//     128 and 64) and each 3xTF32 pass runs over every tile before the next,
//     so independent products follow one another on the tensor cores;
//   * the split: cvt.rna.tf32 compiles to a test for NaN and infinity and
//     three integer operations, so a_hi is rounded with two integer
//     operations instead (the same value for every a that is not NaN; a NaN
//     still reaches the product through a_lo);
//   * the causal mask selects, never multiplies: for j > i exp(cum_i - cum_j)
//     overflows to inf, and inf * 0 is NaN;
//   * shared-memory strides are padded so that every fragment read is free
//     of bank conflicts: 144 (= 16 mod 32) for rows read 16 bytes a lane,
//     136 and 72 (= 8 mod 32) for rows read [k][m], 68 for x's permuted row
//     pairs;
//   * ragged edges (Q not a multiple of 64 or 32, any P <= 64, N <= 128) are
//     zero-filled on load (cp.async src-size 0) and masked on store;
//   * determinism: every output is summed by one warp in one fixed order,
//     the chunk order of the state passing is fixed, and there are no
//     atomics and no split over keys across blocks;
//   * nothing is allocated here: the wrapper passes the state scratch in.
//
// The backward (`ssd_chunk_scan_bwd`), which the reference has no kernel
// for (it trains through its plain chunked scan, src/repro/models/ssm.py::
// _ssd_scan, and the port's plain version is the VJP of the staged scan,
// kernels/ssd_scan.py::ssd_bwd_staged_plain launch by launch), runs the
// stages in reverse, with g = dy, w_j = exp(total - cum_j) dt_j and
// lambda_c = exp(total_c), in four launches, each instantiated on the state
// width NW, 64 or 128 (the host entry picks the smaller that holds N), so
// that zamba2's N 64 runs no product over zero columns:
//   1. the chunk states and dS_in, one block per (chunk, b, h) and product
//      (grid z): the forward's kernel 1 at NW, states[c] = x^T (w o B), and
//      dS_in[c] = sum_i exp(cum_i) g_i (x) C_i, the same product with
//      exp(cum) weights and g and C in the places of x and B;
//   2. the state passing, one thread per state element: forward over the
//      chunks, states[c] becomes the state entering chunk c; then back in
//      place over dstates, dS_loc[c] = R[c+1] (0 for the last chunk),
//      R[c] = dS_in[c] + lambda_c R[c+1];
//   3. the key side, one block per (64-key tile, chunk, b, h), four warps of
//      16 keys, the query tiles from the diagonal on streamed through two
//      cp.async slots: the scores B C^T and x g^T of a tile transposed (keys
//      as rows), M = (C B^T) o L and G o L, dx += M^T g and dB += (G o L)^T C
//      from the accumulators as kernel 3's P x takes them; ddt and the key
//      side of dcum from the same tile; then the chunk state's backward with
//      D = dS_loc[c]: dx += w D B (at NW 64 B D^T in two halves of P), dB += (w o x)
//      D, dw = x^T D B feeding ddt, dcum and the chunk total's term
//      tw_j = dw_j w_j; the block of key tile 0 also writes
//      lambda_c <D, S_in[c]>;
//   4. the row side, one block per (64-row query tile, chunk, b, h), as
//      kernel 3: dC = exp(cum) g S_in + sum_j (G o L)_ij B_j, and dcum's row
//      side (g . y_inter, sum_j G_ij M_ij, and at the chunk's last position
//      sum_j tw_j + lambda_c <D, S_in>, tw summed by the whole block) added
//      to kernel 3's.
// Only the causal triangle is computed, the mask selecting before the exp,
// so the gradients are finite wherever the plain version's are (C7). Every
// product is mma.sync in 3xTF32; the backward's split hands lo = a - hi to
// the tensor cores as it is, truncated to TF32 by them instead of rounded
// by cvt (split_trunc: 3 instructions for split's 7; a product to about
// 2^-20 of its size, where the reference's bound is 2e-4), and its decay
// exp is ex2.approx of the exact difference of two cumsums. Every output
// element has one owner and each sum a fixed order (no atomics), so the
// backward is deterministic. Bound on the H100 at mamba2-130m's train scan
// (B 2, H 24, L 2048, Q 256, P 64, N 128): kernels/work.py::ssd_bwd_work
// counts 2 (3N + 2P) operations a live pair and 12 Q N P a chunk, 22.6
// GFLOP; at 3xTF32 (3 x 22.6 GFLOP at 495 TFLOP/s) 0.137 ms, against 0.083
// ms for the 278 MB of inputs, dy and gradients: bound by operations.
// What holds it back, measured by removing parts of the kernels one at a
// time (kernel_ab.py --kernels B3bwd): the key and row kernels are bound by
// latency and instruction issue, not by the tensor cores or by memory; so
// at NW 64 they run three blocks an SM (75 KB of shared memory and 168
// registers each: cum and dt read through L1, the row kernel's x slots at
// a stride of 68), at 128 two (the shared memory of the 64-key tile and two
// query slots); at 128 cum and dt stay in shared memory, since reading them
// through L1 there took 0.8051 ms against 0.7856 at mamba2-130m's train scan
// (kernel_ab.py --kernels B3bwd, H100 80GB HBM3 at 700 W), and B D^T stays
// whole (its two halves timed the same, 0.7850). Tried and not kept, each
// slower at both train scans: hi/lo planes split once in shared memory
// (128-byte swizzle) with the score products on mma.sync or on wgmma
// m64n32k8 in three passes (from straight-line code, not serialised), also
// with two warpgroups a block taking the query tiles in turns: the planes
// double the shared memory and its reads,
// leave one block an SM at NW 128, and a 64 x 32 score tile reads its
// 64-row operand three times a tile (bound by shared memory); D and S_in
// split once in halves (two more barriers a block); the blocks ordered by
// chunk for L2 (the kernels are not bound by memory, and the heaviest-first
// order balances the load).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_P = 64;    // head dim: 8 n-tiles of 8
constexpr int MAX_N = 128;   // state dim
constexpr int KT = 32;       // keys of a key tile
constexpr int RT = 64;       // query rows of a chunk-output block
constexpr int CS_THREADS = 256;  // chunk state: 8 warps, 16 x 64 of S each
constexpr int SP_THREADS = 256;  // state passing: one element a thread
constexpr int CO_THREADS = 128;  // chunk output: 4 warps, 16 rows each
// padded shared-memory row strides, in floats (16-byte aligned rows)
constexpr int S_K = MAX_N + 16;     // C, B, S_in read 16 bytes a lane in kernel 3
constexpr int S_COL_P = MAX_P + 8;  // x read as [k][m] in kernel 1
constexpr int S_PERM_P = MAX_P + 4; // x read in row pairs (2q, 2q+1), kernel 3

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__host__ __device__ inline int chunk_output_smem_floats(int Q) {
  return RT * S_K + 2 * KT * S_K + 2 * KT * S_PERM_P + 2 * Q;
}

// ---- cp.async ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of `width` floats (global row stride `width`) into shared rows
// of stride `stride`; rows at or past `valid` are zero-filled. `vec`: 16-byte
// copies (width a multiple of 4, 16-byte aligned base).
__device__ __forceinline__ void load_rows(float* dst, int stride, const float* src,
                                          int width, int rows, int valid, bool vec) {
  if (vec) {
    const int w4 = width / 4;
    for (int e = threadIdx.x; e < rows * w4; e += blockDim.x) {
      const int r = e / w4, col = (e - r * w4) * 4;
      const bool ok = r < valid;
      cp_async16(dst + r * stride + col, ok ? src + (size_t)r * width + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
      const int r = e / width, col = e - r * width;
      const bool ok = r < valid;
      cp_async4(dst + r * stride + col, ok ? src + (size_t)r * width + col : src, ok);
    }
  }
}

// ---- split TF32 on the tensor cores --------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo, both TF32: hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi),
// a - hi exact in float32. hi is rounded as the instruction rounds (half away
// from zero at bit 13, the 13 low bits cleared) but without the tests for NaN
// and infinity that cvt compiles to: the same value for every a that is not
// NaN, and a NaN still reaches the product through lo.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = to_tf32(a - __uint_as_float(hi));
}

// The backward's split: hi as above, lo = a - hi exact in float32 and handed
// to the tensor cores as it is, which read a TF32 operand's top 19 bits: lo
// truncated instead of rounded, each product to about 2^-20 of its size, and
// four instructions fewer than split's cvt.
__device__ __forceinline__ void split_trunc(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

template <bool TRUNC>
__device__ __forceinline__ void split_as(float a, uint32_t& hi, uint32_t& lo) {
  if constexpr (TRUNC)
    split_trunc(a, hi, lo);
  else
    split(a, hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[t] += a b[t] for T n-tiles in 3xTF32, the two small cross terms first;
// each pass runs over every tile before the next, so that no product waits
// for the one before it on the same accumulator
template <int T>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t (*bh)[2],
                                           uint32_t (*bl)[2]) {
#pragma unroll
  for (int t = 0; t < T; ++t) mma_tf32(d[t], al, bh[t]);
#pragma unroll
  for (int t = 0; t < T; ++t) mma_tf32(d[t], ah, bl[t]);
#pragma unroll
  for (int t = 0; t < T; ++t) mma_tf32(d[t], ah, bh[t]);
}

// The m16n8k8 fragments, lane = 4 g + q: A (16 x 8) holds (g, q), (g+8, q),
// (g, q+4), (g+8, q+4); B (8 x 8) holds (k = q, n = g), (q+4, g); the
// accumulator holds (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1).

// Kernel 3's products over N (C B^T and C S_in^T) read both operands from
// rows of N floats: a lane reads 16 bytes, columns c0 + 4q .. c0 + 4q + 3,
// which stand for k = q, q + 4 of one k-step and k = q, q + 4 of the next.
// A and B share that order of K, so each sum is unchanged.

// d[t] += sum over the KW columns of A's rows a_row (+ g, + g + 8) times
// B's row b_row + 8t + g, for T n-tiles (columns past N or P are zero in
// both); SA and SB are A's and B's row strides in shared memory
template <int T, int KW = MAX_N, int SA = S_K, int SB = S_K, bool TRUNC = false>
__device__ __forceinline__ void product_rows(float (*d)[4], const float* a, int a_row,
                                             const float* b, int b_row, int q) {
#pragma unroll 2
  for (int c0 = 0; c0 < KW; c0 += 16) {
    const float4 r0 = *reinterpret_cast<const float4*>(a + a_row * SA + c0 + 4 * q);
    const float4 r1 = *reinterpret_cast<const float4*>(a + (a_row + 8) * SA + c0 + 4 * q);
    uint32_t ah[2][4], al[2][4];
    split_as<TRUNC>(r0.x, ah[0][0], al[0][0]);
    split_as<TRUNC>(r1.x, ah[0][1], al[0][1]);
    split_as<TRUNC>(r0.y, ah[0][2], al[0][2]);
    split_as<TRUNC>(r1.y, ah[0][3], al[0][3]);
    split_as<TRUNC>(r0.z, ah[1][0], al[1][0]);
    split_as<TRUNC>(r1.z, ah[1][1], al[1][1]);
    split_as<TRUNC>(r0.w, ah[1][2], al[1][2]);
    split_as<TRUNC>(r1.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int t0 = 0; t0 < T; t0 += 4) {
      uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 r =
            *reinterpret_cast<const float4*>(b + (b_row + 8 * (t0 + t)) * SB + c0 + 4 * q);
        split_as<TRUNC>(r.x, bh[0][t][0], bl[0][t][0]);
        split_as<TRUNC>(r.y, bh[0][t][1], bl[0][t][1]);
        split_as<TRUNC>(r.z, bh[1][t][0], bl[1][t][0]);
        split_as<TRUNC>(r.w, bh[1][t][1], bl[1][t][1]);
      }
      mma_3xtf32<4>(d + t0, ah[0], al[0], bh[0], bl[0]);
      mma_3xtf32<4>(d + t0, ah[1], al[1], bh[1], bl[1]);
    }
  }
}

// ---- 1. chunk state --------------------------------------------------------

// grid (nc, BH, 1), at state width NW (the forward's MAX_N); warp w owns S
// rows p in [16 (w % 4), +16), columns n in [NW/2 (w / 4), +NW/2). BWD: the
// backward's launch 1, with the backward's split (split_trunc) and grid z 2:
// z = 1 writes dstates[c] = dS_in[c] = (exp(cum) o g)^T C, g and C in the
// places of x and B.
template <int NW, bool BWD>
__global__ void __launch_bounds__(CS_THREADS)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ b,
                       const float* __restrict__ dy, const float* __restrict__ c,
                       const float* __restrict__ dt, const float* __restrict__ cum,
                       float* __restrict__ states, float* __restrict__ dstates, int nc, int Q,
                       int P, int N, int vec) {
  constexpr int SCN = NW + 8;  // B read as [k][n]: 8 mod 32
  constexpr int NT = NW / 16;  // n-tiles of a warp
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                   // [2][KT][S_COL_P]
  float* Bs = Xs + 2 * KT * S_COL_P;  // [2][KT][SCN]
  float* ws = Bs + 2 * KT * SCN;      // w of the chunk, 0 past Q

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool grad = BWD && blockIdx.z != 0;
  const size_t chunk = (size_t)blockIdx.y * nc + blockIdx.x;
  const float* xg = (grad ? dy : x) + chunk * Q * P;
  const float* bg = (grad ? c : b) + chunk * Q * N;
  const float* cg = cum + chunk * Q;
  const float* dg = dt + chunk * Q;
  const int nkt = (Q + KT - 1) / KT;

  auto load_tile = [&](int kt) {
    const int j0 = kt * KT;
    load_rows(Xs + (kt & 1) * KT * S_COL_P, S_COL_P, xg + (size_t)j0 * P, P, KT, Q - j0, vec);
    load_rows(Bs + (kt & 1) * KT * SCN, SCN, bg + (size_t)j0 * N, N, KT, Q - j0, vec);
    cp_async_commit();
  };
  load_tile(0);
  const float total = cg[Q - 1];
  for (int j = threadIdx.x; j < nkt * KT; j += CS_THREADS)
    ws[j] = j >= Q ? 0.f : grad ? expf(cg[j]) : expf(total - cg[j]) * dg[j];

  const int m0 = 16 * (warp & 3), n0 = (NW / 2) * (warp >> 2);
  const bool active = m0 < P && n0 < N;
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, the first time, ws) is in place
    if (active) {
      const float* xs = Xs + (kt & 1) * KT * S_COL_P;
      const float* bs = Bs + (kt & 1) * KT * SCN;
      const float* w = ws + kt * KT;
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += 8) {
        // A = (x o w)^T: A[p][j] read from x's rows j, columns p
        const float w0 = w[k0 + q], w1 = w[k0 + q + 4];
        const float* x0 = xs + (k0 + q) * S_COL_P + m0 + g;
        const float* x1 = x0 + 4 * S_COL_P;
        uint32_t ah[4], al[4];
        split_as<BWD>(x0[0] * w0, ah[0], al[0]);
        split_as<BWD>(x0[8] * w0, ah[1], al[1]);
        split_as<BWD>(x1[0] * w1, ah[2], al[2]);
        split_as<BWD>(x1[8] * w1, ah[3], al[3]);
        const float* b0 = bs + (k0 + q) * SCN + n0 + g;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          uint32_t bh[1][2], bl[1][2];
          split_as<BWD>(b0[8 * t], bh[0][0], bl[0][0]);
          split_as<BWD>(b0[8 * t + 4 * SCN], bh[0][1], bl[0][1]);
          mma_3xtf32<1>(acc + t, ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // slot kt & 1 is free for tile kt + 2
  }

  if (!active) return;
  float* sg = (grad ? dstates : states) + chunk * P * N;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h, n = n0 + 8 * t + 2 * q;
      if (p >= P) continue;
      if (n < N) sg[(size_t)p * N + n] = acc[t][2 * h];
      if (n + 1 < N) sg[(size_t)p * N + n + 1] = acc[t][2 * h + 1];
    }
}

template <int NW>
__host__ __device__ inline int chunk_state_smem_floats(int Q) {
  return 2 * KT * (S_COL_P + NW + 8) + round_up(Q, KT);
}

// ---- 2. state passing ------------------------------------------------------

// One state element s[c PN] of every chunk c, in place, in order over the
// chunks: s[c PN] becomes the state entering chunk c (zero for c = 0), and
// the state after the last chunk is returned. total[c Q]: chunk c's total.
__device__ __forceinline__ float pass_states(float* s, const float* total, int nc, int Q,
                                             int PN) {
  float S = 0.f;
  float next = s[0];
  for (int c = 0; c < nc; ++c) {
    const float local = next;
    if (c + 1 < nc) next = s[(size_t)(c + 1) * PN];
    s[(size_t)c * PN] = S;  // the state entering chunk c
    S = expf(total[(size_t)c * Q]) * S + local;
  }
  return S;
}

// grid (ceil(P N / SP_THREADS), BH): in place over the scratch, chunk by
// chunk; `final_state` (BH, P, N) may be null.
__global__ void __launch_bounds__(SP_THREADS)
ssd_state_passing_kernel(float* __restrict__ states, const float* __restrict__ cum,
                         float* __restrict__ final_state, int nc, int Q, int PN) {
  const int e = blockIdx.x * SP_THREADS + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = blockIdx.y;
  const float S = pass_states(states + bh * nc * PN + e, cum + bh * nc * Q + (Q - 1), nc, Q, PN);
  if (final_state != nullptr) final_state[bh * PN + e] = S;
}

// ---- 3. chunk output -------------------------------------------------------

// grid (n_rt * nc * BH): block k takes row tile n_rt - 1 - k / (nc BH), so
// the row tiles with the most causal key tiles start first.
__global__ void __launch_bounds__(CO_THREADS, 2)
ssd_chunk_output_kernel(const float* __restrict__ x, const float* __restrict__ b,
                        const float* __restrict__ c, const float* __restrict__ dt,
                        const float* __restrict__ cum, const float* __restrict__ states,
                        float* __restrict__ y, int nc, int Q, int P, int N, int n_rt,
                        int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // [RT][S_K]: C of the row tile
  float* Bs = Cs + RT * S_K;         // [2][KT][S_K]; S_in over both first
  float* Xs = Bs + 2 * KT * S_K;     // [2][KT][S_PERM_P]
  float* cum_s = Xs + 2 * KT * S_PERM_P;
  float* dt_s = cum_s + Q;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int per_rt = gridDim.x / n_rt;       // nc * BH
  const size_t chunk = blockIdx.x % per_rt;  // bh * nc + chunk index
  const int i0 = (n_rt - 1 - blockIdx.x / per_rt) * RT;
  const bool has_state = chunk % nc != 0;  // chunk 0 enters with S = 0
  const float* xg = x + chunk * Q * P;
  const float* bg = b + chunk * Q * N;

  // columns [N, MAX_N) of C, B and S_in (rows contiguous from Cs on): the
  // loads never write them, and the products run over all MAX_N
  const int pad = MAX_N - N;
  for (int e = threadIdx.x; e < 2 * RT * pad; e += CO_THREADS)
    Cs[e / pad * S_K + N + e % pad] = 0.f;
  for (int e = threadIdx.x; e < Q; e += CO_THREADS) {
    cum_s[e] = cum[chunk * Q + e];
    dt_s[e] = dt[chunk * Q + e];
  }
  load_rows(Cs, S_K, c + chunk * Q * N + (size_t)i0 * N, N, RT, Q - i0, vec);
  if (has_state) load_rows(Bs, S_K, states + chunk * P * N, N, P, P, vec);
  cp_async_commit();

  const int m0 = 16 * warp;        // this warp's rows in the tile
  const int r0 = i0 + m0;          // ... and in the chunk
  const bool rows_live = r0 < Q;
  const int ia = r0 + g, ib = ia + 8;  // this thread's two rows
  float yacc[8][4];  // y columns 8u + 2q, + 1 of rows ia and ib
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) yacc[u][r] = 0.f;

  if (has_state) {  // y = (C S_in^T) o exp(cum) first
    cp_async_wait<0>();
    __syncthreads();
    if (rows_live) {
      product_rows<8>(yacc, Cs, m0 + g, Bs, g, q);
      const float da = ia < Q ? expf(cum_s[ia]) : 0.f;
      const float db = ib < Q ? expf(cum_s[ib]) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        yacc[u][0] *= da;
        yacc[u][1] *= da;
        yacc[u][2] *= db;
        yacc[u][3] *= db;
      }
    }
    __syncthreads();  // every read of S_in precedes key tile 0's load
  }

  const int k_end = min(Q, i0 + RT);  // keys past the tile's last row are masked
  const int nkt = (k_end + KT - 1) / KT;
  auto load_tile = [&](int kt) {
    const int j0 = kt * KT;
    load_rows(Bs + (kt & 1) * KT * S_K, S_K, bg + (size_t)j0 * N, N, KT, Q - j0, vec);
    load_rows(Xs + (kt & 1) * KT * S_PERM_P, S_PERM_P, xg + (size_t)j0 * P, P, KT, Q - j0,
              vec);
    cp_async_commit();
  };
  load_tile(0);

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, the first time, C, cum and dt) is in place
    const int j0 = kt * KT;
    if (rows_live && j0 <= r0 + 15) {
      const float* xs = Xs + (kt & 1) * KT * S_PERM_P;
      float sc[4][4];  // scores of rows ia, ib and keys j0 + 8t + 2q, + 1
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[t][r] = 0.f;
      product_rows<4>(sc, Cs, m0 + g, Bs + (kt & 1) * KT * S_K, g, q);  // C B^T
      const float ca = cum_s[min(ia, Q - 1)], cb = cum_s[min(ib, Q - 1)];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // decay, and the causal mask as a selection
          const int j = j0 + 8 * t + 2 * q + h;
          const int jc = min(j, Q - 1);
          const float lj = dt_s[jc], cj = cum_s[jc];
          sc[t][h] = (j <= ia && ia < Q) ? sc[t][h] * (expf(ca - cj) * lj) : 0.f;
          sc[t][2 + h] = (j <= ib && ib < Q) ? sc[t][2 + h] * (expf(cb - cj) * lj) : 0.f;
        }
        // (scores o L) x: the accumulator is the A fragment of k-step t with
        // k = q <-> key 8t + 2q and k = q + 4 <-> key 8t + 2q + 1
        uint32_t ah[4], al[4];
        split(sc[t][0], ah[0], al[0]);
        split(sc[t][2], ah[1], al[1]);
        split(sc[t][1], ah[2], al[2]);
        split(sc[t][3], ah[3], al[3]);
        const float* x0 = xs + (8 * t + 2 * q) * S_PERM_P + g;
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int u = 0; u < 8; ++u) {  // columns past P only reach y's columns past P
          split(x0[8 * u], bh[u][0], bl[u][0]);
          split(x0[8 * u + S_PERM_P], bh[u][1], bl[u][1]);
        }
        mma_3xtf32<8>(yacc, ah, al, bh, bl);
      }
    }
    __syncthreads();  // slot kt & 1 is free for tile kt + 2
  }

  if (!rows_live) return;
  float* yg = y + chunk * Q * P;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ia + 8 * h, p = 8 * u + 2 * q;
      if (i >= Q) continue;
      if (p < P) yg[(size_t)i * P + p] = yacc[u][2 * h];
      if (p + 1 < P) yg[(size_t)i * P + p + 1] = yacc[u][2 * h + 1];
    }
}

// ---- the backward -----------------------------------------------------------

// The key and row kernels at state width NW (64 or 128).
template <int NW>
struct BwdStrides {
  // blocks an SM: at NW 64 three (each at most 75 KB of shared memory and
  // 168 registers a thread), at 128 two
  static constexpr int BLOCKS = NW == 64 ? 3 : 2;
  // x rows of the row kernel's key tiles: 16-byte reads free of conflicts at
  // 80, two-way at 68 (which three blocks an SM need)
  static constexpr int SX = NW == 64 ? MAX_P + 4 : MAX_P + 16;
  // the chunk's cum and dt in shared memory (at NW 128, where reads through
  // L1 are slower), or read through L1 (at NW 64, where three blocks an SM
  // leave no room for them)
  static constexpr bool CUM_SMEM = NW != 64;
  static constexpr int SK = NW + 16;  // rows read 16 bytes a lane over N
  static constexpr int SC = NW + 4;   // C (key side) and B (row side) tiles: 16-byte
                                      // reads, and row pairs (2q, 2q+1) free of conflicts
};
constexpr int S_P = MAX_P + 16;  // x and g rows read 16 bytes a lane over P

template <int NW>
__host__ __device__ inline int bwd_key_smem_floats(int Q) {
  using S = BwdStrides<NW>;
  return RT * S::SK + RT * S_P + 2 * KT * S::SC + 2 * KT * S_PERM_P + (S::CUM_SMEM ? 2 * Q : 0);
}

template <int NW>
__host__ __device__ inline int bwd_row_smem_floats(int Q) {
  using S = BwdStrides<NW>;
  return RT * S::SK + RT * S_P + 2 * KT * S::SC + 2 * KT * S::SX + (S::CUM_SMEM ? 2 * Q : 0);
}

// columns [width, full) of `rows` rows of stride `stride` set to zero: the
// loads never write them, and the products run over every column
__device__ __forceinline__ void zero_pad(float* base, int stride, int rows, int width,
                                         int full) {
  const int pad = full - width;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
    base[(e / pad) * stride + width + e % pad] = 0.f;
}

// exp(d) as 2^(d log2 e) on the special-function unit: d is a difference
// of two cumsums, exact where they are close; about 2^-22 of the value
// (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp_fast(float d) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(d * 1.44269504088896341f));
  return y;
}

// the sum over the 4 lanes of a fragment row (lanes 4g .. 4g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// d[0 .. 7] += A B over the k-steps of 8 in [0, KW): A (16 x KW) given by
// `a(k)`, which returns this lane's fragment {(g, k+q), (g+8, k+q), (g, k+q+4),
// (g+8, k+q+4)}; B read [k][n] from rows of stride SB, columns n0 + 8u + g
template <int KW, int SB, typename AFrag>
__device__ __forceinline__ void product_kn(float (*d)[4], AFrag a, const float* b, int n0,
                                           int g, int q) {
#pragma unroll 2
  for (int k0 = 0; k0 < KW; k0 += 8) {
    float av[4];
    a(k0, av);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_trunc(av[r], ah[r], al[r]);
    const float* b0 = b + (k0 + q) * SB + n0 + g;
    uint32_t bh[8][2], bl[8][2];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      split_trunc(b0[8 * u], bh[u][0], bl[u][0]);
      split_trunc(b0[8 * u + 4 * SB], bh[u][1], bl[u][1]);
    }
    mma_3xtf32<8>(d, ah, al, bh, bl);
  }
}

// d[0 .. 8 U) += A B, A the accumulator tile s (16 rows x 32 columns, the
// columns permuted as kernel 3's P x takes them) and B's rows 8t + 2q, + 1 of
// stride SB, columns 8u + g; GRP n-tiles at a time (4 holds fewer registers)
template <int U, int SB, int GRP = 8>
__device__ __forceinline__ void product_perm(float (*d)[4], const float (&s)[4][4],
                                             const float* b, int g, int q) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t ah[4], al[4];
    split_trunc(s[t][0], ah[0], al[0]);
    split_trunc(s[t][2], ah[1], al[1]);
    split_trunc(s[t][1], ah[2], al[2]);
    split_trunc(s[t][3], ah[3], al[3]);
    const float* b0 = b + (8 * t + 2 * q) * SB + g;
#pragma unroll
    for (int u0 = 0; u0 < U; u0 += GRP) {
      uint32_t bh[GRP][2], bl[GRP][2];
#pragma unroll
      for (int u = 0; u < GRP; ++u) {
        split_trunc(b0[8 * (u0 + u)], bh[u][0], bl[u][0]);
        split_trunc(b0[8 * (u0 + u) + SB], bh[u][1], bl[u][1]);
      }
      mma_3xtf32<GRP>(d + u0, ah, al, bh, bl);
    }
  }
}

// ---- backward 3. the key side of the chunk output's, and the chunk state's ----

// grid (n_jt * nc * BH): block k takes key tile k / (nc BH), so the key tiles
// with the most causal query tiles start first. Four warps own 16 keys each;
// the query tiles (32 rows of C and g) stream through two slots. With
// L = E o dt_j, E_ij = exp(cum_i - cum_j) for i >= j, M = (C B^T) o L,
// G_ij = g_i . x_j, D = dS_loc[c], w_j = exp(total - cum_j) dt_j and
// dw_j = x_j^T D B_j, it writes
//   dx_j   = sum_i M_ij g_i + w_j D B_j
//   dB_j   = sum_i G_ij L_ij C_i + w_j D^T x_j
//   ddt_j  = sum_i G_ij (C_i . B_j) E_ij + dw_j exp(total - cum_j)
//   dcum_j = -sum_i G_ij M_ij - dw_j w_j      (the key side; the row kernel adds the rest)
//   tw_j   = dw_j w_j
// and the block of key tile 0 writes lam_dot[chunk] = exp(total) <D, S_in>.
template <int NW>
__global__ void __launch_bounds__(CO_THREADS, BwdStrides<NW>::BLOCKS)
ssd_bwd_key_kernel(const float* __restrict__ x, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ dt,
                   const float* __restrict__ cum, const float* __restrict__ dy,
                   const float* __restrict__ entering, const float* __restrict__ dstates,
                   float* __restrict__ dx, float* __restrict__ db, float* __restrict__ ddt,
                   float* __restrict__ dcum, float* __restrict__ tw,
                   float* __restrict__ lam_dot, int nc, int Q, int P, int N, int n_jt,
                   int vec) {
  constexpr int S_K = BwdStrides<NW>::SK, S_C = BwdStrides<NW>::SC;
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                   // [RT][S_K]: B of the key tile
  float* Xs = Bs + RT * S_K;          // [RT][S_P]: x of the key tile
  float* Cs = Xs + RT * S_P;          // [2][KT][S_C]: C of a query tile; D after
  float* Gs = Cs + 2 * KT * S_C;      // [2][KT][S_PERM_P]: g of a query tile
  __shared__ float red[CO_THREADS / 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int per_jt = gridDim.x / n_jt;
  const size_t chunk = blockIdx.x % per_jt;
  const int j0 = (blockIdx.x / per_jt) * RT;
  const float* cum_s = cum + chunk * Q;
  const float* dt_s = dt + chunk * Q;

  zero_pad(Bs, S_K, RT, N, NW);
  zero_pad(Xs, S_P, RT, P, MAX_P);
  zero_pad(Cs, S_C, 2 * KT, N, NW);
  zero_pad(Gs, S_PERM_P, 2 * KT, P, MAX_P);
  if constexpr (BwdStrides<NW>::CUM_SMEM) {
    float* cs_ = Gs + 2 * KT * S_PERM_P;
    for (int e = threadIdx.x; e < Q; e += CO_THREADS) {
      cs_[e] = cum_s[e];
      cs_[Q + e] = dt_s[e];
    }
    cum_s = cs_;
    dt_s = cs_ + Q;
  }
  load_rows(Bs, S_K, b + chunk * Q * N + (size_t)j0 * N, N, RT, Q - j0, vec);
  load_rows(Xs, S_P, x + chunk * Q * P + (size_t)j0 * P, P, RT, Q - j0, vec);
  cp_async_commit();

  const int m0 = 16 * warp;
  const int r0 = j0 + m0;
  const bool rows_live = r0 < Q;
  const int ja = r0 + g, jb = ja + 8;  // this thread's two keys
  float dx_acc[8][4], db_acc[NW / 8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) dx_acc[u][r] = 0.f;
#pragma unroll
  for (int u = 0; u < NW / 8; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) db_acc[u][r] = 0.f;
  float ddt_acc[2] = {0.f, 0.f}, dcum_acc[2] = {0.f, 0.f};

  const int it0 = j0 / KT;                 // query tiles from the diagonal on
  const int nit = (Q + KT - 1) / KT - it0;
  auto load_tile = [&](int k) {
    const int i0 = (it0 + k) * KT;
    load_rows(Cs + (k & 1) * KT * S_C, S_C, c + chunk * Q * N + (size_t)i0 * N, N, KT,
              Q - i0, vec);
    load_rows(Gs + (k & 1) * KT * S_PERM_P, S_PERM_P, dy + chunk * Q * P + (size_t)i0 * P, P,
              KT, Q - i0, vec);
    cp_async_commit();
  };
  load_tile(0);

  for (int k = 0; k < nit; ++k) {
    if (k + 1 < nit) {
      load_tile(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = (it0 + k) * KT;
    if (rows_live && i0 + KT - 1 >= r0) {
      const float* cs = Cs + (k & 1) * KT * S_C;
      const float* gs = Gs + (k & 1) * KT * S_PERM_P;
      float sct[4][4], gt[4][4];  // keys ja, jb x queries i0 + 8t + 2q, + 1
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) sct[t][r] = gt[t][r] = 0.f;
      product_rows<4, NW, S_K, S_C, true>(sct, Bs, m0 + g, cs, g, q);          // B C^T
      product_rows<4, MAX_P, S_P, S_PERM_P, true>(gt, Xs, m0 + g, gs, g, q);      // x g^T
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = r ? jb : ja;
          const int jc = min(j, Q - 1);
          const float cj = cum_s[jc], dj = dt_s[jc];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = i0 + 8 * t + 2 * q + h;
            const bool live = j <= i && i < Q && j < Q;  // selects: E overflows above
            const float E = live ? exp_fast(cum_s[min(i, Q - 1)] - cj) : 0.f;
            const float L = E * dj;
            const float sc = sct[t][2 * r + h], gv = gt[t][2 * r + h];
            const float M = sc * L;
            ddt_acc[r] += gv * sc * E;
            dcum_acc[r] -= gv * M;
            sct[t][2 * r + h] = M;
            gt[t][2 * r + h] = gv * L;
          }
        }
      product_perm<8, S_PERM_P, NW == 64 ? 4 : 8>(dx_acc, sct, gs, g, q);  // dx += M^T g
      product_perm<NW / 8, S_C, NW == 64 ? 4 : 8>(db_acc, gt, cs, g, q);       // dB += (G o L)^T C
    }
    __syncthreads();  // slot k & 1 is free for tile k + 2
  }

  // the chunk state's backward: D = dS_loc[c] over the two slots of C
  float* Ds = Cs;
  load_rows(Ds, S_C, dstates + chunk * P * N, N, MAX_P, P, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float total = cum_s[Q - 1];
  if (rows_live) {
    // B D^T (keys ja, jb x p = 8u + 2q, + 1), at NW 64 in two halves of p
    // (fewer live registers), each part added to dx and to dw as soon as it
    // is done
    constexpr int PARTS = NW == 64 ? 2 : 1, TU = 8 / PARTS;
    float w[2], dws[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? jb : ja;
      const int jc = min(j, Q - 1);
      w[r] = j < Q ? expf(total - cum_s[jc]) * dt_s[jc] : 0.f;
    }
#pragma unroll
    for (int hf = 0; hf < PARTS; ++hf) {
      float dbt[TU][4];
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) dbt[u][r] = 0.f;
      product_rows<TU, NW, S_K, S_C, true>(dbt, Bs, m0 + g, Ds, g + 8 * TU * hf, q);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* xr = Xs + (m0 + g + 8 * r) * S_P + 8 * TU * hf;
#pragma unroll
        for (int u = 0; u < TU; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) dws[r] += xr[8 * u + 2 * q + h] * dbt[u][2 * r + h];
      }
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx_acc[TU * hf + u][e] += w[e >> 1] * dbt[u][e];
    }
    const float dw[2] = {quad_sum(dws[0]), quad_sum(dws[1])};
    // dB += (w o x) D, A read [j][p] from x, B [p][n] from D
    const float* xa = Xs + (m0 + g) * S_P;
    const float* xb = xa + 8 * S_P;
    auto afrag = [&](int k0, float (&av)[4]) {
      av[0] = w[0] * xa[k0 + q];
      av[1] = w[1] * xb[k0 + q];
      av[2] = w[0] * xa[k0 + q + 4];
      av[3] = w[1] * xb[k0 + q + 4];
    };
#pragma unroll
    for (int h = 0; h < NW / 64; ++h) product_kn<MAX_P, S_C>(db_acc + 8 * h, afrag, Ds, 64 * h, g, q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? jb : ja;
      const float ddt_j = quad_sum(ddt_acc[r]);
      const float dcum_j = quad_sum(dcum_acc[r]);
      if (q == 0 && j < Q) {
        const size_t o = chunk * Q + j;
        ddt[o] = ddt_j + dw[r] * expf(total - cum_s[j]);
        dcum[o] = dcum_j - dw[r] * w[r];
        tw[o] = dw[r] * w[r];
      }
    }
    float* dxg = dx + chunk * Q * P;
    float* dbg = db + chunk * Q * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r ? jb : ja;
      if (j >= Q) continue;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (8 * u + 2 * q + h < P) dxg[(size_t)j * P + 8 * u + 2 * q + h] = dx_acc[u][2 * r + h];
#pragma unroll
      for (int u = 0; u < NW / 8; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (8 * u + 2 * q + h < N) dbg[(size_t)j * N + 8 * u + 2 * q + h] = db_acc[u][2 * r + h];
    }
  }

  if (j0 == 0) {  // exp(total) <D, S_in>, summed in a fixed order
    const float* sg = entering + chunk * P * N;
    float s = 0.f;
    for (int e = threadIdx.x; e < P * N; e += CO_THREADS)
      s += Ds[(e / N) * S_C + e % N] * sg[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w_ = 0; w_ < CO_THREADS / 32; ++w_) t += red[w_];
      lam_dot[chunk] = expf(total) * t;
    }
  }
}

// ---- backward 4. the row side of the chunk output's ------------------------------

// grid (n_rt * nc * BH), the heaviest row tiles first, as kernel 3: four warps
// own 16 query rows each; the key tiles (32 rows of B and x) stream through
// two slots, S_in over both first. It writes
//   dC_i   = exp(cum_i) g_i S_in + sum_{j <= i} G_ij L_ij B_j
//   dcum_i = dcum_key_i + exp(cum_i) g_i . (C_i S_in^T) + sum_j G_ij M_ij
//            (+ sum_j tw_j + lam_dot at the chunk's last position)
// over the key kernel's dcum, which holds the key side.
template <int NW>
__global__ void __launch_bounds__(CO_THREADS, BwdStrides<NW>::BLOCKS)
ssd_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ dt,
                   const float* __restrict__ cum, const float* __restrict__ dy,
                   const float* __restrict__ entering, const float* __restrict__ tw,
                   const float* __restrict__ lam_dot, float* __restrict__ dc,
                   float* __restrict__ dcum, int nc, int Q, int P, int N, int n_rt, int vec) {
  constexpr int S_K = BwdStrides<NW>::SK, S_C = BwdStrides<NW>::SC, S_X = BwdStrides<NW>::SX;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // [RT][S_K]: C of the row tile
  float* Gs = Cs + RT * S_K;         // [RT][S_P]: g of the row tile
  float* Bs = Gs + RT * S_P;         // [2][KT][S_C]: B of a key tile; S_in first
  float* Xs = Bs + 2 * KT * S_C;     // [2][KT][S_X]: x of a key tile
  __shared__ float red[CO_THREADS / 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int per_rt = gridDim.x / n_rt;
  const size_t chunk = blockIdx.x % per_rt;
  const int i0 = (n_rt - 1 - blockIdx.x / per_rt) * RT;
  const bool has_state = chunk % nc != 0;
  const float* cum_s = cum + chunk * Q;
  const float* dt_s = dt + chunk * Q;

  zero_pad(Cs, S_K, RT, N, NW);
  zero_pad(Gs, S_P, RT, P, MAX_P);
  zero_pad(Bs, S_C, 2 * KT, N, NW);
  zero_pad(Xs, S_X, 2 * KT, P, MAX_P);
  if constexpr (BwdStrides<NW>::CUM_SMEM) {
    float* cs_ = Xs + 2 * KT * S_X;
    for (int e = threadIdx.x; e < Q; e += CO_THREADS) {
      cs_[e] = cum_s[e];
      cs_[Q + e] = dt_s[e];
    }
    cum_s = cs_;
    dt_s = cs_ + Q;
  }
  load_rows(Cs, S_K, c + chunk * Q * N + (size_t)i0 * N, N, RT, Q - i0, vec);
  load_rows(Gs, S_P, dy + chunk * Q * P + (size_t)i0 * P, P, RT, Q - i0, vec);
  if (has_state) load_rows(Bs, S_C, entering + chunk * P * N, N, MAX_P, P, vec);
  cp_async_commit();

  const int m0 = 16 * warp;
  const int r0 = i0 + m0;
  const bool rows_live = r0 < Q;
  const int ia = r0 + g, ib = ia + 8;
  float dc_acc[NW / 8][4];
#pragma unroll
  for (int u = 0; u < NW / 8; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) dc_acc[u][r] = 0.f;
  float dcum_acc[2] = {0.f, 0.f};

  if (has_state) {  // the inter-chunk term first
    cp_async_wait<0>();
    __syncthreads();
    if (rows_live) {
      float yi[8][4];  // C S_in^T: rows ia, ib x p = 8u + 2q, + 1
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) yi[u][r] = 0.f;
      product_rows<8, NW, S_K, S_C, true>(yi, Cs, m0 + g, Bs, g, q);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* gr = Gs + (m0 + g + 8 * r) * S_P;
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) dcum_acc[r] += gr[8 * u + 2 * q + h] * yi[u][2 * r + h];
      }
      const float* ga = Gs + (m0 + g) * S_P;
      const float* gb = ga + 8 * S_P;
      auto afrag = [&](int k0, float (&av)[4]) {
        av[0] = ga[k0 + q];
        av[1] = gb[k0 + q];
        av[2] = ga[k0 + q + 4];
        av[3] = gb[k0 + q + 4];
      };
#pragma unroll
      for (int h = 0; h < NW / 64; ++h)  // g S_in
        product_kn<MAX_P, S_C>(dc_acc + 8 * h, afrag, Bs, 64 * h, g, q);
      const float ea = expf(cum_s[min(ia, Q - 1)]), eb = expf(cum_s[min(ib, Q - 1)]);
      dcum_acc[0] *= ea;
      dcum_acc[1] *= eb;
#pragma unroll
      for (int u = 0; u < NW / 8; ++u) {
        dc_acc[u][0] *= ea;
        dc_acc[u][1] *= ea;
        dc_acc[u][2] *= eb;
        dc_acc[u][3] *= eb;
      }
    }
    __syncthreads();  // every read of S_in precedes key tile 0's load
  }

  const int k_end = min(Q, i0 + RT);
  const int nkt = (k_end + KT - 1) / KT;
  auto load_tile = [&](int kt) {
    const int j0 = kt * KT;
    load_rows(Bs + (kt & 1) * KT * S_C, S_C, b + chunk * Q * N + (size_t)j0 * N, N, KT,
              Q - j0, vec);
    load_rows(Xs + (kt & 1) * KT * S_X, S_X, x + chunk * Q * P + (size_t)j0 * P, P, KT,
              Q - j0, vec);
    cp_async_commit();
  };
  load_tile(0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = kt * KT;
    if (rows_live && j0 <= r0 + 15) {
      const float* bs = Bs + (kt & 1) * KT * S_C;
      const float* xs = Xs + (kt & 1) * KT * S_X;
      float sc[4][4], gg[4][4];  // rows ia, ib x keys j0 + 8t + 2q, + 1
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[t][r] = gg[t][r] = 0.f;
      product_rows<4, NW, S_K, S_C, true>(sc, Cs, m0 + g, bs, g, q);  // C B^T
      product_rows<4, MAX_P, S_P, S_X, true>(gg, Gs, m0 + g, xs, g, q);  // g x^T
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r ? ib : ia;
          const float ci = cum_s[min(i, Q - 1)];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + 8 * t + 2 * q + h;
            const int jc = min(j, Q - 1);
            const bool live = j <= i && i < Q;
            const float L = live ? exp_fast(ci - cum_s[jc]) * dt_s[jc] : 0.f;
            const float gl = gg[t][2 * r + h] * L;
            dcum_acc[r] += gl * sc[t][2 * r + h];
            gg[t][2 * r + h] = gl;
          }
        }
      product_perm<NW / 8, S_C>(dc_acc, gg, bs, g, q);  // dC += (G o L) B
    }
    __syncthreads();
  }

  // the chunk total's gradient through the carry, sum_j tw_j + lam_dot, at
  // the chunk's last position: the block that holds it sums tw, each thread
  // a share, in a fixed order
  float tail = 0.f;
  if (i0 + RT >= Q) {
    float t = 0.f;
    for (int j = threadIdx.x; j < Q; j += CO_THREADS) t += tw[chunk * Q + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[warp] = t;
    __syncthreads();
    tail = (red[0] + red[1]) + (red[2] + red[3]) + lam_dot[chunk];
  }
  if (!rows_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? ib : ia;
    const float s = quad_sum(dcum_acc[r]);
    if (q == 0 && i < Q) {
      const size_t o = chunk * Q + i;
      dcum[o] = dcum[o] + s + (i == Q - 1 ? tail : 0.f);
    }
  }
  float* dcg = dc + chunk * Q * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? ib : ia;
    if (i >= Q) continue;
#pragma unroll
    for (int u = 0; u < NW / 8; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (8 * u + 2 * q + h < N) dcg[(size_t)i * N + 8 * u + 2 * q + h] = dc_acc[u][2 * r + h];
  }
}

// ---- backward 2. the state passing, forward then in reverse ---------------------

// grid (ceil(P N / SP_THREADS), BH), one thread per state element, in place:
// forward over the chunks, states[c] becomes the state entering chunk c (as
// kernel 2); then from the last chunk, dstates[c] = dS_loc[c] = R[c+1] (0
// for the last), R[c] = dS_in[c] + exp(total_c) R[c+1]
__global__ void __launch_bounds__(SP_THREADS)
ssd_bwd_passing_kernel(float* __restrict__ states, float* __restrict__ dstates,
                       const float* __restrict__ cum, int nc, int Q, int PN) {
  const int e = blockIdx.x * SP_THREADS + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = blockIdx.y;
  float* ds = dstates + bh * nc * PN + e;
  const float* total = cum + bh * nc * Q + (Q - 1);
  pass_states(states + bh * nc * PN + e, total, nc, Q, PN);
  float R = 0.f;
  float next = ds[(size_t)(nc - 1) * PN];
  for (int c = nc - 1; c >= 0; --c) {
    const float d_in = next;
    if (c > 0) next = ds[(size_t)(c - 1) * PN];
    ds[(size_t)c * PN] = R;
    R = d_in + expf(total[(size_t)c * Q]) * R;
  }
}

// ---- host ------------------------------------------------------------------

bool bad_shape(int BH, int nc, int Q, int P, int N) {
  return BH < 1 || BH > 65535 || nc < 1 || Q < 1 || P < 1 || P > MAX_P || N < 1 ||
         N > MAX_N;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte copies need rows of whole 16-byte vectors on 16-byte boundaries
int vector_loads(int P, int N, const void* a, const void* b, const void* c) {
  return P % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c);
}

// the kernel's dynamic shared memory, set before each launch
cudaError_t set_smem(const void* kernel, size_t bytes) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Shapes, all float32 and contiguous, BH = batch * heads: x, y (BH, nc, Q, P);
// b, c (BH, nc, Q, N); dt, cum (BH, nc, Q); states (BH, nc, P, N);
// final_state (BH, P, N). Each entry point launches on `stream`, returns
// cudaErrorInvalidValue for shapes the kernels do not take, else
// cudaGetLastError() after its launch.

// kernel 1: states[c] = x^T (w o B) of chunk c
extern "C" int ssd_chunk_state(const void* x, const void* b, const void* dt,
                               const void* cum, void* states, int BH, int nc, int Q,
                               int P, int N, void* stream) {
  if (bad_shape(BH, nc, Q, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(chunk_state_smem_floats<MAX_N>(Q));
  const auto kernel = ssd_chunk_state_kernel<MAX_N, false>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nc, BH), CS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(b), nullptr, nullptr,
      static_cast<const float*>(dt), static_cast<const float*>(cum),
      static_cast<float*>(states), nullptr, nc, Q, P, N, vector_loads(P, N, x, b, x));
  return static_cast<int>(cudaGetLastError());
}

// kernel 2, in place: states[c] becomes the state entering chunk c; the
// state after the last chunk goes to final_state unless it is null
extern "C" int ssd_state_passing(void* states, const void* cum, void* final_state,
                                 int BH, int nc, int Q, int P, int N, void* stream) {
  if (bad_shape(BH, nc, Q, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const int PN = P * N;
  ssd_state_passing_kernel<<<dim3((PN + SP_THREADS - 1) / SP_THREADS, BH), SP_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(cum),
      static_cast<float*>(final_state), nc, Q, PN);
  return static_cast<int>(cudaGetLastError());
}

// kernel 3: y from x, B, C and the states entering each chunk
extern "C" int ssd_chunk_output(const void* x, const void* b, const void* c,
                                const void* dt, const void* cum, const void* states,
                                void* y, int BH, int nc, int Q, int P, int N,
                                void* stream) {
  if (bad_shape(BH, nc, Q, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_rt = (Q + RT - 1) / RT;
  if (static_cast<long long>(n_rt) * nc * BH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(chunk_output_smem_floats(Q));
  cudaError_t err = set_smem(reinterpret_cast<const void*>(ssd_chunk_output_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output_kernel<<<n_rt * nc * BH, CO_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const float*>(states),
      static_cast<float*>(y), nc, Q, P, N, n_rt,
      vector_loads(P, N, x, b, c) && aligned16(states));
  return static_cast<int>(cudaGetLastError());
}

// the scan: the three kernels back to back, `states` as their scratch
extern "C" int ssd_chunk_scan_staged(const void* x, const void* b, const void* c,
                                     const void* dt, const void* cum, void* states,
                                     void* y, int BH, int nc, int Q, int P, int N,
                                     void* stream) {
  int err = ssd_chunk_state(x, b, dt, cum, states, BH, nc, Q, P, N, stream);
  if (err == 0) err = ssd_state_passing(states, cum, nullptr, BH, nc, Q, P, N, stream);
  if (err == 0) err = ssd_chunk_output(x, b, c, dt, cum, states, y, BH, nc, Q, P, N, stream);
  return err;
}

// The backward at state width NW: the chunk states and dS_in (launch 1), the
// state passing (2), the key and row kernels (3 and 4).
template <int NW>
int bwd_launches(const float* const (&f)[6], float* states, float* dstates, float* tw,
                 float* lam_dot, float* dx, float* db, float* dc, float* ddt, float* dcum,
                 int BH, int nc, int Q, int P, int N, cudaStream_t st) {
  const int n_t = (Q + RT - 1) / RT;
  if (static_cast<long long>(n_t) * nc * BH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto states_kernel = ssd_chunk_state_kernel<NW, true>;
  const size_t st_smem = sizeof(float) * static_cast<size_t>(chunk_state_smem_floats<NW>(Q));
  const size_t key_smem = sizeof(float) * static_cast<size_t>(bwd_key_smem_floats<NW>(Q));
  const size_t row_smem = sizeof(float) * static_cast<size_t>(bwd_row_smem_floats<NW>(Q));
  cudaError_t e = set_smem(reinterpret_cast<const void*>(states_kernel), st_smem);
  if (e == cudaSuccess)
    e = set_smem(reinterpret_cast<const void*>(ssd_bwd_key_kernel<NW>), key_smem);
  if (e == cudaSuccess)
    e = set_smem(reinterpret_cast<const void*>(ssd_bwd_row_kernel<NW>), row_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int svec = vector_loads(P, N, f[0], f[1], f[2]) && aligned16(f[5]);
  states_kernel<<<dim3(nc, BH, 2), CS_THREADS, st_smem, st>>>(
      f[0], f[1], f[5], f[2], f[3], f[4], states, dstates, nc, Q, P, N, svec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int PN = P * N;
  ssd_bwd_passing_kernel<<<dim3((PN + SP_THREADS - 1) / SP_THREADS, BH), SP_THREADS, 0, st>>>(
      states, dstates, f[4], nc, Q, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = svec && aligned16(states) && aligned16(dstates);
  ssd_bwd_key_kernel<NW><<<n_t * nc * BH, CO_THREADS, key_smem, st>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], states, dstates, dx, db, ddt, dcum, tw, lam_dot, nc,
      Q, P, N, n_t, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_row_kernel<NW><<<n_t * nc * BH, CO_THREADS, row_smem, st>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], states, tw, lam_dot, dc, dcum, nc, Q, P, N, n_t, vec);
  return static_cast<int>(cudaGetLastError());
}

// The backward of the scan, from its five inputs and dy (the shape of y):
// dx, dy-shaped; db, dc (BH, nc, Q, N); ddt, dcum (BH, nc, Q). Scratch:
// states and dstates (BH, nc, P, N), tw (BH, nc, Q), lam_dot (BH, nc). The
// kernels run at state width 64 where N <= 64, else 128. Launch 1 writes
// each chunk's own state into `states` and dS_in = (exp(cum) o g)^T C into
// `dstates`; launch 2 turns them in place into the states entering each
// chunk and dS_loc; launch 3 (per key tile) writes dx, db, ddt and dcum's
// key side, launch 4 (per query tile) dc and the rest of dcum.
extern "C" int ssd_chunk_scan_bwd(const void* x, const void* b, const void* c,
                                  const void* dt, const void* cum, const void* dy,
                                  void* states, void* dstates, void* tw, void* lam_dot,
                                  void* dx, void* db, void* dc, void* ddt, void* dcum,
                                  int BH, int nc, int Q, int P, int N, void* stream) {
  if (bad_shape(BH, nc, Q, P, N)) return static_cast<int>(cudaErrorInvalidValue);
  const float* const f[6] = {static_cast<const float*>(x),  static_cast<const float*>(b),
                             static_cast<const float*>(c),  static_cast<const float*>(dt),
                             static_cast<const float*>(cum), static_cast<const float*>(dy)};
  const auto launches = N <= 64 ? bwd_launches<64> : bwd_launches<MAX_N>;
  return launches(f, static_cast<float*>(states), static_cast<float*>(dstates),
                  static_cast<float*>(tw), static_cast<float*>(lam_dot), static_cast<float*>(dx),
                  static_cast<float*>(db), static_cast<float*>(dc), static_cast<float*>(ddt),
                  static_cast<float*>(dcum), BH, nc, Q, P, N, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
