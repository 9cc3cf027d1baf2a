// Mamba2 SSD chunk scan for Hopper (sm_90a), float32 in and out.
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
// Bound on the H100: at the mamba2-130m path's shape (Q = 256, P = 64,
// N = 128) one (b, h, chunk) needs about 21 MFLOP (the causal half of
// C B^T and of its product with x, plus C S^T and the carry) on 0.4 MB of
// float32 operands, some 50 FLOP per byte: above the CUDA cores' float32
// balance point (67 TFLOP/s over 3.35 TB/s = 20), so it is bound by
// operations. This first version runs on the CUDA cores in float32 (FFMA,
// no TF32), like the TPU kernel's float32 dots.
//
// Design:
//   * one 256-thread block per (b, h) loops over the chunks in order: the
//     TPU's sequential grid axis becomes the loop, and the state S lives in
//     shared memory for the whole scan (P x N floats, stored transposed);
//   * a chunk does not fit in shared memory whole (x, B, C and the Q x Q
//     scores are 576 KB at the path's shape against 227 KB a block), so it
//     is processed in 64-row tiles of queries against 64-row tiles of keys,
//     causal tiles only; each thread owns a 4x4 register tile of the row
//     tile's y and of the score tile;
//   * the causal mask selects, never multiplies: for j > i exp(cum_i -
//     cum_j) can overflow to inf, and inf * 0 is NaN;
//   * y's inter-chunk term reads the state that enters the chunk; the carry
//     update is accumulated in registers while the last row tile walks over
//     every key tile, and written to the state only after a barrier that
//     follows the last read of the old state;
//   * every output is summed in one thread in a fixed order, with no
//     atomics: the result is deterministic, run after run;
//   * B*H blocks: 96 at the path's shape, fewer than the card's 132 SMs.
//     Chunk-parallel state passing, tensor cores and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;       // query rows of a row tile
constexpr int TK = 64;       // key rows of a key tile
constexpr int THREADS = 256;
constexpr int RM = 4;        // rows a thread owns in a 64x64 tile
constexpr int CN = 4;        // columns a thread owns in a 64x64 tile
constexpr int MAX_P = 64;    // head dim: 16 threads x CN columns
constexpr int MAX_N = 128;   // state dim: one carry column per thread

// Shared memory in floats. Padded strides keep the transposed stores free of
// bank conflicts.
__host__ __device__ inline int smem_floats(int Q, int P, int N) {
  return N * (P + 1)       // St[n][p]: the state, transposed
         + N * (TQ + 1)    // Ct[n][i]: C of the row tile, transposed
         + TK * (N + 1)    // Bs[j][n]: B of the key tile
         + TK * P          // Xs[j][p]: x of the key tile
         + TK * (TQ + 1)   // Pt[j][i]: decayed, masked scores, transposed
         + 2 * Q;          // cum and dt of the chunk
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ b,
                      const float* __restrict__ c, const float* __restrict__ dt,
                      const float* __restrict__ cum, float* __restrict__ y,
                      int nc, int Q, int P, int N) {
  extern __shared__ float smem[];
  const int SP = P + 1, SQ = TQ + 1, SB = N + 1;
  float* St = smem;
  float* Ct = St + N * SP;
  float* Bs = Ct + N * SQ;
  float* Xs = Bs + TK * SB;
  float* Pt = Xs + TK * P;
  float* cum_s = Pt + TK * SQ;
  float* dt_s = cum_s + Q;

  const int tid = threadIdx.x;
  const int ty = tid / 16;          // rows ty*RM .. of a 64x64 tile
  const int tx = tid % 16;          // columns tx*CN .. of a 64x64 tile
  const int cn = tid % MAX_N;       // carry: state column n ...
  const int cp = tid / MAX_N;       // ... and rows p = cp, cp + 2, ...
  const int n_rt = (Q + TQ - 1) / TQ;

  for (int e = tid; e < N * SP; e += THREADS) St[e] = 0.f;

  for (int ch = 0; ch < nc; ++ch) {
    const size_t chunk = (size_t)blockIdx.x * nc + ch;
    const float* xg = x + chunk * Q * P;
    const float* bg = b + chunk * Q * N;
    const float* cg = c + chunk * Q * N;
    float* yg = y + chunk * Q * P;
    __syncthreads();  // the previous chunk's readers of cum_s/dt_s are done
    for (int e = tid; e < Q; e += THREADS) {
      cum_s[e] = cum[chunk * Q + e];
      dt_s[e] = dt[chunk * Q + e];
    }
    float sl[MAX_P / 2];  // this thread's share of x^T (w o B)
#pragma unroll
    for (int r = 0; r < MAX_P / 2; ++r) sl[r] = 0.f;
    float total = 0.f;

    for (int it = 0; it < n_rt; ++it) {
      const int i0 = it * TQ;
      const bool last = it == n_rt - 1;
      __syncthreads();  // Ct is free
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int i = e / N, n = e % N;
        Ct[n * SQ + i] = (i0 + i < Q) ? cg[(size_t)(i0 + i) * N + n] : 0.f;
      }
      __syncthreads();
      total = cum_s[Q - 1];

      // inter-chunk term, from the state entering this chunk
      float yi[RM][CN], ya[RM][CN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int q = 0; q < CN; ++q) yi[r][q] = ya[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[RM], s[CN];
#pragma unroll
        for (int r = 0; r < RM; ++r) a[r] = Ct[n * SQ + ty * RM + r];
#pragma unroll
        for (int q = 0; q < CN; ++q) {
          const int p = tx * CN + q;
          s[q] = p < P ? St[n * SP + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) yi[r][q] = fmaf(a[r], s[q], yi[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = i0 + ty * RM + r;
        const float d = i < Q ? expf(cum_s[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < CN; ++q) yi[r][q] *= d;
      }

      // intra-chunk term over the causal key tiles
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TK;
        __syncthreads();  // Bs, Xs and Pt are free
        for (int e = tid; e < TK * N; e += THREADS) {
          const int j = e / N, n = e % N;
          Bs[j * SB + n] = (j0 + j < Q) ? bg[(size_t)(j0 + j) * N + n] : 0.f;
        }
        for (int e = tid; e < TK * P; e += THREADS) {
          const int j = e / P, p = e % P;
          Xs[e] = (j0 + j < Q) ? xg[(size_t)(j0 + j) * P + p] : 0.f;
        }
        __syncthreads();

        float s[RM][CN];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) s[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float a[RM], bb[CN];
#pragma unroll
          for (int r = 0; r < RM; ++r) a[r] = Ct[n * SQ + ty * RM + r];
#pragma unroll
          for (int q = 0; q < CN; ++q) bb[q] = Bs[(tx * CN + q) * SB + n];
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int q = 0; q < CN; ++q) s[r][q] = fmaf(a[r], bb[q], s[r][q]);
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int i = i0 + ty * RM + r;
#pragma unroll
          for (int q = 0; q < CN; ++q) {
            const int j = j0 + tx * CN + q;
            // select, never multiply: exp(cum_i - cum_j) overflows for j > i
            float v = 0.f;
            if (j <= i && i < Q) v = s[r][q] * (expf(cum_s[i] - cum_s[j]) * dt_s[j]);
            Pt[(tx * CN + q) * SQ + ty * RM + r] = v;
          }
        }
        __syncthreads();
        for (int k = 0; k < TK; ++k) {
          float a[RM], xv[CN];
#pragma unroll
          for (int r = 0; r < RM; ++r) a[r] = Pt[k * SQ + ty * RM + r];
#pragma unroll
          for (int q = 0; q < CN; ++q) {
            const int p = tx * CN + q;
            xv[q] = p < P ? Xs[k * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int q = 0; q < CN; ++q) ya[r][q] = fmaf(a[r], xv[q], ya[r][q]);
        }
        // the last row tile meets every key tile: accumulate the carry here
        if (last && cn < N) {
          for (int k = 0; k < TK && j0 + k < Q; ++k) {
            const int j = j0 + k;
            const float wb = (expf(total - cum_s[j]) * dt_s[j]) * Bs[k * SB + cn];
#pragma unroll
            for (int r = 0; r < MAX_P / 2; ++r) {
              const int p = cp + 2 * r;
              if (p < P) sl[r] = fmaf(Xs[k * P + p], wb, sl[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = i0 + ty * RM + r;
        if (i >= Q) continue;
#pragma unroll
        for (int q = 0; q < CN; ++q) {
          const int p = tx * CN + q;
          if (p < P) yg[(size_t)i * P + p] = ya[r][q] + yi[r][q];
        }
      }
    }
    __syncthreads();  // every read of the entering state precedes its update
    if (cn < N) {
      const float decay = expf(total);
#pragma unroll
      for (int r = 0; r < MAX_P / 2; ++r) {
        const int p = cp + 2 * r;
        if (p < P) St[cn * SP + p] = decay * St[cn * SP + p] + sl[r];
      }
    }
  }
}

}  // namespace

// x, y (BH, nc, Q, P); b, c (BH, nc, Q, N); dt, cum (BH, nc, Q): float32,
// contiguous, BH = batch * heads. Launches on `stream`; returns
// cudaErrorInvalidValue for shapes the kernel does not take, else
// cudaGetLastError().
extern "C" int ssd_chunk_scan(const void* x, const void* b, const void* c,
                              const void* dt, const void* cum, void* y,
                              int BH, int nc, int Q, int P, int N,
                              void* stream) {
  if (BH < 1 || nc < 1 || Q < 1 || P < 1 || P > MAX_P || N < 1 || N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(Q, P, N));
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<float*>(y), nc, Q, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
