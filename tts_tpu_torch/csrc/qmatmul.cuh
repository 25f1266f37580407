// The parts that the int8 (qmatmul.cu) and int4 (qmatmul4.cu) weight-quantized
// products share: tile shapes, the GEMVs' cross-warp sum, the split-K pass
// (the GEMVs and qgemm_int4), and qgemm_int8's shared-memory tile steps.
// Each translation unit that includes this gets its own copy (inline or
// static).
#pragma once

#include "common.cuh"

namespace tts {

constexpr int QBLOCK = 32;   // rows per f16 scale block

// ---- M == 1 ----------------------------------------------------------------
// TTS_* values come from ops/_ext.py GEOMETRY, which the host plans read too
constexpr int GEMV_COLS = 16;                    // columns per thread (16 B)
constexpr int GEMV_WARPS = TTS_GEMV_WARPS;       // warps split a CTA's k-range
constexpr int GEMV_TILE_N = TTS_GEMV_TILE_N;     // columns per CTA
static_assert(GEMV_TILE_N == 32 * GEMV_COLS, "a warp's lanes take a CTA's columns");

// A GEMV kernel: (x bf16 [K], weights, scales f16, out f32 [splits, N], K, N,
// weight blocks per split); grid (N tiles, splits), GEMV_WARPS warps.
using GemvKernel = void (*)(const __nv_bfloat16*, const int8_t*, const __half*, float*,
                            int, int, int);

// Sum the warps' partial sums of this CTA's GEMV_TILE_N columns and store
// them in row blockIdx.y of out [splits, N].  [warp][j][lane] keeps both
// passes free of bank conflicts.
__device__ __forceinline__ void gemv_cta_store(const float (&acc)[GEMV_COLS],
                                               float* __restrict__ out, int N) {
  __shared__ float red[GEMV_WARPS][GEMV_COLS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < GEMV_COLS; ++j) red[warp][j][lane] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < GEMV_TILE_N; c += blockDim.x) {
    const int l = c & 31, j = c >> 5;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_WARPS; ++w) sum += red[w][j][l];
    const int n = blockIdx.x * GEMV_TILE_N + l * GEMV_COLS + j;
    if (n < N) out[(size_t)blockIdx.y * N + n] = sum;
  }
}

// out[n] = sum over splits of partial[s, n], in split order (deterministic);
// N here is the length of one split's plane
static __global__ void splitk_sum_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int splits, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * N + n];
  out[n] = sum;
}

// The GEMV, then the split-K pass when K is split; returns cudaGetLastError().
// partial: [splits, N] f32 scratch, unused when splits == 1.
inline int launch_gemv(GemvKernel kernel, const void* x, const void* w, const void* scales,
                       void* partial, void* out, int K, int N, int splits,
                       int blocks_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, splits);
  kernel<<<grid, GEMV_WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const __half*>(scales), dst, K, N, blocks_per_split);
  if (splits > 1) {
    splitk_sum_kernel<<<(N + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), splits, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- M > 1 -----------------------------------------------------------------
constexpr int GM_BN = 128;
constexpr int GM_BK = QBLOCK;
constexpr int GM_THREADS = 256;  // 16 x 16; each thread: BM/16 rows x 8 columns

// x[m0 .. m0+BM, kc .. kc+GM_BK) -> xs, k-major (rows past M read as 0);
// the reads are coalesced along k
template <int BM>
__device__ __forceinline__ void gemm_load_x(float (*xs)[BM + 1], const float* __restrict__ x,
                                            int m0, int M, int K, int kc) {
  for (int i = threadIdx.x; i < BM * GM_BK; i += GM_THREADS) {
    const int r = i / GM_BK, c = i % GM_BK;
    const int m = m0 + r;
    xs[c][r] = m < M ? x[(size_t)m * K + kc + c] : 0.f;
  }
}

// this thread's 16 dequantized weights -> ws[wr][wc .. wc+16)
__device__ __forceinline__ void gemm_store_w(float (*ws)[GM_BN], int wr, int wc,
                                             const float w[16]) {
#pragma unroll
  for (int j = 0; j < 16; j += 4)
    *reinterpret_cast<float4*>(&ws[wr][wc + j]) = make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]);
}

// acc[i][j] += sum over the k-tile of xs[k][row i] * ws[k][column j]
template <int BM>
__device__ __forceinline__ void gemm_fma_tile(float (&acc)[BM / 16][8], float (*xs)[BM + 1],
                                              float (*ws)[GM_BN]) {
  constexpr int RM = BM / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int kk = 0; kk < GM_BK; ++kk) {
    float a[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = xs[kk][ty * RM + i];
    const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

template <int BM>
__device__ __forceinline__ void gemm_store_out(const float (&acc)[BM / 16][8],
                                               float* __restrict__ out, int m0, int n0,
                                               int M, int N) {
  constexpr int RM = BM / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// A GEMM kernel: (x f32 [M, K], weights, scales f16, out f32 [M, N], M, K, N)
using GemmKernel = void (*)(const float*, const int8_t*, const __half*, float*, int, int, int);

// BM = 16 for short prompts, 64 otherwise; returns cudaGetLastError().
inline int launch_gemm(GemmKernel small, GemmKernel large, const void* x,
                       const void* w, const void* scales, void* out, int M, int K, int N,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const __half* sp = static_cast<const __half*>(scales);
  float* op = static_cast<float*>(out);
  if (M <= 16) {
    const dim3 grid((N + GM_BN - 1) / GM_BN, (M + 15) / 16);
    small<<<grid, GM_THREADS, 0, st>>>(xp, wp, sp, op, M, K, N);
  } else {
    const dim3 grid((N + GM_BN - 1) / GM_BN, (M + 63) / 64);
    large<<<grid, GM_THREADS, 0, st>>>(xp, wp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tts
