// x @ dequant(wq, scales) on Hopper: int8 weights wq [K, N] with one f16
// scale per 32-row block and column, scales [K/32, N]; f32 out [M, N].
//
// qgemv_int8 replaces tts_tpu/ops/qmatmul.py::_qmv_kernel (M == 1, every
// decode step).  Bound: device-memory bytes.  At M = 1 each weight byte is
// used for one multiply-add, far below the ~295 operations per byte at
// which the H100 stops waiting on memory, so the design only has to keep
// enough bytes in flight: a thread owns 16 consecutive columns and reads
// them as one 16-byte load per row (a warp reads 512 contiguous bytes), and
// split-K spreads the narrow shapes (N = 3072) over all 132 SMs.  Partial sums
// go to a [splits, N] f32 scratch and a second pass adds them in a fixed
// order, so results do not change from run to run (no atomics).  x is
// rounded to bf16 by the wrapper, as the TPU kernel does.
//
// qgemm_int8 replaces ::_qmm_kernel (M > 1: prefill).  A shared-memory tiled
// GEMM on the CUDA cores: a 32-row k-tile is exactly one scale block, so the
// weight tile is dequantized once into f32 shared memory (int8 * f16 is exact
// in f32) and every thread accumulates a small register tile in f32.  Bound
// at prefill sizes: f32 FMA throughput; tensor cores (mma.sync / wgmma) are
// later work.
#include "common.cuh"

namespace {

constexpr int QBLOCK = 32;

// ---- M == 1 ----------------------------------------------------------------
constexpr int GEMV_COLS = 16;                    // columns per thread (16 B)
constexpr int GEMV_WARPS = 4;                    // warps split a CTA's k-range
constexpr int GEMV_TILE_N = 32 * GEMV_COLS;      // 512 columns per CTA

__global__ void __launch_bounds__(GEMV_WARPS * 32)
qgemv_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                  const __half* __restrict__ scales, float* __restrict__ out,
                  int K, int N, int blocks_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const int nblk = K / QBLOCK;
  const int b_begin = blockIdx.y * blocks_per_split;
  const int b_end = min(b_begin + blocks_per_split, nblk);

  float acc[GEMV_COLS];
#pragma unroll
  for (int j = 0; j < GEMV_COLS; ++j) acc[j] = 0.f;

  if (n0 < N) {  // N % 16 == 0: a thread's 16 columns are all in or all out
    for (int b = b_begin + warp; b < b_end; b += GEMV_WARPS) {
      const int8_t* wp = wq + (size_t)b * QBLOCK * N + n0;
      const __nv_bfloat16* xp = x + b * QBLOCK;
      float part[GEMV_COLS];
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) part[j] = 0.f;
#pragma unroll 8
      for (int r = 0; r < QBLOCK; ++r) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(wp + (size_t)r * N));
        const float xr = __bfloat162float(xp[r]);
        float w[GEMV_COLS];
        tts::unpack_i8x16(v, w);
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) part[j] = fmaf(xr, w[j], part[j]);
      }
      // the block's scales apply to its partial sums, as in the TPU kernel
      const uint4* sp = reinterpret_cast<const uint4*>(scales + (size_t)b * N + n0);
      float s[GEMV_COLS];
      tts::unpack_f16x8(__ldg(sp), s);
      tts::unpack_f16x8(__ldg(sp + 1), s + 8);
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) acc[j] = fmaf(part[j], s[j], acc[j]);
    }
  }

  // sum the warps' k-ranges; [warp][j][lane] keeps both passes conflict-free
  __shared__ float red[GEMV_WARPS][GEMV_COLS][32];
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

// out[n] = sum over splits of partial[s, n], in split order (deterministic)
__global__ void splitk_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  int splits, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * N + n];
  out[n] = sum;
}

// ---- M > 1 -----------------------------------------------------------------
constexpr int GM_BN = 128;
constexpr int GM_BK = QBLOCK;
constexpr int GM_THREADS = 256;  // 16 x 16; each thread: BM/16 rows x 8 columns

template <int BM>
__global__ void __launch_bounds__(GM_THREADS)
qgemm_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                  const __half* __restrict__ scales, float* __restrict__ out,
                  int M, int K, int N) {
  constexpr int RM = BM / 16;
  __shared__ float xs[GM_BK][BM + 1];                 // x tile, k-major (+1: no bank conflicts)
  __shared__ __align__(16) float ws[GM_BK][GM_BN];    // dequantized weights

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * GM_BN;
  const int wr = tid >> 3, wc = (tid & 7) * 16;       // this thread's 16 weights
  const bool wlive = n0 + wc < N;                     // N % 16 == 0

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    for (int i = tid; i < BM * GM_BK; i += GM_THREADS) {
      const int r = i / GM_BK, c = i % GM_BK;          // reads coalesced along k
      const int m = m0 + r;
      xs[c][r] = m < M ? x[(size_t)m * K + k0 + c] : 0.f;
    }
    float w[16];
    if (wlive) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(wq + (size_t)(k0 + wr) * N + n0 + wc));
      const uint4* sp = reinterpret_cast<const uint4*>(scales + (size_t)(k0 / QBLOCK) * N + n0 + wc);
      float s[16];
      tts::unpack_f16x8(__ldg(sp), s);
      tts::unpack_f16x8(__ldg(sp + 1), s + 8);
      tts::unpack_i8x16(v, w);
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] *= s[j];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(&ws[wr][wc + j]) = make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]);
    __syncthreads();

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
    __syncthreads();
  }

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

}  // namespace

// partial: [splits, N] f32 scratch, unused when splits == 1
extern "C" int qgemv_int8(const void* x, const void* wq, const void* scales, void* partial,
                          void* out, int K, int N, int splits, int blocks_per_split,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const dim3 grid((N + GEMV_TILE_N - 1) / GEMV_TILE_N, splits);
  qgemv_int8_kernel<<<grid, GEMV_WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const __half*>(scales), dst, K, N, blocks_per_split);
  if (splits > 1) {
    splitk_sum_kernel<<<(N + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), splits, N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qgemm_int8(const void* x, const void* wq, const void* scales, void* out,
                          int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const __half* sp = static_cast<const __half*>(scales);
  float* op = static_cast<float*>(out);
  if (M <= 16) {
    const dim3 grid((N + GM_BN - 1) / GM_BN, (M + 15) / 16);
    qgemm_int8_kernel<16><<<grid, GM_THREADS, 0, st>>>(xp, wp, sp, op, M, K, N);
  } else {
    const dim3 grid((N + GM_BN - 1) / GM_BN, (M + 63) / 64);
    qgemm_int8_kernel<64><<<grid, GM_THREADS, 0, st>>>(xp, wp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
