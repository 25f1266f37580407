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
#include "qmatmul.cuh"

namespace {

using namespace tts;

// ---- M == 1 ----------------------------------------------------------------
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
        unpack_i8x16(v, w);
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) part[j] = fmaf(xr, w[j], part[j]);
      }
      // the block's scales apply to its partial sums, as in the TPU kernel
      const uint4* sp = reinterpret_cast<const uint4*>(scales + (size_t)b * N + n0);
      float s[GEMV_COLS];
      unpack_f16x8(__ldg(sp), s);
      unpack_f16x8(__ldg(sp + 1), s + 8);
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) acc[j] = fmaf(part[j], s[j], acc[j]);
    }
  }
  gemv_cta_store(acc, out, N);
}

// ---- M > 1 -----------------------------------------------------------------
template <int BM>
__global__ void __launch_bounds__(GM_THREADS)
qgemm_int8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                  const __half* __restrict__ scales, float* __restrict__ out,
                  int M, int K, int N) {
  __shared__ float xs[GM_BK][BM + 1];                 // x tile, k-major (+1: no bank conflicts)
  __shared__ __align__(16) float ws[GM_BK][GM_BN];    // dequantized weights

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * GM_BN;
  const int wr = tid >> 3, wc = (tid & 7) * 16;       // this thread's 16 weights
  const bool wlive = n0 + wc < N;                     // N % 16 == 0

  float acc[BM / 16][8];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    gemm_load_x<BM>(xs, x, m0, M, K, k0);
    float w[16];
    if (wlive) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(wq + (size_t)(k0 + wr) * N + n0 + wc));
      const uint4* sp = reinterpret_cast<const uint4*>(scales + (size_t)(k0 / QBLOCK) * N + n0 + wc);
      float s[16];
      unpack_f16x8(__ldg(sp), s);
      unpack_f16x8(__ldg(sp + 1), s + 8);
      unpack_i8x16(v, w);
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] *= s[j];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = 0.f;
    }
    gemm_store_w(ws, wr, wc, w);
    __syncthreads();
    gemm_fma_tile<BM>(acc, xs, ws);
    __syncthreads();
  }
  gemm_store_out<BM>(acc, out, m0, n0, M, N);
}

}  // namespace

// partial: [splits, N] f32 scratch, unused when splits == 1
extern "C" int qgemv_int8(const void* x, const void* wq, const void* scales, void* partial,
                          void* out, int K, int N, int splits, int blocks_per_split,
                          void* stream) {
  return tts::launch_gemv(qgemv_int8_kernel, x, wq, scales, partial, out, K, N, splits,
                          blocks_per_split, stream);
}

extern "C" int qgemm_int8(const void* x, const void* wq, const void* scales, void* out,
                          int M, int K, int N, void* stream) {
  return tts::launch_gemm(qgemm_int8_kernel<16>, qgemm_int8_kernel<64>, x, wq, scales, out,
                          M, K, N, stream);
}
