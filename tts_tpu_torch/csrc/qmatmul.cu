// x @ dequant(wq, scales) on Hopper: int8 weights wq [K, N] with one f16
// scale per 32-row block and column, scales [K/32, N]; f32 out [M, N].
//
// qgemv_int8 replaces tts_tpu/ops/qmatmul.py::_qmv_kernel (M == 1, every
// decode step and the prefill's lm_head).  Bound: device-memory bytes,
// K * N weight bytes + K/32 * N * 2 scale bytes over 3.35 TB/s.  At M = 1
// each weight byte feeds one multiply-add, far below the ~295 operations
// per byte at which the H100 stops waiting on memory: tensor cores buy
// nothing, and the design is about bytes in flight and fixed cost.  It is
// qmatmul.cuh's qgemv_kernel, shared with qgemv_int4.  What it does about
// the three causes that held the first GEMV at a ~15 us floor:
//   - too few CTAs, too little in flight: a CTA takes 256 columns (two
//     warps side by side, so each weight row is read in 256-byte runs)
//     and the host plan (ops/qmatmul.py::gemv_plan) splits K so that one
//     wave covers the card, at most one CTA per SM; each warp streams its
//     own 32-row blocks, two in flight through a cp.async ring, and adds
//     each quarter block as it lands;
//   - dependent loads: the CTA's slice of x is staged in shared memory
//     once, while the first blocks fly, and a block's scales are copied
//     with its rows;
//   - two kernels per call: the splits of a column tile are one
//     thread-block cluster and add their sums through distributed shared
//     memory in split order (identical bits every run, no global state),
//     and x is read as bf16 or f32 and rounded to bf16 as it is staged,
//     so a call is one launch with no cast kernel.
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

// x [K] bf16 (x_f32: f32); K split into `splits` ranges of `per` 32-row blocks
// (ops/qmatmul.py::gemv_plan), the splits of a column tile one cluster
extern "C" int qgemv_int8(const void* x, int x_f32, const void* wq, const void* scales, void* out,
                          int K, int N, int splits, int per, void* stream) {
  return tts::launch_qgemv<false>(x, x_f32, wq, scales, out, K, N, splits, per, stream);
}

extern "C" int qgemm_int8(const void* x, const void* wq, const void* scales, void* out,
                          int M, int K, int N, void* stream) {
  return tts::launch_gemm(qgemm_int8_kernel<16>, qgemm_int8_kernel<64>, x, wq, scales, out,
                          M, K, N, stream);
}
