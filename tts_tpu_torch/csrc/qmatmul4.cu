// x @ dequant(wq4, scales) on Hopper for packed int4 (Q4_0) weights: wq4
// int8 [K/2, N] holds row i of the [K, N] weight in the low nibble and row
// i + K/2 in the high nibble of packed[i, n], both signed 4-bit; one f16
// scale per 32-row block and column, scales [K/32, N]; f32 out [M, N].
// K % 64 == 0, so packed block b (packed rows 32b .. 32b+31) holds scale
// block b in its low nibbles and scale block b + K/64 in its high ones.
//
// qgemv_int4 replaces tts_tpu/ops/qmatmul.py::_qmv4_kernel (M == 1, every
// decode step).  Bound: device-memory bytes, K/2 * N + K/32 * N * 2 per
// call: half the int8 weight bytes, the same scale bytes.  The design is
// qgemv_int8's (csrc/qmatmul.cu): a thread owns 16 consecutive columns, and
// one 16-byte load of a packed row gives it 16 columns x two rows (i and
// i + K/2), summed against x[i] and x[i + K/2] into two partial sums per
// column.  At the end of each 32-row packed block the two partial sums take
// their block's scales, the same per-block order as the TPU kernel.  Split-K
// over the packed blocks with the deterministic second pass fills the card
// at the narrow shapes.  x is rounded to bf16 by the wrapper, as the TPU
// kernel feeds bf16 activations.  The TPU kernel's block-diagonal expansion
// of x feeds its MXU and has no purpose here.
//
// qgemm_int4 replaces ::_qmm4_kernel (M > 1: prefill).  qgemm_int8's tiled
// GEMM on the CUDA cores: a k-tile of 32 packed rows is dequantized into f32
// shared memory as two 32-row blocks, first the low plane against x columns
// [k0, k0 + 32), then the high plane against [K/2 + k0, ...): the TPU
// kernel's two half-dots, interleaved per tile.  Bound: the larger of the
// weight bytes over 3.35 TB/s and 2*M*K*N over the card's peak rate; at
// prompt lengths it is the bytes, and f32 FMA on the CUDA cores is what
// this first version spends instead (tensor cores are later work).
#include "qmatmul.cuh"

namespace {

using namespace tts;

// ---- M == 1 ----------------------------------------------------------------
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qgemv_int4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq4,
                  const __half* __restrict__ scales, float* __restrict__ out,
                  int K, int N, int blocks_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;
  const int half = K / 2;
  const int nblk = half / QBLOCK;                  // packed blocks
  const int b_begin = blockIdx.y * blocks_per_split;
  const int b_end = min(b_begin + blocks_per_split, nblk);

  float acc[GEMV_COLS];
#pragma unroll
  for (int j = 0; j < GEMV_COLS; ++j) acc[j] = 0.f;

  if (n0 < N) {  // N % 16 == 0: a thread's 16 columns are all in or all out
    for (int b = b_begin + warp; b < b_end; b += GEMV_WARPS) {
      const int8_t* wp = wq4 + (size_t)b * QBLOCK * N + n0;
      const __nv_bfloat16* xlo = x + b * QBLOCK;
      const __nv_bfloat16* xhi = xlo + half;
      float plo[GEMV_COLS], phi[GEMV_COLS];
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) plo[j] = phi[j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < QBLOCK; ++r) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(wp + (size_t)r * N));
        const float xl = __bfloat162float(xlo[r]), xh = __bfloat162float(xhi[r]);
        float lo[GEMV_COLS], hi[GEMV_COLS];
        unpack_i4x16(v, lo, hi);
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) {
          plo[j] = fmaf(xl, lo[j], plo[j]);
          phi[j] = fmaf(xh, hi[j], phi[j]);
        }
      }
      // the two planes' scale blocks apply to their partial sums
      const uint4* slo = reinterpret_cast<const uint4*>(scales + (size_t)b * N + n0);
      const uint4* shi = reinterpret_cast<const uint4*>(scales + (size_t)(b + nblk) * N + n0);
      float s[GEMV_COLS];
      unpack_f16x8(__ldg(slo), s);
      unpack_f16x8(__ldg(slo + 1), s + 8);
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) acc[j] = fmaf(plo[j], s[j], acc[j]);
      unpack_f16x8(__ldg(shi), s);
      unpack_f16x8(__ldg(shi + 1), s + 8);
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) acc[j] = fmaf(phi[j], s[j], acc[j]);
    }
  }
  gemv_cta_store(acc, out, N);
}

// ---- M > 1 -----------------------------------------------------------------
template <int BM>
__global__ void __launch_bounds__(GM_THREADS)
qgemm_int4_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq4,
                  const __half* __restrict__ scales, float* __restrict__ out,
                  int M, int K, int N) {
  __shared__ float xs[GM_BK][BM + 1];                 // x tile, k-major (+1: no bank conflicts)
  __shared__ __align__(16) float ws[GM_BK][GM_BN];    // one plane's dequantized weights

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * GM_BN;
  const int wr = tid >> 3, wc = (tid & 7) * 16;       // this thread's 16 packed bytes
  const bool wlive = n0 + wc < N;                     // N % 16 == 0
  const int half = K / 2;
  const int nblk = half / QBLOCK;

  float acc[BM / 16][8];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < half; k0 += GM_BK) {
    float lo[16], hi[16];
    if (wlive) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(wq4 + (size_t)(k0 + wr) * N + n0 + wc));
      const int b = k0 / QBLOCK;
      const uint4* slo = reinterpret_cast<const uint4*>(scales + (size_t)b * N + n0 + wc);
      const uint4* shi = reinterpret_cast<const uint4*>(scales + (size_t)(b + nblk) * N + n0 + wc);
      float s[16];
      unpack_i4x16(v, lo, hi);
      unpack_f16x8(__ldg(slo), s);
      unpack_f16x8(__ldg(slo + 1), s + 8);
#pragma unroll
      for (int j = 0; j < 16; ++j) lo[j] *= s[j];
      unpack_f16x8(__ldg(shi), s);
      unpack_f16x8(__ldg(shi + 1), s + 8);
#pragma unroll
      for (int j = 0; j < 16; ++j) hi[j] *= s[j];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) lo[j] = hi[j] = 0.f;
    }
    // low plane: rows k0 .. k0+31 of the weight
    gemm_load_x<BM>(xs, x, m0, M, K, k0);
    gemm_store_w(ws, wr, wc, lo);
    __syncthreads();
    gemm_fma_tile<BM>(acc, xs, ws);
    __syncthreads();
    // high plane: rows K/2 + k0 .. K/2 + k0 + 31
    gemm_load_x<BM>(xs, x, m0, M, K, half + k0);
    gemm_store_w(ws, wr, wc, hi);
    __syncthreads();
    gemm_fma_tile<BM>(acc, xs, ws);
    __syncthreads();
  }
  gemm_store_out<BM>(acc, out, m0, n0, M, N);
}

}  // namespace

// partial: [splits, N] f32 scratch, unused when splits == 1
extern "C" int qgemv_int4(const void* x, const void* wq4, const void* scales, void* partial,
                          void* out, int K, int N, int splits, int blocks_per_split,
                          void* stream) {
  return tts::launch_gemv(qgemv_int4_kernel, x, wq4, scales, partial, out, K, N, splits,
                          blocks_per_split, stream);
}

extern "C" int qgemm_int4(const void* x, const void* wq4, const void* scales, void* out,
                          int M, int K, int N, void* stream) {
  return tts::launch_gemm(qgemm_int4_kernel<16>, qgemm_int4_kernel<64>, x, wq4, scales, out,
                          M, K, N, stream);
}
