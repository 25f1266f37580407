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
// qgemm_int4 replaces ::_qmm4_kernel (M > 1: prefill; later speculative
// verify at M = 8 and Dia's batch-2 steps).  Bound: the weight bytes over
// 3.35 TB/s at every M up to a few hundred (2*M*K*N over 989 TFLOP/s only
// past that), so the kernel has to keep the whole card streaming weights:
//   - tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulate.  Weight
//     columns sit on the MMA's 16-row side and tokens on its 8-wide side, so
//     M = 8 fills a fragment.  Nibbles become their exact integers -8..7 in
//     bf16 (bits 0x4300 | (u ^ 8) are 136 + q; one bf16x2 FMA takes 136
//     off).  x is split into hi = bf16(x) and lo = bf16(x - hi) and both
//     products run, so the sum keeps ~16 bits of x (the f32 plain version's
//     1e-4 holds; bf16(x) alone would not).  Each 32-row block's f16 scale
//     multiplies that block's f32 partial sum, the order of _qmv4_kernel.
//   - split-K: a CTA takes 128 or 256 columns, up to 64 tokens and a range
//     of whole packed blocks (a packed row pairs x columns k and K/2 + k, so
//     a block is never cut); the host plan (ops/qmatmul.py::gemm4_plan)
//     picks the tile and the split so every Orpheus-3B shape launches >= 132
//     CTAs, and a second pass adds the splits in order (no atomics:
//     identical bits every run).  256 columns read each weight row in
//     256-byte runs, which the 8- and 16-token tiles, bound by the weight
//     stream, run faster on where there are CTAs enough.
//   - a ring of G4_STAGES stages of cp.async copies (weights, both planes'
//     scales, the x slices of both planes) keeps three packed blocks in
//     flight while the tensor cores work on the fourth.
// The TPU kernel's block-diagonal expansion of x has no purpose here.
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
constexpr int G4_THREADS = 256;
constexpr int G4_STAGES = TTS_G4_STAGES;   // cp.async ring depth (packed blocks)
constexpr int G4_XROW = 2 * QBLOCK + 4;    // smem row of x, floats: low | high plane, padded

// Shared memory of one CTA with MT 8-token tiles and WN 16-column tiles per
// warp (BN = 128 WN columns): G4_STAGES stages of {packed weights
// [32][WROW], scales [2 planes][BN] f16, x [BM][G4_XROW] f32}, then the B
// fragments of the current stage.
template <int MT, int WN>
struct G4Smem {
  static constexpr int BM = 8 * MT;
  static constexpr int BN = 128 * WN;
  static constexpr int WROW = BN + 16;     // padded: the fragment reads hit 16 banks
  static constexpr int W_BYTES = QBLOCK * WROW;
  static constexpr int S_BYTES = 2 * BN * 2;
  static constexpr int X_BYTES = BM * G4_XROW * 4;
  static constexpr int STAGE = W_BYTES + S_BYTES + X_BYTES;
  static constexpr int XB_BYTES = 2 * 2 * MT * 32 * 16;   // [plane][k16 step][mt][lane] uint4
  static constexpr int TOTAL = G4_STAGES * STAGE + XB_BYTES;
};

// Fragment k order.  The MMA sums over k, so any order of the 16 k of a step
// works if A and B agree: lane (g, t)'s k slots 2t, 2t+1, 2t+8, 2t+9 take
// packed rows t, t+4, t+8, t+12 of the step, and its A rows g, g+8 take the
// adjacent weight columns 2g, 2g+1, so one 16-bit shared load gives both.

// bytes {r c, r c+1, r' c, r' c+1} of a word -> the bf16 pairs (r, r') of
// column c and of column c+1, for the low (lo) or high (hi) nibble plane:
// (u ^ 8) | 0x4300 is bf16 136 + q, and one FMA subtracts the 136 exactly
__device__ __forceinline__ void int4_pairs(uint32_t w, bool high, uint32_t& c0, uint32_t& c1) {
  if (high) w >>= 4;
  uint32_t e = (w & 0x000F000Fu) ^ 0x43084308u;
  uint32_t o = ((w >> 8) & 0x000F000Fu) ^ 0x43084308u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(c0) : "r"(e), "r"(0x3F803F80u), "r"(0xC308C308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(c1) : "r"(o), "r"(0x3F803F80u), "r"(0xC308C308u));
}

// x [M, K] f32 @ dequant(packed int4 [K/2, N]) over packed blocks
// [blockIdx.z * blocks_per_split, +blocks_per_split) -> out [gridDim.z][M][N]
// (the split's partial sums, or the result when gridDim.z == 1).
// grid (N / BN, M / BM, splits), G4_THREADS threads, G4Smem<MT, WN>::TOTAL
// bytes.  Each row of a packed block is BN contiguous bytes of the weights.
// Register caps set the CTAs resident per SM, and the host plan splits K
// into one wave of them (ops/qmatmul.py::gemm4_plan): TTS_G4_CTAS_PER_SM_8
// (3) for the 8-token tile, TTS_G4_CTAS_PER_SM (2) for the wider ones
// (unbounded, the 64-token tile takes 148 registers, one CTA per SM, and
// runs 1.2-1.3x slower).
template <int MT, int WN>
__global__ void __launch_bounds__(G4_THREADS,
                                  MT == 1 ? TTS_G4_CTAS_PER_SM_8 : TTS_G4_CTAS_PER_SM)
qgemm_int4_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq4,
                  const __half* __restrict__ scales, float* __restrict__ out,
                  int M, int K, int N, int blocks_per_split) {
  using L = G4Smem<MT, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * L::BN, m0 = blockIdx.y * L::BM;
  const int half = K / 2, nblk = half / QBLOCK;
  const int b_begin = blockIdx.z * blocks_per_split;
  const int nb = min(blocks_per_split, nblk - b_begin);

  // packed block b_begin + i -> ring stage i % G4_STAGES (past the edges of
  // N and M the copies zero-fill)
  auto load_stage = [&](int i) {
    unsigned char* st = smem + (i % G4_STAGES) * L::STAGE;
    const int b = b_begin + i;
    for (int j = tid; j < QBLOCK * L::BN / 16; j += G4_THREADS) {  // weights: 16-column chunks
      const int r = j / (L::BN / 16), c = j % (L::BN / 16) * 16;
      const bool ok = n0 + c < N;
      cp_async16(st + r * L::WROW + c,
                 ok ? wq4 + (size_t)(b * QBLOCK + r) * N + n0 + c : wq4, ok);
    }
    if (tid < L::BN / 4) {  // scales of block b (low plane) and b + K/64 (high plane)
      const int p = tid / (L::BN / 8), c = tid % (L::BN / 8) * 8;
      const bool ok = n0 + c < N;
      cp_async16(st + L::W_BYTES + p * L::BN * 2 + c * 2,
                 ok ? scales + (size_t)(b + p * nblk) * N + n0 + c : scales, ok);
    }
    float* xs = reinterpret_cast<float*>(st + L::W_BYTES + L::S_BYTES);
    for (int j = tid; j < L::BM * 16; j += G4_THREADS) {  // x: 8 chunks per plane and row
      const int r = j >> 4, p = (j >> 3) & 1, c = (j & 7) * 4;
      const bool ok = m0 + r < M;
      cp_async16(xs + r * G4_XROW + p * QBLOCK + c,
                 ok ? x + (size_t)(m0 + r) * K + p * half + b * QBLOCK + c : x, ok);
    }
  };

  float acc[WN][MT][4];
#pragma unroll
  for (int w = 0; w < WN; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[w][mt][i] = 0.f;

#pragma unroll
  for (int i = 0; i < G4_STAGES - 1; ++i) {
    if (i < nb) load_stage(i);
    cp_async_commit();                   // empty groups keep the count uniform
  }
  uint4* xb = reinterpret_cast<uint4*>(smem + G4_STAGES * L::STAGE);
  for (int i = 0; i < nb; ++i) {
    cp_async_wait<G4_STAGES - 2>();      // stage i has landed (this thread's copies)
    __syncthreads();                     // everyone's copies; stage i-1 is free
    if (i + G4_STAGES - 1 < nb) load_stage(i + G4_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % G4_STAGES) * L::STAGE;

    // B fragments of this stage, once for all 8 warps: entry
    // ((plane * 2 + step) * MT + mt) * 32 + lane = {hi b0b1, hi b2b3, lo b0b1, lo b2b3}
    const float* xs = reinterpret_cast<const float*>(st + L::W_BYTES + L::S_BYTES);
    for (int e = tid; e < 4 * MT * 32; e += G4_THREADS) {
      const int l = e & 31, mt = (e >> 5) % MT, ps = (e >> 5) / MT;
      const float* xr = xs + (mt * 8 + (l >> 2)) * G4_XROW + ps * 16 + (l & 3);
      float h[4], r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        h[u] = round_bf16(xr[4 * u]);
        r[u] = xr[4 * u] - h[u];         // exact in f32
      }
      xb[e] = make_uint4(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]),
                         pack_bf16x2(r[0], r[1]), pack_bf16x2(r[2], r[3]));
    }
    __syncthreads();

    const __half2* sc = reinterpret_cast<const __half2*>(st + L::W_BYTES);
#pragma unroll
    for (int w = 0; w < WN; ++w) {       // the warp's 16-column tiles
      const int col = (warp * WN + w) * 16;
      const unsigned char* wcol = st + col + 2 * g;   // columns 2g, 2g+1 of the tile
#pragma unroll
      for (int p = 0; p < 2; ++p) {      // low plane (block b), high plane (b + K/64)
        float part[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u) part[mt][u] = 0.f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {    // two k16 steps of the 32-row block
          const unsigned char* wr = wcol + (s * 16 + t) * L::WROW;
          const uint32_t w0 = *reinterpret_cast<const uint16_t*>(wr);
          const uint32_t w4 = *reinterpret_cast<const uint16_t*>(wr + 4 * L::WROW);
          const uint32_t w8 = *reinterpret_cast<const uint16_t*>(wr + 8 * L::WROW);
          const uint32_t w12 = *reinterpret_cast<const uint16_t*>(wr + 12 * L::WROW);
          uint32_t a[4];
          int4_pairs(w0 | (w4 << 16), p, a[0], a[1]);
          int4_pairs(w8 | (w12 << 16), p, a[2], a[3]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint4 bf = xb[((p * 2 + s) * MT + mt) * 32 + lane];
            mma_bf16_16816(part[mt], a, bf.x, bf.y);
            mma_bf16_16816(part[mt], a, bf.z, bf.w);
          }
        }
        // the block's scales of columns 2g and 2g+1 multiply its partial sums
        const float2 s2 = __half22float2(sc[p * (L::BN / 2) + col / 2 + g]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[w][mt][0] = fmaf(part[mt][0], s2.x, acc[w][mt][0]);
          acc[w][mt][1] = fmaf(part[mt][1], s2.x, acc[w][mt][1]);
          acc[w][mt][2] = fmaf(part[mt][2], s2.y, acc[w][mt][2]);
          acc[w][mt][3] = fmaf(part[mt][3], s2.y, acc[w][mt][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // c rows g, g+8 are columns 2g, 2g+1; c columns 2t, 2t+1 are tokens
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int w = 0; w < WN; ++w) {
    const int n = n0 + (warp * WN + w) * 16 + 2 * g;
    if (n >= N) continue;                // N % 16 == 0: n + 1 < N too
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + mt * 8 + 2 * t;
      if (m < M)
        *reinterpret_cast<float2*>(dst + (size_t)m * N + n) =
            make_float2(acc[w][mt][0], acc[w][mt][2]);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(dst + (size_t)(m + 1) * N + n) =
            make_float2(acc[w][mt][1], acc[w][mt][3]);
    }
  }
}

template <int MT, int WN>
int launch_qgemm_int4(const float* x, const int8_t* wq4, const __half* scales, float* dst,
                      int M, int K, int N, int splits, int blocks_per_split, cudaStream_t st) {
  using L = G4Smem<MT, WN>;
  const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_int4_kernel<MT, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM, splits);
  qgemm_int4_kernel<MT, WN><<<grid, G4_THREADS, L::TOTAL, st>>>(x, wq4, scales, dst, M, K, N,
                                                               blocks_per_split);
  return static_cast<int>(cudaGetLastError());
}

// the M tile of MT 8-token tiles, 128 columns per CTA or, up to
// TTS_G4_WIDE_TOKENS tokens, 256; any other tile_n is refused
template <int MT>
int launch_m_tile(int tile_n, const float* x, const int8_t* wq4, const __half* scales,
                  float* dst, int M, int K, int N, int splits, int blocks_per_split,
                  cudaStream_t st) {
  if (tile_n == 128)
    return launch_qgemm_int4<MT, 1>(x, wq4, scales, dst, M, K, N, splits, blocks_per_split, st);
  if constexpr (8 * MT <= TTS_G4_WIDE_TOKENS) {
    if (tile_n == 256)
      return launch_qgemm_int4<MT, 2>(x, wq4, scales, dst, M, K, N, splits, blocks_per_split,
                                      st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// partial: [splits, N] f32 scratch, unused when splits == 1
extern "C" int qgemv_int4(const void* x, const void* wq4, const void* scales, void* partial,
                          void* out, int K, int N, int splits, int blocks_per_split,
                          void* stream) {
  return tts::launch_gemv(qgemv_int4_kernel, x, wq4, scales, partial, out, K, N, splits,
                          blocks_per_split, stream);
}

// x f32 [M, K]; m_tile 8, 16, 32 or 64 tokens and tile_n 128 or 256 columns
// per CTA; K split into `splits` ranges of blocks_per_split packed blocks
// (ops/qmatmul.py::gemm4_plan); partial: [splits, M, N] f32 scratch, unused
// when splits == 1
extern "C" int qgemm_int4(const void* x, const void* wq4, const void* scales, void* partial,
                          void* out, int M, int K, int N, int m_tile, int tile_n, int splits,
                          int blocks_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wq4);
  const __half* sp = static_cast<const __half*>(scales);
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  int err;
  switch (m_tile) {
#define TILE(MTOK)                                                                          \
  case MTOK:                                                                                \
    err = launch_m_tile<MTOK / 8>(tile_n, xp, wp, sp, dst, M, K, N, splits, blocks_per_split, \
                                  st);                                                      \
    break;
    TILE(8) TILE(16) TILE(32) TILE(64)
#undef TILE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || splits == 1) return err;
  const int total = M * N;   // the splits' [M, N] planes, summed in split order
  tts::splitk_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                               static_cast<float*>(out), splits,
                                                               total);
  return static_cast<int>(cudaGetLastError());
}
