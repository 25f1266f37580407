// The parts that the int8 (qmatmul.cu) and int4 (qmatmul4.cu) weight-quantized
// products share: the GEMV (one kernel, two weight formats), the split-K
// pass of qgemm_int4, and qgemm_int8's shared-memory tile steps.  Each
// translation unit that includes this gets its own copy (inline or static).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace tts {

constexpr int QBLOCK = 32;   // rows per f16 scale block

// ---- M == 1 ----------------------------------------------------------------
// TTS_* values come from ops/_ext.py GEOMETRY, which the host plan
// (ops/qmatmul.py::gemv_plan) reads too.
constexpr int GEMV_WARPS = TTS_GEMV_WARPS;          // warps per CTA, each streaming its own blocks
constexpr int GEMV_THREADS = GEMV_WARPS * 32;
constexpr int GEMV_TILE_N = TTS_GEMV_TILE_N;        // weight columns per CTA
constexpr int GEMV_WARP_N = 32 * 4;                 // a warp's columns: 4 per lane, one 32-bit word
constexpr int GEMV_CW = GEMV_TILE_N / GEMV_WARP_N;  // warps side by side across a CTA's columns
constexpr int GEMV_RING = TTS_GEMV_RING;            // 32-row blocks in flight per warp
constexpr int GEMV_MAX_X = TTS_GEMV_MAX_X;          // x elements a CTA stages, at most
constexpr int GEMV_MAX_CLUSTER = TTS_GEMV_MAX_CLUSTER;   // K splits (CTAs of a cluster), at most
static_assert(GEMV_TILE_N % GEMV_WARP_N == 0 && GEMV_WARPS % GEMV_CW == 0,
              "the CTA's warps cover its columns in whole warps");

// Shared memory of a GEMV CTA: per warp GEMV_RING slots of {one 32-row
// block of its GEMV_WARP_N columns [32][GEMV_WARP_N] bytes, their f16
// scales [planes][GEMV_WARP_N]}, then the CTA's slice of x in bf16
// ([planes][per * 32]), then (split K) the cluster's sums of the CTA's
// columns ([splits][GEMV_TILE_N] f32).
template <bool PACKED>
struct GemvSmem {
  static constexpr int PLANES = PACKED ? 2 : 1;    // int4: rows i and i + K/2 share a byte
  static constexpr int TN = GEMV_TILE_N;
  static constexpr int W_BYTES = QBLOCK * GEMV_WARP_N;
  static constexpr int S_BYTES = PLANES * GEMV_WARP_N * 2;
  static constexpr int SLOT = W_BYTES + S_BYTES;
  static constexpr int RING = GEMV_WARPS * GEMV_RING * SLOT;
  static constexpr int TOTAL_MAX = RING + GEMV_MAX_X * 2 + GEMV_MAX_CLUSTER * TN * 4;
  __host__ __device__ static constexpr int x_bytes(int per) { return per * QBLOCK * PLANES * 2; }
  __host__ __device__ static constexpr int total(int per, int splits) {
    return RING + x_bytes(per) + (splits > 1 ? splits * TN * 4 : 0);
  }
};

// byte j of u, a value v in 0..255, as the float v - bias, exactly: the
// bits 0x4B0000vv are the float 2^23 + v (one PRMT and one FADD; no
// integer-to-float conversion, which runs at a quarter of the FMA rate)
__device__ __forceinline__ float byte_minus(uint32_t u, int j, float bias) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) - bias;
}
constexpr float I8_BIAS = 8388608.f + 128.f;   // int8 b: byte b ^ 0x80 is b + 128
constexpr float I4_BIAS = 8388608.f + 8.f;     // int4 q: nibble q ^ 8 is q + 8

// A block lands in GEMV_GROUPS cp.async groups of GEMV_GROUP_ROWS rows, and
// a warp adds each group as it lands: the sums overlap the stream.
constexpr int GEMV_GROUPS = 4;
constexpr int GEMV_GROUP_ROWS = QBLOCK / GEMV_GROUPS;
static_assert(GEMV_GROUP_ROWS == 8, "one 16-byte load of bf16 x per group and plane");

// wait until at most n of this thread's cp.async groups are in flight
// (n is a constant wherever the loops around a call are unrolled)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}
static_assert(GEMV_RING * GEMV_GROUPS <= 8, "cp_async_wait_n covers the groups in flight");

// One 32-row block (slot st) of this lane's 4 columns into acc, each group
// of rows as it lands: the exact int x bf16(x) products summed in f32 per
// block and plane, then each plane's f16 block scale on its partial sum
// (low plane first), as the TPU kernels order it.  xlo / xhi: the block's
// 32 x values of each plane.  The warp's later blocks keep (GEMV_RING - 1)
// * GEMV_GROUPS groups in flight behind this one.
template <bool PACKED>
__device__ __forceinline__ void gemv_block(const unsigned char* st, const __nv_bfloat16* xlo,
                                           const __nv_bfloat16* xhi, int lane,
                                           float (&acc)[4]) {
  using L = GemvSmem<PACKED>;
  const uint32_t* wr = reinterpret_cast<const uint32_t*>(st) + lane;
  float plo[4] = {0.f, 0.f, 0.f, 0.f}, phi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < GEMV_GROUPS; ++g) {
    cp_async_wait_n(GEMV_RING * GEMV_GROUPS - 1 - g);   // group g has landed (this lane's) ...
    __syncwarp();                                       // ... and the warp's
    const int r0 = g * GEMV_GROUP_ROWS;
    float xl[8], xh[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(xlo + r0), xl);
    if constexpr (PACKED) unpack_bf16x8(*reinterpret_cast<const uint4*>(xhi + r0), xh);
#pragma unroll
    for (int u = 0; u < GEMV_GROUP_ROWS; ++u) {
      const uint32_t v = wr[(r0 + u) * (GEMV_WARP_N / 4)];
      if constexpr (PACKED) {
        const uint32_t lo = (v & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t hi = ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[j] = fmaf(xl[u], byte_minus(lo, j, I4_BIAS), plo[j]);
          phi[j] = fmaf(xh[u], byte_minus(hi, j, I4_BIAS), phi[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          plo[j] = fmaf(xl[u], byte_minus(v ^ 0x80808080u, j, I8_BIAS), plo[j]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < L::PLANES; ++p) {
    const uint2 s =
        *reinterpret_cast<const uint2*>(st + L::W_BYTES + p * GEMV_WARP_N * 2 + lane * 8);
    const float2 s01 = __half22float2(*reinterpret_cast<const __half2*>(&s.x));
    const float2 s23 = __half22float2(*reinterpret_cast<const __half2*>(&s.y));
    const float* part = p == 0 ? plo : phi;
    acc[0] = fmaf(part[0], s01.x, acc[0]);
    acc[1] = fmaf(part[1], s01.y, acc[1]);
    acc[2] = fmaf(part[2], s23.x, acc[2]);
    acc[3] = fmaf(part[3], s23.y, acc[3]);
  }
}

// out [N] f32 = x [K] @ dequant(w, scales): w int8 [K, N], or (PACKED)
// int4 [K/2, N] with row i in the low nibble and row i + K/2 in the high
// one; scales f16 [K/32, N]; x bf16, or (XF32) f32 rounded here to bf16.
// grid (splits, column tiles of GEMV_TILE_N), GEMV_THREADS threads; CTA
// (s, t) takes weight blocks [s * per, (s + 1) * per) of column tile t.
// Warp w takes the tile's GEMV_WARP_N columns w % CW and the range's blocks
// w / CW, w / CW + KW, ... (CW = GEMV_CW, KW = GEMV_WARPS / CW), keeping
// GEMV_RING of them in flight through cp.async with no CTA barrier; the CW
// warps of a block read its rows' GEMV_TILE_N bytes side by side, at about
// one time.
// The sums: per warp in block order, then per column the CTA's warps in
// warp order, then the splits in split order: the splits of a column tile
// are one thread-block cluster (dims (splits, 1, 1)) and add through
// distributed shared memory.
template <bool PACKED, bool XF32>
__global__ void __launch_bounds__(GEMV_THREADS, TTS_GEMV_CTAS_PER_SM)
qgemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
             const __half* __restrict__ scales, float* __restrict__ out, int K, int N, int per) {
  using L = GemvSmem<PACKED>;
  constexpr int CW = GEMV_CW, KW = GEMV_WARPS / CW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp / CW;
  const int n0 = blockIdx.y * L::TN + warp % CW * GEMV_WARP_N;   // this warp's columns
  const int rows = K / L::PLANES;                  // rows of w
  const int nblk = rows / QBLOCK;
  const int b0 = blockIdx.x * per;
  const int nb = max(0, min(per, nblk - b0));      // this CTA's blocks
  const int mine = nb > kw ? (nb - kw + KW - 1) / KW : 0;
  unsigned char* ring = smem + warp * GEMV_RING * L::SLOT;
  const int splits = gridDim.x;
  // a CTA writes into another's shared memory only once every CTA of the
  // cluster runs: arrive now, wait before the first remote store
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the warp's j-th block (b0 + kw + j * KW) -> its slot j % GEMV_RING;
  // 16-byte chunks past N are zero-filled (N % 16 == 0)
  auto load_block = [&](int j) {          // always commits GEMV_GROUPS groups
    unsigned char* st = ring + (j % GEMV_RING) * L::SLOT;
    const int b = b0 + kw + j * KW;
    const bool live = j < mine;
    if (live && lane < L::S_BYTES / 16) {  // scale block b (low plane), b + K/64 (high plane)
      const int p = lane / (GEMV_WARP_N / 8), col = lane % (GEMV_WARP_N / 8) * 8;
      const bool ok = n0 + col < N;
      cp_async16(st + L::W_BYTES + p * GEMV_WARP_N * 2 + col * 2,
                 ok ? scales + (size_t)(b + p * nblk) * N + n0 + col : scales, ok);
    }
#pragma unroll
    for (int q = 0; q < L::W_BYTES / 16 / 32; ++q) {   // 4 rows of 8 chunks each
      const int c = q * 32 + lane, r = c / (GEMV_WARP_N / 16);
      const int col = c % (GEMV_WARP_N / 16) * 16;
      const bool ok = n0 + col < N;
      if (live)
        cp_async16(st + r * GEMV_WARP_N + col,
                   ok ? w + (size_t)(b * QBLOCK + r) * N + n0 + col : w, ok);
      if ((q + 1) * 4 % GEMV_GROUP_ROWS == 0) cp_async_commit();
    }
  };
#pragma unroll
  for (int j = 0; j < GEMV_RING; ++j) load_block(j);

  // while the weights fly: xs[p * xn + i] = bf16(x[p * rows + b0 * 32 + i])
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::RING);
  const int xn = nb * QBLOCK;
  for (int i = tid * 8; i < L::PLANES * xn; i += GEMV_THREADS * 8) {
    const int p = i >= xn;
    const size_t g = (size_t)p * rows + (size_t)b0 * QBLOCK + (i - p * xn);
    uint4 v;
    if constexpr (XF32) {
      const float4* xf = reinterpret_cast<const float4*>(static_cast<const float*>(x) + g);
      const float4 a = __ldg(xf), c = __ldg(xf + 1);
      v = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(c.x, c.y),
                     pack_bf16x2(c.z, c.w));
    } else {
      v = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + g));
    }
    *reinterpret_cast<uint4*>(xs + i) = v;
  }
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < mine; ++j) {
    const int lb = kw + j * KW;
    gemv_block<PACKED>(ring + (j % GEMV_RING) * L::SLOT, xs + lb * QBLOCK,
                       xs + xn + lb * QBLOCK, lane, acc);
    __syncwarp();                        // the slot is read: refill it
    load_block(j + GEMV_RING);
  }
  cp_async_wait<0>();

  // per column, the warps' sums in warp order, each warp's row in its own
  // (read) ring; column c of the tile is warp (kw, c / GEMV_WARP_N)'s
  *reinterpret_cast<float4*>(ring + lane * 16) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  // rank r of the cluster is split r, and owns the columns c with
  // c % splits == r: every rank stores its sum of column c into the
  // owner's pushed[r][c], and after one cluster barrier each owner adds
  // its columns' sums in split order from its own shared memory
  float (*pushed)[L::TN] =
      reinterpret_cast<float (*)[L::TN]>(smem + L::RING + L::x_bytes(per));
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int c = tid; c < L::TN; c += GEMV_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < KW; ++k)
      sum += reinterpret_cast<const float*>(
          smem + (k * CW + c / GEMV_WARP_N) * GEMV_RING * L::SLOT)[c % GEMV_WARP_N];
    const int n = blockIdx.y * L::TN + c;
    if (splits == 1) {
      if (n < N) out[n] = sum;
    } else {
      *cluster.map_shared_rank(&pushed[blockIdx.x][c], c % splits) = sum;
    }
  }
  if (splits == 1) return;
  cluster.sync();
  for (int c = blockIdx.x + splits * tid; c < L::TN; c += splits * GEMV_THREADS) {
    float v[GEMV_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < GEMV_MAX_CLUSTER; ++r)
      if (r < splits) v[r] = pushed[r][c];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < GEMV_MAX_CLUSTER; ++r)
      if (r < splits) s += v[r];
    const int n = blockIdx.y * L::TN + c;
    if (n < N) out[n] = s;
  }
}

// One GEMV call: grid (splits, column tiles), the splits of a column tile
// one cluster; returns a CUDA error code (0: launched).
template <bool PACKED>
int launch_qgemv(const void* x, int x_f32, const void* w, const void* scales, void* out, int K,
                 int N, int splits, int per, void* stream) {
  using L = GemvSmem<PACKED>;
  if (splits < 1 || splits > GEMV_MAX_CLUSTER || L::x_bytes(per) > GEMV_MAX_X * 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = x_f32 ? &qgemv_kernel<PACKED, true> : &qgemv_kernel<PACKED, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::TOTAL_MAX);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + L::TN - 1) / L::TN, 1);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::total(per, splits);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, static_cast<const int8_t*>(w),
                           static_cast<const __half*>(scales), static_cast<float*>(out), K, N, per);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out[n] = sum over splits of partial[s, n], in split order (deterministic);
// N here is the length of one split's plane (qgemm_int4's split-K pass)
static __global__ void splitk_sum_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out, int splits, int N) {
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
