// The kernels of the int8 (qmatmul.cu) and int4 (qmatmul4.cu) weight-quantized
// products, each written once for both weight formats: the GEMV (M == 1)
// and the tensor-core GEMM (M > 1) with its split-K pass.  Each translation
// unit that includes this instantiates its own format (inline or static).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

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

// One weight word (this lane's 4 columns of one row) times its x: the exact
// int x bf16(x) products added in f32 to the row's plane sums (int4: the
// low nibbles meet xl, row i's, the high ones xh, row i + K/2's).
template <bool PACKED>
__device__ __forceinline__ void gemv_word(uint32_t v, float xl, float xh, float (&plo)[4],
                                          float (&phi)[4]) {
  if constexpr (PACKED) {
    const uint32_t lo = (v & 0x0F0F0F0Fu) ^ 0x08080808u;
    const uint32_t hi = ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      plo[j] = fmaf(xl, byte_minus(lo, j, I4_BIAS), plo[j]);
      phi[j] = fmaf(xh, byte_minus(hi, j, I4_BIAS), phi[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) plo[j] = fmaf(xl, byte_minus(v ^ 0x80808080u, j, I8_BIAS), plo[j]);
  }
}

// acc += part * s, per column: s the 4 columns' f16 block scales of one plane
__device__ __forceinline__ void gemv_scale(uint2 s, const float (&part)[4], float (&acc)[4]) {
  const float2 s01 = __half22float2(*reinterpret_cast<const __half2*>(&s.x));
  const float2 s23 = __half22float2(*reinterpret_cast<const __half2*>(&s.y));
  acc[0] = fmaf(part[0], s01.x, acc[0]);
  acc[1] = fmaf(part[1], s01.y, acc[1]);
  acc[2] = fmaf(part[2], s23.x, acc[2]);
  acc[3] = fmaf(part[3], s23.y, acc[3]);
}

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
    for (int u = 0; u < GEMV_GROUP_ROWS; ++u)
      gemv_word<PACKED>(wr[(r0 + u) * (GEMV_WARP_N / 4)], xl[u], PACKED ? xh[u] : 0.f, plo, phi);
  }
#pragma unroll
  for (int p = 0; p < L::PLANES; ++p)
    gemv_scale(*reinterpret_cast<const uint2*>(st + L::W_BYTES + p * GEMV_WARP_N * 2 + lane * 8),
               p == 0 ? plo : phi, acc);
}

// The cluster instance (qgemv_kernel<PACKED, XF32, 0>), for calls whose
// weights fill the card: grid (splits, column tiles of GEMV_TILE_N),
// GEMV_THREADS threads; CTA (s, t) takes weight blocks [s * per, (s + 1) *
// per) of column tile t.
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
__device__ __forceinline__ void gemv_cluster(const void* __restrict__ x,
                                             const int8_t* __restrict__ w,
                                             const __half* __restrict__ scales,
                                             float* __restrict__ out, int K, int N, int per) {
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

// The small-call instance (qgemv_kernel<PACKED, XF32, ROWS>, ROWS > 0), for
// calls whose weights are too few to keep GEMV_TILE_N-wide CTAs on every SM
// (ops/qmatmul.py::gemv_plan: Parler-TTS mini v1's linears, 0.6-2.4 MB of
// Q4_0): the column tiles narrow to tile_n (4-128; the plan takes 16-128) so
// that they alone spread the call over the card, a CTA takes every row of
// its columns, and K splits among its threads, never across CTAs: no
// cluster, no barrier between CTAs, no distributed shared memory.  grid
// (1, column tiles), tile_n / 4 * rows /
// ROWS threads (rows: of w), all of them busy: thread t takes the 4 columns
// t % (tile_n / 4) and the ROWS rows of slice t / (tile_n / 4), which lie in
// one weight block, and loads every weight word and scale it adds as its
// first instructions; while they fly, the CTA stages x.  The sums: per
// thread its slice in row order (gemv_word), each plane's block scale on its
// plane sum, low plane first (gemv_block's order); then per column a
// pairwise tree over the slices of a warp (xor shuffles: both partners of an
// add hold the same bits) and the warps in warp order through shared memory.
// Identical bits every run, and no state outside the launch.
struct GemvSmallSmem {
  // x as the f32 of its bf16, one pad word after every 32 (a warp's slices
  // read rows 32 apart on distinct banks), 16-byte aligned; then the warps'
  // sums [warps][tile_n]
  __host__ __device__ static constexpr int x_floats(int K) { return (K + K / 32 + 3) & ~3; }
  __host__ __device__ static constexpr int total(int K, int threads, int tile_n) {
    return (x_floats(K) + (threads > 32 ? threads / 32 * tile_n : 0)) * 4;
  }
};
constexpr int GEMV_SMALL_MAX_THREADS = TTS_GEMV_SMALL_MAX_THREADS;

template <bool PACKED, bool XF32, int ROWS>
__device__ __forceinline__ void gemv_small(const void* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           const __half* __restrict__ scales,
                                           float* __restrict__ out, int K, int N) {
  static_assert(ROWS >= 1 && QBLOCK % ROWS == 0, "a thread's rows lie in one weight block");
  constexpr int PLANES = PACKED ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = K / PLANES, nblk = rows / QBLOCK;
  const int groups = blockDim.x * ROWS / rows;            // 4-column groups of the tile
  const int tile_n = 4 * groups;
  const int r0 = tid / groups * ROWS;                     // this thread's rows r0 .. + ROWS - 1
  const int n = blockIdx.y * tile_n + tid % groups * 4;   // and its columns n .. n + 3
  const bool live = n < N;                                // (N % 16 == 0: all 4 or none)
  uint32_t v[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u)
    v[u] = live ? __ldg(reinterpret_cast<const unsigned int*>(w + (size_t)(r0 + u) * N + n)) : 0u;
  uint2 s[PLANES];                                        // block r0 / 32, and + K/64 (high plane)
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
    s[p] = live ? __ldg(reinterpret_cast<const uint2*>(
                      scales + (size_t)(r0 / QBLOCK + p * nblk) * N + n))
                : make_uint2(0u, 0u);

  // while they fly: xs[i + i / 32] = bf16(x[i])
  float* xs = reinterpret_cast<float*>(smem);
  for (int i = tid * 4; i < K; i += blockDim.x * 4) {
    float f[4];
    if constexpr (XF32) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) + i));
      f[0] = round_bf16(a.x), f[1] = round_bf16(a.y);
      f[2] = round_bf16(a.z), f[3] = round_bf16(a.w);
    } else {
      const auto* xb = static_cast<const __nv_bfloat16*>(x) + i;
      unpack_bf16x4(__ldg(reinterpret_cast<const uint2*>(xb)), f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[i + i / 32 + j] = f[j];   // i % 4 == 0: one pad offset
  }
  __syncthreads();

  // the slice's rows are one run of xs; the high plane's rows + K/2 another
  const float* xl = xs + r0 + r0 / 32;
  const float* xh = xs + (rows + r0) + (rows + r0) / 32;
  float plo[4] = {0.f, 0.f, 0.f, 0.f}, phi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < ROWS; ++u) gemv_word<PACKED>(v[u], xl[u], PACKED ? xh[u] : 0.f, plo, phi);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  gemv_scale(s[0], plo, acc);
  if constexpr (PACKED) gemv_scale(s[1], phi, acc);

#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    if (m < groups) continue;                             // lanes m apart: the next slice up
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
  }
  // lanes 0 .. groups - 1 hold the warp's sums, column group = lane
  const int warps = blockDim.x / 32;
  if (warps == 1) {
    if (lane < groups && live)
      *reinterpret_cast<float4*>(out + n) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  float* red = xs + GemvSmallSmem::x_floats(K);
  if (lane < groups)
    *reinterpret_cast<float4*>(red + warp * tile_n + lane * 4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  for (int c = tid; c < tile_n; c += blockDim.x) {
    float sum = red[c];
    for (int k = 1; k < warps; ++k) sum += red[k * tile_n + c];
    const int col = blockIdx.y * tile_n + c;
    if (col < N) out[col] = sum;
  }
}

// out [N] f32 = x [K] @ dequant(w, scales): w int8 [K, N], or (PACKED)
// int4 [K/2, N] with row i in the low nibble and row i + K/2 in the high
// one; scales f16 [K/32, N]; x bf16, or (XF32) f32 rounded here to bf16.
// ROWS 0: the cluster instance (gemv_cluster); ROWS > 0: the small-call
// instance with ROWS weight rows per thread (gemv_small, which ignores per:
// its one CTA per column tile takes all of K).
template <bool PACKED, bool XF32, int ROWS>
__global__ void __launch_bounds__(ROWS ? GEMV_SMALL_MAX_THREADS : GEMV_THREADS,
                                  ROWS ? 1 : TTS_GEMV_CTAS_PER_SM)
qgemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
             const __half* __restrict__ scales, float* __restrict__ out, int K, int N, int per) {
  if constexpr (ROWS > 0)
    gemv_small<PACKED, XF32, ROWS>(x, w, scales, out, K, N);
  else
    gemv_cluster<PACKED, XF32>(x, w, scales, out, K, N, per);
}

template <bool PACKED, bool XF32>
using GemvKernel = decltype(&qgemv_kernel<PACKED, XF32, 0>);

// the small-call instance of ROWS rows per thread (nullptr: none)
template <bool PACKED, bool XF32>
GemvKernel<PACKED, XF32> small_gemv_kernel(int rows) {
  switch (rows) {
    case 1: return &qgemv_kernel<PACKED, XF32, 1>;
    case 2: return &qgemv_kernel<PACKED, XF32, 2>;
    case 4: return &qgemv_kernel<PACKED, XF32, 4>;
    case 8: return &qgemv_kernel<PACKED, XF32, 8>;
    case 16: return &qgemv_kernel<PACKED, XF32, 16>;
    case 32: return &qgemv_kernel<PACKED, XF32, 32>;
    default: return nullptr;
  }
}

// One GEMV call, as ops/qmatmul.py::gemv_plan sets it: rows 0, the cluster
// instance, grid (splits, column tiles of GEMV_TILE_N), the splits of a
// column tile one cluster; rows > 0, the small-call instance, grid (1,
// column tiles of tile_n), tile_n / 4 * (K rows) / rows threads (splits 1,
// per every block).  Returns a CUDA error code (0: launched).
template <bool PACKED>
int launch_qgemv(const void* x, int x_f32, const void* w, const void* scales, void* out, int K,
                 int N, int tile_n, int splits, int per, int rows, void* stream) {
  using L = GemvSmem<PACKED>;
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto wq = static_cast<const int8_t*>(w);
  const auto sc = static_cast<const __half*>(scales);
  const auto o = static_cast<float*>(out);
  if (rows > 0) {
    const int wrows = PACKED ? K / 2 : K, groups = tile_n / 4;
    const int threads = groups * (wrows / rows);
    const auto kernel = x_f32 ? small_gemv_kernel<PACKED, true>(rows)
                              : small_gemv_kernel<PACKED, false>(rows);
    if (kernel == nullptr || tile_n < 4 || tile_n > 128 || (groups & (groups - 1)) ||
        splits != 1 || per * QBLOCK != wrows || threads % 32 || threads < 32 ||
        threads > GEMV_SMALL_MAX_THREADS || K > GEMV_MAX_X)
      return bad;
    kernel<<<dim3(1, (N + tile_n - 1) / tile_n, 1), threads,
             GemvSmallSmem::total(K, threads, tile_n), st>>>(x, wq, sc, o, K, N, per);
    return static_cast<int>(cudaGetLastError());
  }
  if (tile_n != GEMV_TILE_N || splits < 1 || splits > GEMV_MAX_CLUSTER ||
      L::x_bytes(per) > GEMV_MAX_X * 2)
    return bad;
  const auto kernel = x_f32 ? &qgemv_kernel<PACKED, true, 0> : &qgemv_kernel<PACKED, false, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::TOTAL_MAX);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + L::TN - 1) / L::TN, 1);
  cfg.blockDim = dim3(GEMV_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::total(per, splits);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, wq, sc, o, K, N, per);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- M > 1 -----------------------------------------------------------------
// qgemm_int8 and qgemm_int4: one tensor-core kernel, qgemm_kernel<PACKED,
// XF32, MT, WN>, for both weight formats and for bf16 or f32 x.  TTS_G8_* /
// TTS_G4_* come from ops/_ext.py GEOMETRY, which the host plan
// (ops/qmatmul.py::gemm_plan) reads too.
constexpr int GEMM_THREADS = 256;   // 8 warps side by side across the CTA's columns

template <bool PACKED>
struct GemmGeometry {
  static constexpr int STAGES = PACKED ? TTS_G4_STAGES : TTS_G8_STAGES;   // cp.async ring depth
  static constexpr int CTAS_PER_SM_8 = PACKED ? TTS_G4_CTAS_PER_SM_8 : TTS_G8_CTAS_PER_SM_8;
  static constexpr int CTAS_PER_SM = PACKED ? TTS_G4_CTAS_PER_SM : TTS_G8_CTAS_PER_SM;
  static constexpr int WIDE_TOKENS = PACKED ? TTS_G4_WIDE_TOKENS : TTS_G8_WIDE_TOKENS;
};

// Shared memory of one CTA with MT 8-token tiles and WN 16-column tiles per
// warp (BN = 128 WN columns): STAGES stages of {one 32-row weight block
// [32][WROW] bytes, its scales [PLANES][BN] f16, the x columns it meets
// [BM][XK] (bf16, or f32 when XF32) in rows of XROW bytes}, then (XF32 only)
// the current stage's x as bf16 hi and lo terms, [2][BM] rows of BROW bytes.
template <bool PACKED, bool XF32, int MT, int WN>
struct GemmSmem {
  static constexpr int PLANES = PACKED ? 2 : 1;    // int4: rows i and i + K/2 share a byte
  static constexpr int STAGES = GemmGeometry<PACKED>::STAGES;
  static constexpr int BM = 8 * MT;
  static constexpr int BN = 128 * WN;
  static constexpr int WROW = BN + 16;             // padded: the fragment loads hit distinct banks
  static constexpr int XK = PLANES * QBLOCK;       // x columns of a stage
  static constexpr int BROW = (XK + 8) * 2;        // a bf16 row, padded: ldmatrix rows on distinct banks
  static constexpr int XROW = XF32 ? XK * 4 + 16 : BROW;
  static constexpr int W_BYTES = QBLOCK * WROW;
  static constexpr int S_BYTES = PLANES * BN * 2;
  static constexpr int STAGE = W_BYTES + S_BYTES + BM * XROW;
  static constexpr int TOTAL = STAGES * STAGE + (XF32 ? 2 * BM * BROW : 0);
};

// Fragment order.  Weight columns sit on the MMA's 16-row side and tokens on
// its 8-wide side: A row g is weight column 2g and A row g+8 column 2g+1 of
// the warp's 16, so lane (g, t) reads both columns with one 16-bit load of
// a weight row; its k slots 2t, 2t+1 (2t+8, 2t+9) are weight rows 2t, 2t+1
// (2t+8, 2t+9) of the k16 step, so B is x in its own order and ldmatrix
// reads it straight from the staged rows.

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

// The same for int8 bytes.  bf16 keeps 8 significant bits, so no bias puts
// 256 byte values on consecutive bf16 integers: each byte becomes its exact
// float first (byte_minus: one PRMT and one FADD), and an integer of at
// most 8 significant bits is its f32's upper half, so one PRMT packs two
// of them as bf16 with no rounding (what cvt.rn.bf16x2.f32 would give).
__device__ __forceinline__ void int8_pairs(uint32_t w, uint32_t& c0, uint32_t& c1) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(byte_minus(u, 0, I8_BIAS));
  const uint32_t f1 = __float_as_uint(byte_minus(u, 1, I8_BIAS));
  const uint32_t f2 = __float_as_uint(byte_minus(u, 2, I8_BIAS));
  const uint32_t f3 = __float_as_uint(byte_minus(u, 3, I8_BIAS));
  c0 = __byte_perm(f0, f2, 0x7632);
  c1 = __byte_perm(f1, f3, 0x7632);
}

// two 8x8 bf16 matrices: lane l < 16 gives the address of row l % 8 of
// matrix l / 8, and every lane gets row l / 4, columns 2 (l % 4) .. +1 of
// each: one k16 step's B fragment of x stored token-major
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// the same for four matrices, lane l giving row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// out = x [M, K] @ dequant(w, scales) over weight blocks [blockIdx.z * per,
// +per) -> out [gridDim.z][M][N] (the split's partial sums, or the result
// when gridDim.z == 1).  w int8 [K, N], or (PACKED) int4 [K/2, N] with row i
// in the low nibble and row i + K/2 in the high one; scales f16 [K/32, N];
// x bf16, or (XF32) f32.  grid (N / BN, M / BM, splits), GEMM_THREADS
// threads, GemmSmem::TOTAL bytes.  Register caps set the CTAs resident per
// SM (GemmGeometry), and the host plan splits K into one wave of them.
// Per stage: the exact integer x bf16(x) products of one 32-row block (and
// nibble plane) summed by the tensor cores in f32, then the block's f16
// scale on that sum; f32 x is split into hi = bf16(x) and lo = bf16(x -
// hi), both multiplied (about 16 bits of x), bf16 x runs one product.
template <bool PACKED, bool XF32, int MT, int WN>
__global__ void __launch_bounds__(GEMM_THREADS, MT == 1 ? GemmGeometry<PACKED>::CTAS_PER_SM_8
                                                        : GemmGeometry<PACKED>::CTAS_PER_SM)
qgemm_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
             const __half* __restrict__ scales, float* __restrict__ out, int M, int K, int N,
             int per) {
  using L = GemmSmem<PACKED, XF32, MT, WN>;
  using XT = typename std::conditional<XF32, float, __nv_bfloat16>::type;
  constexpr int XCH = 16 / sizeof(XT);            // x elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * L::BN, m0 = blockIdx.y * L::BM;
  const int rows = K / L::PLANES, nblk = rows / QBLOCK;   // rows of w, its 32-row blocks
  const int b_begin = blockIdx.z * per;
  const int nb = min(per, nblk - b_begin);
  const XT* xp = static_cast<const XT*>(x);

  // weight block b_begin + i -> ring stage i % STAGES (past the edges of N
  // and M the copies zero-fill)
  auto load_stage = [&](int i) {
    unsigned char* st = smem + (i % L::STAGES) * L::STAGE;
    const int b = b_begin + i;
    for (int j = tid; j < QBLOCK * L::BN / 16; j += GEMM_THREADS) {   // weights: 16-column chunks
      const int r = j / (L::BN / 16), c = j % (L::BN / 16) * 16;
      const bool ok = n0 + c < N;
      cp_async16(st + r * L::WROW + c, ok ? w + (size_t)(b * QBLOCK + r) * N + n0 + c : w, ok);
    }
    if (tid < L::PLANES * L::BN / 8) {   // scales of block b (low plane), b + K/64 (high plane)
      const int p = tid / (L::BN / 8), c = tid % (L::BN / 8) * 8;
      const bool ok = n0 + c < N;
      cp_async16(st + L::W_BYTES + p * L::BN * 2 + c * 2,
                 ok ? scales + (size_t)(b + p * nblk) * N + n0 + c : scales, ok);
    }
    unsigned char* xs = st + L::W_BYTES + L::S_BYTES;
    for (int j = tid; j < L::BM * (L::XK / XCH); j += GEMM_THREADS) {   // x: each plane's 32
      const int r = j / (L::XK / XCH), e = j % (L::XK / XCH) * XCH;
      const int p = e / QBLOCK;
      const bool ok = m0 + r < M;
      cp_async16(xs + r * L::XROW + e * (int)sizeof(XT),
                 ok ? xp + (size_t)(m0 + r) * K + p * rows + b * QBLOCK + e % QBLOCK : xp, ok);
    }
  };

  float acc[WN][MT][4];
#pragma unroll
  for (int wi = 0; wi < WN; ++wi)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[wi][mt][u] = 0.f;

#pragma unroll
  for (int i = 0; i < L::STAGES - 1; ++i) {
    if (i < nb) load_stage(i);
    cp_async_commit();                   // empty groups keep the count uniform
  }
  unsigned char* hilo = smem + L::STAGES * L::STAGE;
  // this lane's ldmatrix row: token lane % 8 of a tile, x columns 8 (lane / 8 % 2)
  // .. of a step, and for f32 x lanes 16-31 the same in the lo terms
  const int lrow = (lane & 7) * L::BROW + (lane >> 3 & 1) * 16 +
                   (XF32 ? (lane >> 4) * L::BM * L::BROW : 0);
  for (int i = 0; i < nb; ++i) {
    cp_async_wait<L::STAGES - 2>();      // stage i has landed (this thread's copies)
    __syncthreads();                     // everyone's copies; stage i-1 (and hilo) is free
    if (i + L::STAGES - 1 < nb) load_stage(i + L::STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % L::STAGES) * L::STAGE;
    const unsigned char* xs = st + L::W_BYTES + L::S_BYTES;
    if constexpr (XF32) {                // hi = bf16(x), lo = bf16(x - hi): x - hi is exact in f32
      for (int e = tid; e < L::BM * L::XK / 2; e += GEMM_THREADS) {
        const int r = e / (L::XK / 2), c = e % (L::XK / 2) * 2;
        const float2 v = *reinterpret_cast<const float2*>(xs + r * L::XROW + c * 4);
        const uint32_t h = pack_bf16x2(v.x, v.y);
        *reinterpret_cast<uint32_t*>(hilo + r * L::BROW + c * 2) = h;
        *reinterpret_cast<uint32_t*>(hilo + (L::BM + r) * L::BROW + c * 2) =
            pack_bf16x2(v.x - __uint_as_float(h << 16), v.y - __uint_as_float(h & 0xffff0000u));
      }
      __syncthreads();
    }
    const uint32_t xb = static_cast<uint32_t>(__cvta_generic_to_shared(XF32 ? hilo : xs)) + lrow;
    const __half2* sc = reinterpret_cast<const __half2*>(st + L::W_BYTES);
#pragma unroll
    for (int wi = 0; wi < WN; ++wi) {    // the warp's 16-column tiles
      const int col = (warp * WN + wi) * 16;
      // weight rows 2t, 2t+1, 2t+8, 2t+9 of each k16 step, columns col + 2g, +1
      uint32_t wd[2][2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const unsigned char* wr = st + (s * 16 + 2 * t) * L::WROW + col + 2 * g;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wd[s][h] = *reinterpret_cast<const uint16_t*>(wr + 8 * h * L::WROW) |
                     (uint32_t)*reinterpret_cast<const uint16_t*>(wr + (8 * h + 1) * L::WROW) << 16;
      }
      // the 64-token tile takes one plane at a time (within the register
      // cap of two CTAs per SM), the narrower ones both together
#pragma unroll(MT >= 8 ? 1 : 2)
      for (int p = 0; p < L::PLANES; ++p) {   // low plane (block b), high plane (b + K/64)
        float part[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u) part[mt][u] = 0.f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {    // the block's two k16 steps
          uint32_t a[4];
          if constexpr (PACKED) {
            int4_pairs(wd[s][0], p, a[0], a[1]);
            int4_pairs(wd[s][1], p, a[2], a[3]);
          } else {
            int8_pairs(wd[s][0], a[0], a[1]);
            int8_pairs(wd[s][1], a[2], a[3]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // x columns 0-7 and 8-15 of the step, tokens of tile mt
            const uint32_t off = mt * 8 * L::BROW + (p * QBLOCK + s * 16) * 2;
            if constexpr (XF32) {
              uint32_t b[4];               // {hi b0, hi b1, lo b0, lo b1}
              ldmatrix_x4(b, xb + off);
              mma_bf16_16816(part[mt], a, b[0], b[1]);
              mma_bf16_16816(part[mt], a, b[2], b[3]);
            } else {
              uint32_t b[2];
              ldmatrix_x2(b, xb + off);
              mma_bf16_16816(part[mt], a, b[0], b[1]);
            }
          }
        }
        // the block's scales of columns 2g and 2g+1 multiply its partial sums
        const float2 s2 = __half22float2(sc[p * (L::BN / 2) + col / 2 + g]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[wi][mt][0] = fmaf(part[mt][0], s2.x, acc[wi][mt][0]);
          acc[wi][mt][1] = fmaf(part[mt][1], s2.x, acc[wi][mt][1]);
          acc[wi][mt][2] = fmaf(part[mt][2], s2.y, acc[wi][mt][2]);
          acc[wi][mt][3] = fmaf(part[mt][3], s2.y, acc[wi][mt][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // c rows g, g+8 are columns 2g, 2g+1; c columns 2t, 2t+1 are tokens
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int wi = 0; wi < WN; ++wi) {
    const int n = n0 + (warp * WN + wi) * 16 + 2 * g;
    if (n >= N) continue;                // N % 16 == 0: n + 1 < N too
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + mt * 8 + 2 * t;
      if (m < M)
        *reinterpret_cast<float2*>(dst + (size_t)m * N + n) =
            make_float2(acc[wi][mt][0], acc[wi][mt][2]);
      if (m + 1 < M)
        *reinterpret_cast<float2*>(dst + (size_t)(m + 1) * N + n) =
            make_float2(acc[wi][mt][1], acc[wi][mt][3]);
    }
  }
}

template <bool PACKED, bool XF32, int MT, int WN>
int launch_gemm_tile(const void* x, const void* w, const void* scales, float* dst, int M, int K,
                     int N, int splits, int per, cudaStream_t st) {
  using L = GemmSmem<PACKED, XF32, MT, WN>;
  const auto kernel = &qgemm_kernel<PACKED, XF32, MT, WN>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM, splits);
  kernel<<<grid, GEMM_THREADS, L::TOTAL, st>>>(x, static_cast<const int8_t*>(w),
                                               static_cast<const __half*>(scales), dst, M, K, N,
                                               per);
  return static_cast<int>(cudaGetLastError());
}

// the M tile of MT 8-token tiles, 128 columns per CTA or, up to the
// format's WIDE_TOKENS tokens, 256; any other tile_n is refused
template <bool PACKED, bool XF32, int MT>
int launch_gemm_m(int tile_n, const void* x, const void* w, const void* scales, float* dst,
                  int M, int K, int N, int splits, int per, cudaStream_t st) {
  if (tile_n == 128)
    return launch_gemm_tile<PACKED, XF32, MT, 1>(x, w, scales, dst, M, K, N, splits, per, st);
  if constexpr (8 * MT <= GemmGeometry<PACKED>::WIDE_TOKENS) {
    if (tile_n == 256)
      return launch_gemm_tile<PACKED, XF32, MT, 2>(x, w, scales, dst, M, K, N, splits, per, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PACKED, bool XF32>
int launch_gemm_x(int m_tile, int tile_n, const void* x, const void* w, const void* scales,
                  float* dst, int M, int K, int N, int splits, int per, cudaStream_t st) {
  switch (m_tile) {
#define TILE(MTOK)                                                                              \
  case MTOK:                                                                                    \
    return launch_gemm_m<PACKED, XF32, MTOK / 8>(tile_n, x, w, scales, dst, M, K, N, splits, per, \
                                                 st);
    TILE(8) TILE(16) TILE(32) TILE(64)
#undef TILE
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// One GEMM call: x [M, K] bf16 (x_f32: f32); m_tile 8, 16, 32 or 64 tokens
// and tile_n 128 or 256 columns per CTA; K split into `splits` ranges of
// `per` weight blocks (ops/qmatmul.py::gemm_plan); partial: [splits, M, N]
// f32 scratch, unused when splits == 1, the splits then added in order by a
// second kernel.  Returns a CUDA error code (0: launched).
template <bool PACKED>
int launch_qgemm(const void* x, int x_f32, const void* w, const void* scales, void* partial,
                 void* out, int M, int K, int N, int m_tile, int tile_n, int splits, int per,
                 void* stream) {
  if (splits < 1 || per < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits == 1 ? out : partial);
  const int err = x_f32 ? launch_gemm_x<PACKED, true>(m_tile, tile_n, x, w, scales, dst, M, K, N,
                                                      splits, per, st)
                        : launch_gemm_x<PACKED, false>(m_tile, tile_n, x, w, scales, dst, M, K, N,
                                                       splits, per, st);
  if (err != 0 || splits == 1) return err;
  const int total = M * N;   // the splits' [M, N] planes, summed in split order
  splitk_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                         static_cast<float*>(out), splits, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tts
