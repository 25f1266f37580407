// Single-token GQA decode attention (flash-decoding) on Hopper.
//
// Replaces tts_tpu/ops/attention.py::_decode_attn_dyn_kernel.  q [Hq, 128]
// f32 against a head-major cache [Hkv, S, 128] (bf16, or int8 with f32
// per-(head, position) scales [Hkv, S]), attending to positions <= pos; out
// [Hq, 128] f32.  pos is read from device memory, so the launch does not
// depend on it (a CUDA graph can capture the step and replay it as pos
// advances).
//
// Bound: device-memory bytes (the live part of K and V is read once).  At
// Orpheus' 8 KV heads and a few hundred live positions that is well under a
// microsecond, so what costs is latency: launches, dependent round trips,
// and too few CTAs.  The TPU kernel walks one head's chunks in order with an
// online softmax; here the grid is Hkv x (S / CHUNK) with a small CHUNK, so a
// live prefix of 512 already spreads over 64 CTAs:
//   - a CTA whose chunk starts past pos exits first thing; the others copy
//     only their live K and V rows (and the int8 scales with them, 16 bytes
//     at a time) into shared memory with cp.async, K and V in flight
//     together, and loop over live slots only;
//   - one launch per call: each CTA writes its chunk's softmax partials (max
//     m, sum l, unnormalized acc [G, 128]) and bumps its head's arrival
//     counter; the last CTA of a head combines the head's partials in an
//     order fixed by pos alone (deterministic), with its loads batched so
//     that only a few round trips to L2 are serial, and sets the counter back
//     to zero, so the next call, or the next replay of a graph, finds it at
//     zero.  A head with a single live chunk skips the partials and writes
//     out directly.
//
// Rounding follows the TPU kernel: q, k, p and v enter the dots as bf16 and
// the dots accumulate in f32; l sums the unrounded p; the int8 scales
// multiply the logits (k_scale) and p before the V dot (v_scale).  The only
// difference: p is taken against its chunk's own max, not the running max,
// so bf16(p) rounds differently past the first chunk (at most 2^-9 relative,
// whatever the chunk size).
#include "common.cuh"

namespace {

// TTS_FD_* values come from ops/_ext.py GEOMETRY, which the wrapper reads too
constexpr int HS = 128;              // head size
constexpr int CHUNK = TTS_FD_CHUNK;  // positions per CTA
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = TTS_FD_MAX_G;   // query heads per KV head (Orpheus: 3)
constexpr float MASKED = -1e30f;
static_assert(CHUNK == 64, "the softmax gives each lane two slots of a chunk");
static_assert(MAXG <= WARPS, "the softmax gives each query head a warp");
static_assert(2 * (TTS_FD_MAX_S / CHUNK) * MAXG * sizeof(float) <= CHUNK * 2 * HS,
              "the combine keeps every chunk's m and l of a head in the V rows' "
              "shared memory");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 elements of a shared-memory cache row from element `d` -> floats
template <bool INT8>
__device__ __forceinline__ void row8(const unsigned char* row, int d, float f[8]) {
  if constexpr (INT8) {
    const int2 v = *reinterpret_cast<const int2*>(row + d);
    tts::unpack_i8x4(v.x, f);
    tts::unpack_i8x4(v.y, f + 4);
  } else {
    tts::unpack_bf16x8(*reinterpret_cast<const uint4*>(row + 2 * d), f);
  }
}

template <bool INT8>
__device__ __forceinline__ void row4(const unsigned char* row, int d, float f[4]) {
  if constexpr (INT8) {
    tts::unpack_i8x4(*reinterpret_cast<const int*>(row + d), f);
  } else {
    tts::unpack_bf16x4(*reinterpret_cast<const uint2*>(row + 2 * d), f);
  }
}

// grid (Hkv, S / CHUNK), THREADS threads.  counters [Hkv] int32, zero between
// calls, used by one stream at a time; partials [Hkv, S / CHUNK, G(, HS)];
// S <= TTS_FD_MAX_S.  Held to 64
// registers, 4 CTAs per SM, so the 448 CTAs of a 3584-position cache run in
// one wave.
template <bool INT8>
__global__ void __launch_bounds__(THREADS, 4)
flash_decode_kernel(const float* __restrict__ q, const void* __restrict__ kc,
                    const void* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos_ptr,
                    int* __restrict__ counters, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    float* __restrict__ out, int G, int S, float scale) {
  constexpr int ROWB = INT8 ? HS : 2 * HS;   // bytes per cache row
  constexpr int CPR = ROWB / 16;             // 16-byte copies per row
  const int h = blockIdx.x, c = blockIdx.y, nchunks = gridDim.y;
  const int pos = *pos_ptr;
  const int s0 = c * CHUNK;
  if (s0 > pos) return;                       // nothing live in this chunk

  __shared__ __align__(16) unsigned char kv[2][CHUNK * 2 * HS];  // K rows, V rows
  __shared__ __align__(16) float sc[2][CHUNK];                   // int8: k, v scales
  __shared__ float qs[MAXG][HS];
  __shared__ float pl[MAXG][CHUNK];            // logits, then bf16(p * v_scale)
  __shared__ float stat[2][MAXG];              // this chunk's m, l; the combine's L
  __shared__ int last;
  // the cross-warp sums reuse the K rows once the logits are done
  float(*accs)[MAXG][HS] = reinterpret_cast<float(*)[MAXG][HS]>(kv[0]);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(CHUNK, pos + 1 - s0);            // positions <= pos here
  const int nc = min(pos / CHUNK + 1, nchunks);         // live chunks of the head
  const size_t row0 = (size_t)h * S + s0;               // cache row of the chunk's start

  // copies: the K rows and both scale rows (the softmax takes the v scales)
  // as one group, the V rows as a second
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned char* src = static_cast<const unsigned char*>(p ? vc : kc) + row0 * ROWB;
    for (int i = tid; i < live * CPR; i += THREADS)
      tts::cp_async16(kv[p] + i * 16, src + (size_t)i * 16, true);
    if (INT8 && p == 0 && tid < 2 * ((live + 3) / 4)) {   // 4 scales per copy (S % 4 == 0)
      const int j = tid % ((live + 3) / 4), k = tid / ((live + 3) / 4);
      tts::cp_async16(&sc[k][j * 4], (k ? vs : ks) + row0 + j * 4, true);
    }
    tts::cp_async_commit();
  }
  for (int i = tid; i < G * HS; i += THREADS)
    qs[i / HS][i % HS] = tts::round_bf16(q[(size_t)(h * G) * HS + i]);
  tts::cp_async_wait<1>();                     // this thread's K copies
  __syncthreads();

  // logits: a half-warp per live position, 8 dims per lane (the loop bound is
  // the warp's, so both halves reach every shuffle)
  {
    const int sub = lane & 15;
    float qr[MAXG][8];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[g][i] = g < G ? qs[g][sub * 8 + i] : 0.f;
    for (int s2 = warp * 2; s2 < live; s2 += 2 * WARPS) {
      const int s = s2 + (lane >> 4);
      float kf[8];
      if (s < live) {
        row8<INT8>(kv[0] + s * ROWB, sub * 8, kf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;                     // G is the same for every thread
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qr[g][i], kf[i], d);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (sub == 0 && s < live) pl[g][s] = INT8 ? d * scale * sc[0][s] : d * scale;
      }
    }
  }
  __syncthreads();

  // softmax over the live slots: warp g takes query head g (CHUNK == 64: two
  // slots per lane); l sums p, pl keeps bf16(p * v_scale) for the V dot
  if (warp < G) {
    const int g = warp;
    const float a = lane < live ? pl[g][lane] : MASKED;
    const float b = lane + 32 < live ? pl[g][lane + 32] : MASKED;
    const float m = warp_max(fmaxf(a, b));
    const float pa = lane < live ? expf(a - m) : 0.f;
    const float pb = lane + 32 < live ? expf(b - m) : 0.f;
    const float l = warp_sum(pa + pb);
    if (lane < live) pl[g][lane] = tts::round_bf16(INT8 ? pa * sc[1][lane] : pa);
    if (lane + 32 < live) pl[g][lane + 32] = tts::round_bf16(INT8 ? pb * sc[1][lane + 32] : pb);
    if (lane == 0) {
      stat[0][g] = m;
      stat[1][g] = l;
    }
  }
  tts::cp_async_wait<0>();                     // this thread's V copies
  __syncthreads();

  // acc[g][d] = sum_s pl[g][s] * v[s][d]: warps take live slots round robin,
  // 4 dims per lane; then the warps' sums are added in warp order
  {
    float acc[MAXG][4];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    for (int s = warp; s < live; s += WARPS) {
      float vf[4];
      row4<INT8>(kv[1] + s * ROWB, lane * 4, vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float p = g < G ? pl[g][s] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      *reinterpret_cast<float4*>(&accs[warp][g][lane * 4]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

  const size_t part = (size_t)h * nchunks + c;
  for (int i = tid; i < G * HS; i += THREADS) {
    const int g = i / HS, d = i % HS;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += accs[w][g][d];
    if (nc == 1)
      out[(size_t)(h * G) * HS + i] = a / stat[1][g];
    else
      part_acc[(part * G + g) * HS + d] = a;
  }
  if (nc == 1) return;                         // the only live chunk: done
  if (tid < G) {
    part_m[part * G + tid] = stat[0][tid];
    part_l[part * G + tid] = stat[1][tid];
  }
  __threadfence();                             // partials visible before the count
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&counters[h], 1) == nc - 1;
    if (last) counters[h] = 0;                 // every live chunk has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA of head h: out = sum_c w_c acc_c / sum_c w_c l_c, with
  // w_c = e^(m_c - M) and M the largest chunk max.  The loads of the combine
  // do not wait on each other, so few round trips to L2 are serial: warp w
  // adds chunks w, w+8, ..., two chunks' acc rows in flight at a time, and
  // its first two are in flight together with every chunk's m and l (a
  // thread per (chunk, head) pair, into shared memory); then the warps' sums
  // add in warp order.
  const size_t base = (size_t)h * nchunks * G;       // head h's (chunk, g) pairs
  float* cw = reinterpret_cast<float*>(kv[1]);        // [nc * G]: m, then w
  float* cl = cw + nchunks * G;                       // [nc * G]: l
  float4 a[2][MAXG];
  auto load_acc = [&](int c0) {                       // chunks c0, c0 + WARPS
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {                // clamped: always in bounds
        const size_t pg = base + (size_t)min(c0 + u * WARPS, nc - 1) * G + min(g, G - 1);
        a[u][g] = __ldcg(reinterpret_cast<const float4*>(&part_acc[pg * HS + lane * 4]));
      }
  };
  load_acc(warp);
  for (int i = tid; i < nc * G; i += THREADS) {
    cw[i] = __ldcg(&part_m[base + i]);
    cl[i] = __ldcg(&part_l[base + i]);
  }
  __syncthreads();
  if (warp < G) {                                     // warp g: M, w_c and L of head g
    const int g = warp;
    float M = MASKED;
    for (int cc = lane; cc < nc; cc += 32) M = fmaxf(M, cw[cc * G + g]);
    M = warp_max(M);
    float L = 0.f;
    for (int cc = lane; cc < nc; cc += 32) {
      const float w = expf(cw[cc * G + g] - M);
      cw[cc * G + g] = w;
      L = fmaf(w, cl[cc * G + g], L);
    }
    L = warp_sum(L);
    if (lane == 0) stat[1][g] = L;
  }
  __syncthreads();
  {
    float acc[MAXG][4];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    for (int c0 = warp; c0 < nc; c0 += 2 * WARPS) {
      if (c0 != warp) load_acc(c0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = c0 + u * WARPS;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          const float w = cc < nc && g < G ? cw[cc * G + g] : 0.f;
          acc[g][0] = fmaf(w, a[u][g].x, acc[g][0]);
          acc[g][1] = fmaf(w, a[u][g].y, acc[g][1]);
          acc[g][2] = fmaf(w, a[u][g].z, acc[g][2]);
          acc[g][3] = fmaf(w, a[u][g].w, acc[g][3]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      *reinterpret_cast<float4*>(&accs[warp][g][lane * 4]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  for (int i = tid; i < G * HS; i += THREADS) {
    const int g = i / HS, d = i % HS;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += accs[w][g][d];
    out[(size_t)(h * G) * HS + i] = sum / stat[1][g];
  }
}

}  // namespace

// counters: [Hkv] int32, zero (the kernel leaves them zero), owned by the
// caller's KV cache; S % CHUNK == 0, S <= TTS_FD_MAX_S; part_m/part_l:
// [Hkv, S/CHUNK, G] f32; part_acc: [Hkv, S/CHUNK, G, 128] f32
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* pos, void* counters, void* part_m,
                            void* part_l, void* part_acc, void* out, int Hq, int Hkv, int S,
                            int kv_int8, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  const dim3 grid(Hkv, S / CHUNK);
  auto kernel = kv_int8 ? flash_decode_kernel<true> : flash_decode_kernel<false>;
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pos),
      static_cast<int*>(counters), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), static_cast<float*>(out), G, S, scale);
  return static_cast<int>(cudaGetLastError());
}
