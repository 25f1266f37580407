// Single-token GQA decode attention (flash-decoding) on Hopper.
//
// Replaces tts_tpu/ops/attention.py::_decode_attn_dyn_kernel.  q [Hq, 128]
// f32 against a head-major cache [Hkv, S, 128] (bf16, or int8 with f32
// per-(head, position) scales [Hkv, S]), attending to positions <= pos; out
// [Hq, 128] f32.  pos is read from device memory, so the launch does not
// depend on it (a later CUDA graph can capture the step).
//
// Bound: device-memory bytes (the live part of K and V is read once), and at
// Orpheus' 8 KV heads, the number of SMs kept busy.  The TPU kernel walks
// the chunks of one head in order with an online softmax; on the H100 the
// grid is Hkv x (S / 512): each CTA takes one whole 512-position chunk of one
// head, exits at once if the chunk starts past pos, and never reads a cache
// row past pos (the cache is reused across requests).  It writes its chunk's
// softmax partials (max m, sum l, unnormalized acc [G, 128]), and a combine
// pass rescales and adds the live chunks.
//
// Rounding follows the TPU kernel: q, k, p and v enter the dots as bf16 and
// the dots accumulate in f32; l sums the unrounded p; the int8 scales
// multiply the logits (k_scale) and p before the V dot (v_scale).  The only
// difference: p is taken against its chunk's own max, not the running max,
// so bf16(p) rounds differently past the first chunk (at most 2^-9 relative).
#include "common.cuh"

namespace {

constexpr int HS = 128;           // head size
constexpr int CHUNK = 512;        // positions per CTA (the TPU kernel's S_CHUNK)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 4;           // query heads per KV head (Orpheus: 3)
constexpr float MASKED = -1e30f;

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

// 8 elements of a cache row starting at element `d` -> floats
template <bool INT8>
__device__ __forceinline__ void load8(const void* base, size_t elem, float f[8]) {
  if constexpr (INT8) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(static_cast<const int8_t*>(base) + elem));
    tts::unpack_i8x4(v.x, f);
    tts::unpack_i8x4(v.y, f + 4);
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + elem));
    tts::unpack_bf16x8(v, f);
  }
}

template <bool INT8>
__device__ __forceinline__ void load4(const void* base, size_t elem, float f[4]) {
  if constexpr (INT8) {
    tts::unpack_i8x4(__ldg(reinterpret_cast<const int*>(static_cast<const int8_t*>(base) + elem)), f);
  } else {
    tts::unpack_bf16x4(__ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + elem)), f);
  }
}

// grid (Hkv, S / CHUNK); partials [Hkv, S / CHUNK, G(, HS)]
template <bool INT8>
__global__ void __launch_bounds__(THREADS)
flash_decode_chunk_kernel(const float* __restrict__ q, const void* __restrict__ kc,
                          const void* __restrict__ vc, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ pos_ptr,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int G, int S, float scale) {
  const int h = blockIdx.x, c = blockIdx.y, nchunks = gridDim.y;
  const int pos = *pos_ptr;
  if (c * CHUNK > pos) return;  // chunk entirely past pos: nothing to read

  __shared__ float qs[MAXG][HS];
  __shared__ float pl[MAXG][CHUNK];  // logits, then bf16(p * v_scale)
  __shared__ float red[WARPS][MAXG];
  __shared__ float accs[WARPS][MAXG][HS];
  __shared__ float stat[MAXG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = c * CHUNK;
  const int live = min(CHUNK, pos + 1 - s0);  // positions <= pos in this chunk
  const size_t row0 = (size_t)h * S + s0;     // cache row of the chunk's start

  for (int i = tid; i < G * HS; i += THREADS)
    qs[i / HS][i % HS] = tts::round_bf16(q[(size_t)(h * G) * HS + i]);
  __syncthreads();

  // logits: a half-warp per position, 8 dims per lane; each half-warp loads
  // KU rows (positions 16 apart) before using them, so KU loads are in flight
  {
    constexpr int HALVES = WARPS * 2, KU = 4;
    const int sub = lane & 15, half = lane >> 4;
    float qr[MAXG][8];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[g][i] = g < G ? qs[g][sub * 8 + i] : 0.f;
    for (int s0 = warp * 2 + half; s0 < CHUNK; s0 += HALVES * KU) {
      float kf[KU][8];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (s0 + u * HALVES < live) {
          load8<INT8>(kc, (row0 + s0 + u * HALVES) * HS + sub * 8, kf[u]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kf[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int s = s0 + u * HALVES;
        const bool valid = s < live;
        float dot[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) d = fmaf(qr[g][i], kf[u][i], d);
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          dot[g] = d;
        }
        if (sub == 0) {
          const float kscale = (INT8 && valid) ? ks[row0 + s] : 1.f;
          for (int g = 0; g < G; ++g) {
            float lg = dot[g] * scale;
            if (INT8) lg *= kscale;
            pl[g][s] = valid ? lg : MASKED;
          }
        }
      }
    }
  }
  __syncthreads();

  // chunk max per query head
  float mx[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    float v = MASKED;
    if (g < G)
      for (int s = tid; s < CHUNK; s += THREADS) v = fmaxf(v, pl[g][s]);
    v = warp_max(v);
    if (lane == 0) red[warp][g] = v;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    float v = red[0][g];
    for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w][g]);
    mx[g] = v;
  }
  __syncthreads();  // everyone has read red before it is reused

  // p = exp(logit - max); l sums p; pl keeps bf16(p * v_scale) for the V dot
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    float sum = 0.f;
    if (g < G) {
      for (int s = tid; s < CHUNK; s += THREADS) {
        const float p = expf(pl[g][s] - mx[g]);
        sum += p;
        const float pv = (INT8 && s < live) ? p * vs[row0 + s] : p;
        pl[g][s] = tts::round_bf16(s < live ? pv : 0.f);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) red[warp][g] = sum;
  }
  __syncthreads();

  // acc[g][d] = sum_s pl[g][s] * v[s][d]: warps take live positions round
  // robin (all 8 busy however short the chunk), 4 dims per lane (one 8-byte
  // bf16 or 4-byte int8 load), unrolled so several row loads are in flight
  {
    float acc[MAXG][4];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
#pragma unroll 4
    for (int s = warp; s < live; s += WARPS) {
      float vf[4];
      load4<INT8>(vc, (row0 + s) * HS + lane * 4, vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float p = g < G ? pl[g][s] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) accs[warp][g][lane * 4 + i] = acc[g][i];
  }
  if (tid < G) {
    float l = 0.f;
    for (int w = 0; w < WARPS; ++w) l += red[w][tid];
    stat[tid] = l;
  }
  __syncthreads();

  const size_t part = (size_t)h * nchunks + c;
  for (int i = tid; i < G * HS; i += THREADS) {
    const int g = i / HS, d = i % HS;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += accs[w][g][d];
    part_acc[(part * G + g) * HS + d] = a;
  }
  if (tid < G) {
    part_m[part * G + tid] = mx[tid];
    part_l[part * G + tid] = stat[tid];
  }
}

// grid Hq, block HS: out[hq] = sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_m,
                                            const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc,
                                            const int* __restrict__ pos_ptr,
                                            float* __restrict__ out, int G, int nchunks) {
  const int hq = blockIdx.x, d = threadIdx.x;
  const int h = hq / G, g = hq % G;
  const int nc = min(*pos_ptr / CHUNK + 1, nchunks);
  float M = MASKED;
  for (int c = 0; c < nc; ++c) M = fmaxf(M, part_m[((size_t)h * nchunks + c) * G + g]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t part = (size_t)h * nchunks + c;
    const float w = expf(part_m[part * G + g] - M);
    L += w * part_l[part * G + g];
    A += w * part_acc[(part * G + g) * HS + d];
  }
  out[(size_t)hq * HS + d] = A / L;
}

}  // namespace

// part_m/part_l: [Hkv, S/512, G] f32; part_acc: [Hkv, S/512, G, 128] f32
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                            const void* v_scale, const void* pos, void* part_m, void* part_l,
                            void* part_acc, void* out, int Hq, int Hkv, int S, int kv_int8,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  const dim3 grid(Hkv, S / CHUNK);
  const float* qp = static_cast<const float*>(q);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* pp = static_cast<const int*>(pos);
  float* pm = static_cast<float*>(part_m);
  float* plp = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (kv_int8) {
    flash_decode_chunk_kernel<true><<<grid, THREADS, 0, st>>>(qp, k, v, ksp, vsp, pp, pm, plp, pa,
                                                              G, S, scale);
  } else {
    flash_decode_chunk_kernel<false><<<grid, THREADS, 0, st>>>(qp, k, v, ksp, vsp, pp, pm, plp,
                                                               pa, G, S, scale);
  }
  flash_decode_combine_kernel<<<Hq, HS, 0, st>>>(pm, plp, pa, pp, static_cast<float*>(out), G,
                                                 S / CHUNK);
  return static_cast<int>(cudaGetLastError());
}
