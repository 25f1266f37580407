// The decode step's single-token self-attention over the live prefix of a
// KV cache, on Hopper: Parler-TTS's (16 heads of 64, position-major cache)
// and Dia's (GQA, 4 query heads per KV head of 128, head-major cache).
//
// Replaces no TPU kernel: both models' step attention is plain jnp in the
// JAX package (tts_tpu/models/parler.py::_transformer,
// tts_tpu/models/dia.py::_dia_step), which reads every cache slot under an
// additive -1e9 mask so the compiled step has one shape.  The port did the
// same with torch products on the card, which widened the whole cache to f32
// (two copies a layer), took cuBLAS products over all S slots and a softmax
// over them: about 1.1 ms of a 3.1-3.4-ms Parler row at S = 4,096, about
// 1.5 ms of a 4.8-ms Dia step at S = 3,072.  This kernel computes the same
// function in one launch a layer.
//
// A launch covers NKV KV heads; KV head h serves the G query heads h * G ..
// h * G + G - 1 (q and out [NKV * G, HS] f32, the flattened query heads) and
// attends to positions <= pos of its cache rows.  Row s of KV head h starts
// (h * head_stride + s * pos_stride) rows into the layer: Parler's [S, H, 64]
// has strides (1, H), Dia's [2, Hkv, S, 128] (cond and uncond, NKV = 2 Hkv)
// (S, 1).  pos is read from device memory, so the launch does not depend on
// it (the one captured decode step replays at every position).  Compile-time
// instances: HS 64 with G 1 (Parler), HS 128 with G 4 (Dia-1.6B) and with G
// 2 (the tests' tiny Dia), each for a bf16 cache and a dense checkpoint's f32
// one.
//
// Bound: device-memory bytes, 4 KB of live K and V a position at 16 heads of
// 64 or 8 KV heads of 128 (bf16), read once: 0.08 us at pos 63, 5 us at pos
// 4,095.  What costs at these sizes is latency, so the grid is NKV x (S /
// CHUNK) with a small chunk:
//   - a CTA whose chunk starts past pos exits first thing; the others copy
//     only their live K and V rows (HS elements a row) into shared memory
//     with cp.async, K and V in flight together, and loop over live slots
//     only, so nothing past pos is read.  A KV head's rows are read once for
//     all G of its query heads;
//   - one launch per call: each CTA writes its chunk's softmax partials (max
//     m, sum l, unnormalized acc [HS], per query head) and bumps its KV
//     head's arrival counter; the last CTA of a KV head combines the head's
//     partials in an order fixed by pos alone (deterministic) and sets the
//     counter back to zero, so the next launch, or the next replay of a
//     graph, finds it at zero.  A head with a single live chunk skips the
//     partials and writes out directly.
//
// Arithmetic: f32 throughout, as the masked product it replaces: q is not
// rounded, K and V are widened in registers, the logits are multiplied by the
// caller's scale (Parler 1/sqrt(64), a power of two, exact; Dia 1.0), p is
// not rounded, and the sums accumulate in f32.  Only the order of summation
// differs (per chunk, then across chunks rescaled by e^(m_c - M)).  At G 1
// and HS 64 every step below is the one Parler's kernel took before Dia's
// instances were added, so its bits are unchanged; at G > 1 the combine adds
// the chunks in another order (one thread over every chunk) to read G times
// the partials faster.
#include "common.cuh"

namespace {

// TTS_PA_* values come from ops/_ext.py GEOMETRY, which the wrapper reads too
constexpr int CHUNK = TTS_PA_CHUNK;  // positions per CTA
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;
static_assert(CHUNK == 64, "the softmax gives each lane two slots of a chunk");

// DPL elements of a shared-memory row from element `d` -> floats
template <typename T, int DPL>
__device__ __forceinline__ void row_n(const unsigned char* row, int d, float f[DPL]) {
  static_assert(DPL == 2 || DPL == 4 || DPL == 8, "2, 4 or 8 elements");
  if constexpr (sizeof(T) == 2 && DPL == 8) {
    tts::unpack_bf16x8(*reinterpret_cast<const uint4*>(row + 2 * d), f);
  } else if constexpr (sizeof(T) == 2 && DPL == 4) {
    tts::unpack_bf16x4(*reinterpret_cast<const uint2*>(row + 2 * d), f);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + 2 * d);
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < DPL; i += 2) {
      const float2 a = *reinterpret_cast<const float2*>(row + 4 * (d + i));
      f[i] = a.x, f[i + 1] = a.y;
    }
  }
}

// DPL consecutive floats of global memory (written by this launch: read
// past L1) -> registers
template <int DPL>
__device__ __forceinline__ void load_cg(const float* p, float f[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p + i));
      f[i] = a.x, f[i + 1] = a.y, f[i + 2] = a.z, f[i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; i += 2) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(p + i));
      f[i] = a.x, f[i + 1] = a.y;
    }
  }
}

// shared memory a CTA needs beyond its static arrays: the live chunk's K and
// V rows
template <typename T, int HS>
constexpr int kv_bytes() {
  return 2 * CHUNK * HS * static_cast<int>(sizeof(T));
}

// grid (NKV, S / CHUNK), THREADS threads, kv_bytes<T, HS>() bytes of dynamic
// shared memory.  T: the cache's element (2 bytes: bf16, 4: f32).  q, out
// [NKV * G, HS]; counters [NKV] int32, zero between calls, used by one stream
// at a time; part_m, part_l [NKV, S / CHUNK, G](, HS for part_acc);
// S <= TTS_PA_MAX_S.
template <typename T, int HS, int G>
__global__ void __launch_bounds__(THREADS)
prefix_attention_kernel(const float* __restrict__ q, const void* __restrict__ kc,
                        const void* __restrict__ vc, const int* __restrict__ pos_ptr,
                        int* __restrict__ counters, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc,
                        float* __restrict__ out, long long head_stride, long long pos_stride,
                        float scale) {
  constexpr int ROWB = HS * sizeof(T);       // bytes of one head's row
  constexpr int CPR = ROWB / 16;             // 16-byte copies per row
  constexpr int LPP = HS / 8;                // lanes per position (8 dims a lane) for the logits
  constexpr int PPW = 32 / LPP;              // positions a warp takes at a time
  constexpr int DPL = HS / 32;               // dims per lane for the sums over V
  static_assert(G <= WARPS, "the softmax and the combine give each query head a warp");
  static_assert(WARPS * G * HS * sizeof(float) <= CHUNK * ROWB,
                "the cross-warp sums reuse the K rows' shared memory");
  static_assert(2 * (TTS_PA_MAX_S / CHUNK) * G * sizeof(float) <= CHUNK * ROWB,
                "the combine keeps every chunk's m and l of a KV head in the V rows' "
                "shared memory");
  const int h = blockIdx.x, c = blockIdx.y, nchunks = gridDim.y;
  const int pos = *pos_ptr;
  const int s0 = c * CHUNK;
  if (s0 > pos) return;                       // nothing live in this chunk

  extern __shared__ __align__(16) unsigned char kv_smem[];    // K rows, then V rows
  unsigned char* const kv[2] = {kv_smem, kv_smem + CHUNK * ROWB};
  __shared__ float qs[G * HS];
  __shared__ float pl[G][CHUNK];               // logits, then p
  __shared__ float stat_m[G], stat_l[G];       // this chunk's m, l; the combine's L
  __shared__ int last;
  // the cross-warp sums reuse the K rows once the logits are done
  float(*accs)[G * HS] = reinterpret_cast<float(*)[G * HS]>(kv[0]);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(CHUNK, pos + 1 - s0);            // positions <= pos here
  const int nc = min(pos / CHUNK + 1, nchunks);         // live chunks of the head
  const size_t stride = (size_t)pos_stride * ROWB;      // bytes from one position to the next

  // copies: the K rows as one group, the V rows as a second
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned char* src = static_cast<const unsigned char*>(p ? vc : kc) +
                               ((size_t)h * head_stride + (size_t)s0 * pos_stride) * ROWB;
    for (int i = tid; i < live * CPR; i += THREADS) {
      const int s = i / CPR, j = i % CPR;
      tts::cp_async16(kv[p] + s * ROWB + j * 16, src + s * stride + j * 16, true);
    }
    tts::cp_async_commit();
  }
  for (int i = tid; i < G * HS; i += THREADS) qs[i] = q[(size_t)h * G * HS + i];
  tts::cp_async_wait<1>();                     // this thread's K copies
  __syncthreads();

  // logits: LPP lanes per live position, 8 dims per lane, PPW positions a
  // warp at a time, every query head of the KV head from one read of the row
  // (the loop bound is the warp's, so every lane reaches every shuffle)
  {
    const int sub = lane % LPP;
    float qr[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[g][i] = qs[g * HS + sub * 8 + i];
    for (int sp = warp * PPW; sp < live; sp += PPW * WARPS) {
      const int s = sp + lane / LPP;
      float kf[8];
      if (s < live) {
        row_n<T, 8>(kv[0] + s * ROWB, sub * 8, kf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qr[g][i], kf[i], d);
#pragma unroll
        for (int o = LPP / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (sub == 0 && s < live) pl[g][s] = d * scale;
      }
    }
  }
  __syncthreads();

  // softmax over the live slots, query head g in warp g (CHUNK == 64: two
  // slots per lane)
  if (warp < G) {
    float* const pg = pl[warp];
    const float a = lane < live ? pg[lane] : MASKED;
    const float b = lane + 32 < live ? pg[lane + 32] : MASKED;
    const float m = tts::warp_max(fmaxf(a, b));
    const float pa = lane < live ? expf(a - m) : 0.f;
    const float pb = lane + 32 < live ? expf(b - m) : 0.f;
    const float l = tts::warp_sum(pa + pb);
    if (lane < live) pg[lane] = pa;
    if (lane + 32 < live) pg[lane + 32] = pb;
    if (lane == 0) {
      stat_m[warp] = m;
      stat_l[warp] = l;
    }
  }
  tts::cp_async_wait<0>();                     // this thread's V copies
  __syncthreads();

  // acc[g][d] = sum_s p[g][s] * v[s][d]: warps take live slots round robin,
  // DPL dims per lane; then the warps' sums are added in warp order
  {
    float a[G][DPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[g][i] = 0.f;
    for (int s = warp; s < live; s += WARPS) {
      float vf[DPL];
      row_n<T, DPL>(kv[1] + s * ROWB, DPL * lane, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = pl[g][s];
#pragma unroll
        for (int i = 0; i < DPL; ++i) a[g][i] = fmaf(p, vf[i], a[g][i]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < DPL; ++i) accs[warp][g * HS + DPL * lane + i] = a[g][i];
  }
  __syncthreads();

  const size_t part = (size_t)h * nchunks + c;
  for (int i = tid; i < G * HS; i += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += accs[w][i];
    if (nc == 1)
      out[(size_t)h * G * HS + i] = a / stat_l[i / HS];
    else
      part_acc[part * G * HS + i] = a;
  }
  if (nc == 1) return;                         // the only live chunk: done
  if (tid < G) {
    part_m[part * G + tid] = stat_m[tid];
    part_l[part * G + tid] = stat_l[tid];
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

  // the last CTA of KV head h: for each query head g, out = sum_c w_c acc_c
  // / sum_c w_c l_c, with w_c = e^(m_c - M) and M the largest chunk max
  const size_t base = (size_t)h * nchunks;            // head h's chunks
  float* cw = reinterpret_cast<float*>(kv[1]);        // [G][nchunks]: m, then w
  float* cl = cw + G * nchunks;                       // [G][nchunks]: l
  for (int i = tid; i < nc * G; i += THREADS) {
    const int cc = i / G, g = i % G;
    cw[g * nchunks + cc] = __ldcg(&part_m[(base + cc) * G + g]);
    cl[g * nchunks + cc] = __ldcg(&part_l[(base + cc) * G + g]);
  }
  __syncthreads();
  if (warp < G) {
    float* const wg = cw + warp * nchunks;
    const float* const lg = cl + warp * nchunks;
    float M = MASKED;
    for (int cc = lane; cc < nc; cc += 32) M = fmaxf(M, wg[cc]);
    M = tts::warp_max(M);
    float L = 0.f;
    for (int cc = lane; cc < nc; cc += 32) {
      const float w = expf(wg[cc] - M);
      wg[cc] = w;
      L = fmaf(w, lg[cc], L);
    }
    L = tts::warp_sum(L);
    if (lane == 0) stat_l[warp] = L;
  }
  __syncthreads();
  if constexpr (G > 1) {
    // G query heads' partials are G times the bytes one CTA reads here, so
    // each thread owns OPT outputs of one query head and adds every chunk in
    // chunk order with 8 chunks' loads in flight (Parler's order below, a
    // warp per chunk subset, is latency-bound at G 4: on an H100, 22 against
    // 16 us at 48 chunks)
    constexpr int OPT = G * HS / THREADS;
    const int o = OPT * tid;
    const float* const wg = cw + (o / HS) * nchunks;
    float a[OPT];
#pragma unroll
    for (int i = 0; i < OPT; ++i) a[i] = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < nc; ++cc) {
      float x[OPT];
      load_cg<OPT>(&part_acc[(base + cc) * G * HS + o], x);
      const float w = wg[cc];
#pragma unroll
      for (int i = 0; i < OPT; ++i) a[i] = fmaf(w, x[i], a[i]);
    }
#pragma unroll
    for (int i = 0; i < OPT; ++i) out[(size_t)h * G * HS + o + i] = a[i] / stat_l[o / HS];
  } else {
    // warp w adds chunks w, w + 4, ..., then the warps' sums add in warp
    // order (Parler's order since its kernel was written)
    float a[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) a[i] = 0.f;
#pragma unroll 4
    for (int cc = warp; cc < nc; cc += WARPS) {
      float x[DPL];
      load_cg<DPL>(&part_acc[(base + cc) * HS + DPL * lane], x);
      const float w = cw[cc];
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] = fmaf(w, x[i], a[i]);
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) accs[warp][DPL * lane + i] = a[i];
    __syncthreads();
    for (int i = tid; i < HS; i += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += accs[w][i];
      out[(size_t)h * HS + i] = sum / stat_l[0];
    }
  }
}

template <typename T, int HS, int G>
int launch(const void* q, const void* k, const void* v, const void* pos, void* counters,
           void* part_m, void* part_l, void* part_acc, void* out, int nkv, int S,
           long long head_stride, long long pos_stride, float scale, cudaStream_t st) {
  constexpr int smem = kv_bytes<T, HS>();
  auto kernel = prefix_attention_kernel<T, HS, G>;
  if constexpr (smem > 48 * 1024) {           // past the default: asked for once
    static const cudaError_t set =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  kernel<<<dim3(nkv, S / CHUNK), THREADS, smem, st>>>(
      static_cast<const float*>(q), k, v, static_cast<const int*>(pos),
      static_cast<int*>(counters), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), static_cast<float*>(out), head_stride, pos_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [nkv * group, head_size] f32; k, v: one layer of the cache, bf16
// (elem_bytes 2) or f32 (4), position-major [S, nkv, head_size] or head-major
// [nkv, S, head_size] (head_major 1); pos int32 [1] on the device; counters
// [nkv] int32, zero (the kernel leaves them zero), owned by the caller's KV
// cache; S % CHUNK == 0, S <= TTS_PA_MAX_S; part_m/part_l [nkv, S / CHUNK,
// group] f32; part_acc [nkv, S / CHUNK, group, head_size] f32; out [nkv *
// group, head_size] f32.  (head_size, group) is (64, 1), (128, 4) or (128,
// 2); anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int prefix_attention(const void* q, const void* k, const void* v, const void* pos,
                                void* counters, void* part_m, void* part_l, void* part_acc,
                                void* out, int nkv, int S, int head_size, int group,
                                int head_major, int elem_bytes, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long head_stride = head_major ? S : 1, pos_stride = head_major ? 1 : nkv;
#define TTS_PA_LAUNCH(T, HS, G)                                                          \
  launch<T, HS, G>(q, k, v, pos, counters, part_m, part_l, part_acc, out, nkv, S,      \
                   head_stride, pos_stride, scale, st)
  const bool bf16 = elem_bytes == 2;
  if (head_size == 64 && group == 1)
    return bf16 ? TTS_PA_LAUNCH(__nv_bfloat16, 64, 1) : TTS_PA_LAUNCH(float, 64, 1);
  if (head_size == 128 && group == 4)
    return bf16 ? TTS_PA_LAUNCH(__nv_bfloat16, 128, 4) : TTS_PA_LAUNCH(float, 128, 4);
  if (head_size == 128 && group == 2)
    return bf16 ? TTS_PA_LAUNCH(__nv_bfloat16, 128, 2) : TTS_PA_LAUNCH(float, 128, 2);
#undef TTS_PA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
