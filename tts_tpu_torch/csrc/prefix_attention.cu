// Parler-TTS's single-token self-attention over the live prefix of its
// position-major KV cache, on Hopper.
//
// Replaces no TPU kernel: Parler's attention is plain jnp in the JAX package
// (tts_tpu/models/parler.py::_transformer), which reads every cache slot
// under an additive -1e9 mask so the compiled step has one shape.  The port
// did the same with torch products on the card, which widened the whole
// bf16 cache to f32 (two copies a layer), took cuBLAS GEMVs over all S
// slots and a softmax over them: about 1.1 ms of a 3.1-3.4-ms decode row at
// S = 4,096.  This kernel computes the same function in one launch a layer.
//
// q [H, 64] f32 against layer l of the cache, [S, H, 64] bf16 (or f32, a
// dense checkpoint's), attending to positions <= pos; out [H, 64] f32.  pos
// is read from device memory, so the launch does not depend on it (the one
// captured decode step replays at every position).
//
// Bound: device-memory bytes, 4 KB of live K and V a position at H = 16
// (bf16), read once: 0.08 us at pos 63, 5 us at pos 4,095.  What costs at
// these sizes is latency, so the grid is H x (S / CHUNK) with a small chunk:
//   - a CTA whose chunk starts past pos exits first thing; the others copy
//     only their live K and V rows (128 bytes a row and head) into shared
//     memory with cp.async, K and V in flight together, and loop over live
//     slots only, so nothing past pos is read;
//   - one launch per call: each CTA writes its chunk's softmax partials (max
//     m, sum l, unnormalized acc [64]) and bumps its head's arrival counter;
//     the last CTA of a head combines the head's partials in an order fixed
//     by pos alone (deterministic) and sets the counter back to zero, so the
//     next launch, or the next replay of a graph, finds it at zero.  A head
//     with a single live chunk skips the partials and writes out directly.
//
// Arithmetic: f32 throughout, as the masked product it replaces: q is not
// rounded, K and V are widened from bf16 in registers, the logits are scaled
// by 1/sqrt(64) (a power of two, exact), p is not rounded, and the sums
// accumulate in f32.  Only the order of summation differs (per chunk, then
// across chunks rescaled by e^(m_c - M)).
#include "common.cuh"

namespace {

// TTS_PA_* values come from ops/_ext.py GEOMETRY, which the wrapper reads too
constexpr int HS = 64;               // head size
constexpr int CHUNK = TTS_PA_CHUNK;  // positions per CTA
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;
static_assert(CHUNK == 64, "the softmax gives each lane two slots of a chunk");
static_assert(2 * HS == THREADS, "the last sums give each thread a dimension (two per lane)");
static_assert(2 * (TTS_PA_MAX_S / CHUNK) * sizeof(float) <= CHUNK * HS * 2,
              "the combine keeps every chunk's m and l of a head in the V rows' "
              "shared memory");

// 8 elements of a shared-memory row from element `d` -> floats
template <typename T>
__device__ __forceinline__ void row8(const unsigned char* row, int d, float f[8]) {
  if constexpr (sizeof(T) == 2) {
    tts::unpack_bf16x8(*reinterpret_cast<const uint4*>(row + 2 * d), f);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * d);
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * d + 16);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
}

// 2 elements of a shared-memory row from element `d` -> floats
template <typename T>
__device__ __forceinline__ float2 row2(const unsigned char* row, int d) {
  if constexpr (sizeof(T) == 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + 2 * d);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float2*>(row + 4 * d);
  }
}

// grid (H, S / CHUNK), THREADS threads.  T: the cache's element (2 bytes:
// bf16, 4: f32).  cache [S, H, HS]; counters [H] int32, zero between calls,
// used by one stream at a time; partials [H, S / CHUNK](, HS);
// S <= TTS_PA_MAX_S.
template <typename T>
__global__ void __launch_bounds__(THREADS)
prefix_attention_kernel(const float* __restrict__ q, const void* __restrict__ kc,
                        const void* __restrict__ vc, const int* __restrict__ pos_ptr,
                        int* __restrict__ counters, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc,
                        float* __restrict__ out, int H, float scale) {
  constexpr int ROWB = HS * sizeof(T);       // bytes of one head's row
  constexpr int CPR = ROWB / 16;             // 16-byte copies per row
  const int h = blockIdx.x, c = blockIdx.y, nchunks = gridDim.y;
  const int pos = *pos_ptr;
  const int s0 = c * CHUNK;
  if (s0 > pos) return;                       // nothing live in this chunk

  __shared__ __align__(16) unsigned char kv[2][CHUNK * ROWB];  // K rows, V rows
  __shared__ float qs[HS];
  __shared__ float pl[CHUNK];                  // logits, then p
  __shared__ float stat[2];                    // this chunk's m, l; the combine's L
  __shared__ int last;
  // the cross-warp sums reuse the K rows once the logits are done
  float(*accs)[HS] = reinterpret_cast<float(*)[HS]>(kv[0]);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(CHUNK, pos + 1 - s0);            // positions <= pos here
  const int nc = min(pos / CHUNK + 1, nchunks);         // live chunks of the head
  const size_t stride = (size_t)H * ROWB;               // bytes from one position to the next

  // copies: the K rows as one group, the V rows as a second
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned char* src =
        static_cast<const unsigned char*>(p ? vc : kc) + ((size_t)s0 * H + h) * ROWB;
    for (int i = tid; i < live * CPR; i += THREADS) {
      const int s = i / CPR, j = i % CPR;
      tts::cp_async16(kv[p] + s * ROWB + j * 16, src + s * stride + j * 16, true);
    }
    tts::cp_async_commit();
  }
  if (tid < HS) qs[tid] = q[(size_t)h * HS + tid];
  tts::cp_async_wait<1>();                     // this thread's K copies
  __syncthreads();

  // logits: 8 lanes per live position, 8 dims per lane, 4 positions a warp
  // at a time (the loop bound is the warp's, so every lane reaches every
  // shuffle)
  {
    const int sub = lane & 7;
    float qr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[i] = qs[sub * 8 + i];
    for (int s4 = warp * 4; s4 < live; s4 += 4 * WARPS) {
      const int s = s4 + (lane >> 3);
      float kf[8];
      if (s < live) {
        row8<T>(kv[0] + s * ROWB, sub * 8, kf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.f;
      }
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) d = fmaf(qr[i], kf[i], d);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (sub == 0 && s < live) pl[s] = d * scale;
    }
  }
  __syncthreads();

  // softmax over the live slots in warp 0 (CHUNK == 64: two slots per lane)
  if (warp == 0) {
    const float a = lane < live ? pl[lane] : MASKED;
    const float b = lane + 32 < live ? pl[lane + 32] : MASKED;
    const float m = tts::warp_max(fmaxf(a, b));
    const float pa = lane < live ? expf(a - m) : 0.f;
    const float pb = lane + 32 < live ? expf(b - m) : 0.f;
    const float l = tts::warp_sum(pa + pb);
    if (lane < live) pl[lane] = pa;
    if (lane + 32 < live) pl[lane + 32] = pb;
    if (lane == 0) {
      stat[0] = m;
      stat[1] = l;
    }
  }
  tts::cp_async_wait<0>();                     // this thread's V copies
  __syncthreads();

  // acc[d] = sum_s p[s] * v[s][d]: warps take live slots round robin, 2
  // dims per lane; then the warps' sums are added in warp order
  {
    float a0 = 0.f, a1 = 0.f;
    for (int s = warp; s < live; s += WARPS) {
      const float2 vf = row2<T>(kv[1] + s * ROWB, 2 * lane);
      const float p = pl[s];
      a0 = fmaf(p, vf.x, a0);
      a1 = fmaf(p, vf.y, a1);
    }
    *reinterpret_cast<float2*>(&accs[warp][2 * lane]) = make_float2(a0, a1);
  }
  __syncthreads();

  const size_t part = (size_t)h * nchunks + c;
  if (tid < HS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += accs[w][tid];
    if (nc == 1)
      out[(size_t)h * HS + tid] = a / stat[1];
    else
      part_acc[part * HS + tid] = a;
  }
  if (nc == 1) return;                         // the only live chunk: done
  if (tid == 0) {
    part_m[part] = stat[0];
    part_l[part] = stat[1];
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
  // w_c = e^(m_c - M) and M the largest chunk max; warp w adds chunks w,
  // w + 4, ..., then the warps' sums add in warp order
  const size_t base = (size_t)h * nchunks;            // head h's chunks
  float* cw = reinterpret_cast<float*>(kv[1]);        // [nc]: m, then w
  float* cl = cw + nchunks;                           // [nc]: l
  for (int i = tid; i < nc; i += THREADS) {
    cw[i] = __ldcg(&part_m[base + i]);
    cl[i] = __ldcg(&part_l[base + i]);
  }
  __syncthreads();
  if (warp == 0) {
    float M = MASKED;
    for (int cc = lane; cc < nc; cc += 32) M = fmaxf(M, cw[cc]);
    M = tts::warp_max(M);
    float L = 0.f;
    for (int cc = lane; cc < nc; cc += 32) {
      const float w = expf(cw[cc] - M);
      cw[cc] = w;
      L = fmaf(w, cl[cc], L);
    }
    L = tts::warp_sum(L);
    if (lane == 0) stat[1] = L;
  }
  __syncthreads();
  {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int cc = warp; cc < nc; cc += WARPS) {
      const float2 a =
          __ldcg(reinterpret_cast<const float2*>(&part_acc[(base + cc) * HS + 2 * lane]));
      const float w = cw[cc];
      a0 = fmaf(w, a.x, a0);
      a1 = fmaf(w, a.y, a1);
    }
    *reinterpret_cast<float2*>(&accs[warp][2 * lane]) = make_float2(a0, a1);
  }
  __syncthreads();
  if (tid < HS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += accs[w][tid];
    out[(size_t)h * HS + tid] = sum / stat[1];
  }
}

}  // namespace

// q [H, 64] f32; k, v: one layer of the cache, [S, H, 64], bf16 (elem_bytes
// 2) or f32 (4); pos int32 [1] on the device; counters [H] int32, zero (the
// kernel leaves them zero), owned by the caller's KV cache; S % CHUNK == 0,
// S <= TTS_PA_MAX_S; part_m/part_l [H, S / CHUNK] f32; part_acc [H, S / CHUNK,
// 64] f32; out [H, 64] f32
extern "C" int prefix_attention(const void* q, const void* k, const void* v, const void* pos,
                                void* counters, void* part_m, void* part_l, void* part_acc,
                                void* out, int H, int S, int elem_bytes, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, S / CHUNK);
  auto kernel = elem_bytes == 2 ? prefix_attention_kernel<__nv_bfloat16>
                                : prefix_attention_kernel<float>;
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(q), k, v, static_cast<const int*>(pos),
      static_cast<int*>(counters), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), static_cast<float*>(out), H, scale);
  return static_cast<int>(cudaGetLastError());
}
