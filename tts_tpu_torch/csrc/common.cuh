// Helpers shared by the port's kernels: vector unpacking of int8 and bf16
// values into f32 registers, warp reductions, asynchronous copies,
// tensor-core products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tts {

// 4 signed bytes (one 32-bit word) -> 4 floats.
__device__ __forceinline__ void unpack_i8x4(const int w, float f[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = (float)((int)((unsigned)w << (24 - 8 * j)) >> 24);
}

// 8 bf16 (one 16-byte load) -> 8 floats.
__device__ __forceinline__ void unpack_bf16x8(const uint4 v, float f[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 bf16 (one 8-byte load) -> 4 floats.
__device__ __forceinline__ void unpack_bf16x4(const uint2 v, float f[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// the max and the sum of v over the 32 lanes of a warp, in every lane
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

// round-to-nearest-even to bf16, returned as the f32 it represents
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- asynchronous copies (cp.async, sm_80+) --------------------------------
// 16 bytes global -> shared without a register round trip; when !valid the
// destination is zero-filled and nothing is read (src must still be a valid
// address).  16-byte aligned on both sides.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- tensor cores (mma.sync, sm_80+) ---------------------------------------
// c[16x8] += a[16x16] @ b[16x8], bf16 in, f32 accumulate.  Fragments (g =
// lane / 4, t = lane % 4): a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)} as bf16 pairs, lower index in the low half; b = {(k 2t..2t+1,
// n g), (k 2t+8..2t+9, n g)}; c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> a bf16 pair (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace tts
