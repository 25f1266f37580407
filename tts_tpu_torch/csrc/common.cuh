// Helpers shared by the port's kernels: vector unpacking of int8 weights and
// f16 scales into f32 registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tts {

// 16 signed bytes (one 16-byte load) -> 16 floats.  An arithmetic right
// shift of the byte moved to the top of the word sign-extends it.
__device__ __forceinline__ void unpack_i8x16(const int4 v, float f[16]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)((int)((unsigned)w[i] << (24 - 8 * j)) >> 24);
  }
}

// 16 packed int4 bytes (one 16-byte load) -> the 16 signed low nibbles and
// the 16 signed high nibbles.  Shifting a nibble to the top of the word and
// back with an arithmetic shift sign-extends it.
__device__ __forceinline__ void unpack_i4x16(const int4 v, float lo[16], float hi[16]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[4 * i + j] = (float)((int)((unsigned)w[i] << (28 - 8 * j)) >> 28);
      hi[4 * i + j] = (float)((int)((unsigned)w[i] << (24 - 8 * j)) >> 28);
    }
  }
}

// 4 signed bytes (one 32-bit word) -> 4 floats.
__device__ __forceinline__ void unpack_i8x4(const int w, float f[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = (float)((int)((unsigned)w << (24 - 8 * j)) >> 24);
}

// 8 halves (one 16-byte load) -> 8 floats.
__device__ __forceinline__ void unpack_f16x8(const uint4 v, float f[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
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

// round-to-nearest-even to bf16, returned as the f32 it represents
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace tts
