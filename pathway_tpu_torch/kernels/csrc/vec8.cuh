// Shared by the row kernels K4 (bias_act.cu), K5 (add_layer_norm.cu),
// K6 (embed_ln.cu) and K7 (pool_normalize.cu): vectors of 8 activation
// values as floats, and rounding to the activation type T (bf16, or f32
// for the f32 configs, where rounding is the identity).  A vector is one
// 16-byte access in bf16 and two in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pw {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return raw;
}

// Rounding to the activation type T: bf16 rounds, f32 keeps the value.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) { return round_bf16(x); }
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

// 8 consecutive values of T at p (16-byte aligned) as floats, and back.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack8(f);
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void load_f32x8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

}  // namespace pw
