// Shared by K5 (add_layer_norm.cu) and K6 (embed_ln.cu): one warp
// normalises one row of H bf16 values that its lanes hold in registers,
// with flax LayerNorm(dtype=bf16)'s arithmetic after the statistics.
//
// Layout: the row is H / 8 vectors of 8 values (one 16-byte load each);
// lane l holds vectors l, l + 32, ..., so a warp-wide load of one vector
// per lane is 512 contiguous bytes.  VPT (vectors per lane) is a template
// parameter so the row stays in registers: VPT = 3 at H = 768.
//
// Statistics in f32, two-pass over the registers: mean, then the mean of
// squared deviations.  flax's default takes E[s^2] - E[s]^2 clipped at 0;
// on rows of post-residual activations (|mean| well below the standard
// deviation) the two differ by a few f32 ulps of the variance, far below
// one bf16 ulp of the output.  The plain version (F.layer_norm) is
// two-pass too.  Then, in flax's order:
//   y = (s - mean) * (rsqrt(var + eps) * scale) + bias, rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pw {

constexpr int kRowsPerBlock = 8;  // one warp per row, 256 threads
constexpr int kMaxVpt = 4;        // H <= 1024, every preset's hidden width

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

__device__ __forceinline__ void load_f32x8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// v[j] holds vector lane + 32 * j of the row (valid when < nvec, the rest
// zero).  Writes the normalised row to out_row.
template <int VPT>
__device__ __forceinline__ void warp_layer_norm(const float (&v)[VPT][8], int lane, int nvec,
                                                int h, const float* __restrict__ scale,
                                                const float* __restrict__ bias, float eps,
                                                __nv_bfloat16* __restrict__ out_row) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += v[j][k];
  const float mean = warp_sum(sum) / h;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (lane + 32 * j >= nvec) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = v[j][k] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / h + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vec = lane + 32 * j;
    if (vec >= nvec) continue;
    float g[8], b[8], y[8];
    load_f32x8(scale + vec * 8, g);
    load_f32x8(bias + vec * 8, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = (v[j][k] - mean) * (rstd * g[k]) + b[k];
    reinterpret_cast<uint4*>(out_row)[vec] = pack8(y);
  }
}

}  // namespace pw
