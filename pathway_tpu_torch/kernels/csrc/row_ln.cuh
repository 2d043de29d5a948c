// Shared by K5 (add_layer_norm.cu) and K6 (embed_ln.cu): one warp
// normalises one row of H values that its lanes hold in registers, with
// flax LayerNorm(dtype=T)'s arithmetic after the statistics, T the
// activation type (bf16, or f32 for the f32 configs).
//
// Layout: the row is H / 8 vectors of 8 values (one 16-byte load each in
// bf16, two in f32); lane l holds vectors l, l + 32, ..., so a warp-wide
// load of one vector per lane is contiguous.  VPT (vectors per lane) is a
// template parameter so the row stays in registers: VPT = 3 at H = 768.
//
// Statistics in f32, two-pass over the registers: mean, then the mean of
// squared deviations.  flax's default takes E[s^2] - E[s]^2 clipped at 0;
// on rows of post-residual activations (|mean| well below the standard
// deviation) the two differ by a few f32 ulps of the variance, far below
// one bf16 ulp of the output.  The plain version (F.layer_norm) is
// two-pass too.  Then, in flax's order:
//   y = (s - mean) * (rsqrt(var + eps) * scale) + bias, rounded to T.

#pragma once

#include "vec8.cuh"

namespace pw {

constexpr int kRowsPerBlock = 8;  // one warp per row, 256 threads
constexpr int kMaxVpt = 4;        // H <= 1024, every preset's hidden width

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// v[j] holds vector lane + 32 * j of the row (valid when < nvec, the rest
// zero).  Writes the normalised row to out_row.
template <int VPT, typename T>
__device__ __forceinline__ void warp_layer_norm(const float (&v)[VPT][8], int lane, int nvec,
                                                int h, const float* __restrict__ scale,
                                                const float* __restrict__ bias, float eps,
                                                T* __restrict__ out_row) {
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
    store8(out_row + vec * 8, y);
  }
}

}  // namespace pw
