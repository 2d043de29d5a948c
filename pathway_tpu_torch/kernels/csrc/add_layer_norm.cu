// K5: fused residual add + LayerNorm for the encoder block (bf16 in and out).
//
// Replaces: the two nn.LayerNorm(x + a) of EncoderBlock.__call__ in
//   pathway_tpu/models/encoder.py:128-150 (attention_ln and mlp_ln):
//   s = bf16(x + r); mean and variance of s in f32; then
//   bf16((s - mean) * rsqrt(var + eps) * scale + bias), eps = 1e-12.
//   XLA fuses the add into the normalisation on the TPU; eager torch runs
//   it as an add, a cast to f32, F.layer_norm and a cast back.
//
// What bounds it on an H100: bytes.  Per row of H values it reads x and r
// (4H bytes) and writes the output (2H bytes) for about 10 operations per
// value: 0.6 operations per byte, far below the 20 at which f32 FMA rate
// would start to matter.  At M = 65,536 rows of 768 that is 302 MB, 90 us
// at 3.35 TB/s; the four eager passes (add, cast, LayerNorm, cast) move 26
// bytes per value against these 6.
//
// What the design does about it: one pass.  One warp per row; each lane
// loads its vectors of x and r with 16-byte loads, rounds the sum to bf16
// as the JAX program does, keeps the row in registers for both statistics
// and the normalise (row_ln.cuh), and stores the bf16 row once.  scale
// and bias (3 KB each) stay in L1/L2 across the rows of a block.

#include "row_ln.cuh"

namespace {

template <int VPT>
__global__ void __launch_bounds__(pw::kRowsPerBlock * 32)
add_ln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
              const float* __restrict__ scale, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, int m, int h, float eps) {
  const int row = blockIdx.x * pw::kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const int nvec = h / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
  const uint4* rr = reinterpret_cast<const uint4*>(r + (size_t)row * h);
  float v[VPT][8];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vec = lane + 32 * j;
    if (vec < nvec) {
      float a[8], b[8];
      pw::unpack8(xr[vec], a);
      pw::unpack8(rr[vec], b);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = pw::round_bf16(a[k] + b[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = 0.0f;
    }
  }
  pw::warp_layer_norm<VPT>(v, lane, nvec, h, scale, bias, eps, out + (size_t)row * h);
}

template <int VPT>
int launch(const void* x, const void* r, const void* scale, const void* bias, void* out, int m,
           int h, float eps, cudaStream_t stream) {
  const int blocks = (m + pw::kRowsPerBlock - 1) / pw::kRowsPerBlock;
  add_ln_kernel<VPT><<<blocks, pw::kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), m, h, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, r, out: [m, h] bf16; scale, bias: [h] f32; h % 8 == 0, h <= 1024;
// every pointer 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int pw_add_layer_norm(const void* x, const void* r, const void* scale,
                                 const void* bias, void* out, int m, int h, float eps,
                                 void* stream) {
  if (m == 0) return 0;
  if (h % 8 != 0 || h <= 0 || h > 32 * 8 * pw::kMaxVpt) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((h / 8 + 31) / 32) {
    case 1: return launch<1>(x, r, scale, bias, out, m, h, eps, s);
    case 2: return launch<2>(x, r, scale, bias, out, m, h, eps, s);
    case 3: return launch<3>(x, r, scale, bias, out, m, h, eps, s);
    default: return launch<4>(x, r, scale, bias, out, m, h, eps, s);
  }
}
