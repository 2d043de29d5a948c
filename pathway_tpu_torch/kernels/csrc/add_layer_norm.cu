// K5: fused residual add + LayerNorm for the encoder block (bf16 in and
// out, or f32 in and out for the f32 configs).
//
// Replaces: the two nn.LayerNorm(x + a) of EncoderBlock.__call__ in
//   pathway_tpu/models/encoder.py:128-150 (attention_ln and mlp_ln):
//   s = T(x + r); mean and variance of s in f32; then
//   T((s - mean) * rsqrt(var + eps) * scale + bias), eps = 1e-12, T the
//   activation type (in f32 the roundings are the identity).
//   XLA fuses the add into the normalisation on the TPU; eager torch runs
//   it as an add, a cast to f32, F.layer_norm and a cast back.
//
// What bounds it on an H100: bytes.  Per row of H values it reads x and r
// (4H bytes) and writes the output (2H bytes) for about 10 operations per
// value: 0.6 operations per byte, far below the 20 at which f32 FMA rate
// would start to matter.  At M = 65,536 rows of 768 that is 302 MB, 90 us
// at 3.35 TB/s (f32 activations double the bytes); the four eager passes
// (add, cast, LayerNorm, cast) move 26 bytes per value against these 6.
//
// What the design does about it: one pass.  One warp per row; each lane
// loads its vectors of x and r with 16-byte loads, rounds the sum to the
// activation type as the JAX program does, keeps the row in registers for
// both statistics and the normalise (row_ln.cuh), and stores the row once.
// The element type is a template parameter: one instance for bf16, one
// for f32.  scale
// and bias (3 KB each) stay in L1/L2 across the rows of a block.

#include "row_ln.cuh"

namespace {

template <int VPT, typename T>
__global__ void __launch_bounds__(pw::kRowsPerBlock * 32)
add_ln_kernel(const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ out, int m, int h, float eps) {
  const int row = blockIdx.x * pw::kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const int nvec = h / 8;
  const T* xr = x + (size_t)row * h;
  const T* rr = r + (size_t)row * h;
  float v[VPT][8];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vec = lane + 32 * j;
    if (vec < nvec) {
      float a[8], b[8];
      pw::load8(xr + vec * 8, a);
      pw::load8(rr + vec * 8, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = pw::round_to<T>(a[k] + b[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = 0.0f;
    }
  }
  pw::warp_layer_norm<VPT>(v, lane, nvec, h, scale, bias, eps, out + (size_t)row * h);
}

template <int VPT, typename T>
int launch(const void* x, const void* r, const void* scale, const void* bias, void* out, int m,
           int h, float eps, cudaStream_t stream) {
  const int blocks = (m + pw::kRowsPerBlock - 1) / pw::kRowsPerBlock;
  add_ln_kernel<VPT, T><<<blocks, pw::kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), m, h, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vpt(const void* x, const void* r, const void* scale, const void* bias, void* out,
               int m, int h, float eps, cudaStream_t s) {
  switch ((h / 8 + 31) / 32) {
    case 1: return launch<1, T>(x, r, scale, bias, out, m, h, eps, s);
    case 2: return launch<2, T>(x, r, scale, bias, out, m, h, eps, s);
    case 3: return launch<3, T>(x, r, scale, bias, out, m, h, eps, s);
    default: return launch<4, T>(x, r, scale, bias, out, m, h, eps, s);
  }
}

}  // namespace

// x, r, out: [m, h] bf16 (f32 = 0) or f32 (f32 = 1); scale, bias: [h] f32;
// h % 8 == 0, h <= 1024; every pointer 16-byte aligned.  Returns a
// cudaError_t (0 on success).
extern "C" int pw_add_layer_norm(const void* x, const void* r, const void* scale,
                                 const void* bias, void* out, int m, int h, float eps, int f32,
                                 void* stream) {
  if (m == 0) return 0;
  if (h % 8 != 0 || h <= 0 || h > 32 * 8 * pw::kMaxVpt) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return launch_vpt<float>(x, r, scale, bias, out, m, h, eps, s);
  return launch_vpt<__nv_bfloat16>(x, r, scale, bias, out, m, h, eps, s);
}
