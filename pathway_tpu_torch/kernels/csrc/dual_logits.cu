// K10: the dual encoder's pairwise logits, img . txt^T * exp(s) + b (f32).
//
// Replaces: DualEncoderModel.__call__ in pathway_tpu/models/vision.py:120:
//   img @ txt.T * jnp.exp(logit_scale) + logit_bias, in that order (the
//   product, then a rounded multiply, then a rounded add), with the two
//   scalars read from device memory so no host sync is needed.
//
// What bounds it on an H100: at the sizes a batch gives, neither: at
// 256 x 256 x 768 it moves 1.8 MB (0.5 us at 3.35 TB/s) for 0.1 GFLOP
// (1.5 us at the 67 TFLOP/s f32 rate), so a single launch's latency
// dominates.  In f32, as the JAX program computes it (tensor cores would
// need TF32, which keeps ~3 decimal digits).
//
// What the design does about it: a plain tiled SIMT product with enough
// blocks to spread over the card.  A block of 256 threads computes a
// 32 x 32 tile of the output (64 blocks at 256 x 256), walking K in steps
// of 32: both 32 x 32 operand tiles are staged in shared memory,
// transposed and padded so neither the stores nor the inner loop's reads
// conflict, and the next step's tiles are loaded into registers (16-byte
// loads) while this step is multiplied, so a step's
// global-load latency hides behind the last one's arithmetic.  Each
// thread keeps a 2 x 2 block of sums in registers (rows ty and ty + 16,
// columns tx and tx + 16).  The epilogue applies exp(s) and b with
// explicit round-to-nearest multiply and add (no fused multiply-add), as
// the JAX program rounds between them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kStep = 32;
constexpr int kThreads = 256;  // 16 x 16, 2 x 2 outputs each
constexpr int kPitch = kTile + 1;  // shared row pitch: conflict-free transposed stores

// One thread's share of a 32 x 32 operand tile, rows [r0, r0 + 32) x
// columns [k0, k0 + 32) of a [rows, k] matrix: 4 consecutive columns of one
// row, all in or all out as k % 4 == 0 (zeros outside the matrix).
__device__ __forceinline__ void fetch(float (&f)[4], const float* __restrict__ a, int rows, int k,
                                      int r0, int k0) {
  const int r = r0 + threadIdx.x / 8, c = k0 + (threadIdx.x % 8) * 4;
  if (r < rows && c < k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(a + (size_t)r * k + c));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    f[0] = f[1] = f[2] = f[3] = 0.0f;
  }
}

// s[col][row] = the fetched values.
__device__ __forceinline__ void store(float (*s)[kPitch], const float (&f)[4]) {
  const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) s[c + q][r] = f[q];
}

__global__ void __launch_bounds__(kThreads)
dual_logits_kernel(const float* __restrict__ img, const float* __restrict__ txt,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ out, int m, int n, int k) {
  __shared__ float a_s[kStep][kPitch];
  __shared__ float b_s[kStep][kPitch];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[2][2] = {};
  float fa[4], fb[4];
  fetch(fa, img, m, k, m0, 0);
  fetch(fb, txt, n, k, n0, 0);
  for (int k0 = 0; k0 < k; k0 += kStep) {
    store(a_s, fa);
    store(b_s, fb);
    __syncthreads();
    if (k0 + kStep < k) {  // the next step's tiles, in flight during this one
      fetch(fa, img, m, k, m0, k0 + kStep);
      fetch(fb, txt, n, k, n0, k0 + kStep);
    }
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float a0 = a_s[kk][ty], a1 = a_s[kk][ty + 16];
      const float b0 = b_s[kk][tx], b1 = b_s[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  const float es = expf(*scale), eb = *bias;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < m && c < n) out[(size_t)r * n + c] = __fadd_rn(__fmul_rn(acc[i][j], es), eb);
    }
  }
}

}  // namespace

// img: [m, k] f32, txt: [n, k] f32, both 16-byte aligned, k % 4 == 0;
// scale and bias: one f32 each, on the device; out: [m, n] f32.  Returns a
// cudaError_t (0 on success).
extern "C" int pw_dual_logits(const void* img, const void* txt, const void* scale,
                              const void* bias, void* out, int m, int n, int k, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k <= 0 || k % 4 != 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  dual_logits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(txt),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<float*>(out),
      m, n, k);
  return (int)cudaGetLastError();
}
