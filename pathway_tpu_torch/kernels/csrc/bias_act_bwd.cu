// K16: the backward of K4 (bias add + activation), f32.
//
// Replaces: the transpose XLA derives for every nn.Dense bias add and the
//   nn.gelu after mlp_up in EncoderBlock / SelfAttention
//   (pathway_tpu/models/encoder.py:88-150) under jax.value_and_grad in the
//   contrastive train step (__graft_entry__.py:117-131):
//     dx = dy * act'(y + bias),  db = sum over rows of dx
//   for act none (dx = dy, not written), gelu_tanh, gelu_erf and tanh; y
//   is the dense product before the bias (K4's input, kept by the
//   autograd Function before K4 overwrites it).
//
// What bounds it on an H100: bytes.  It reads dy and y (8 bytes a value)
// and writes dx (4), for a few dozen operations a value: at the train
// step's mlp_up, [8192, 3072] f32, that is 302 MB, 0.09 ms at 3.35 TB/s.
//
// What the design does about it: one pass over the rows with 16-byte
// loads.  A block of 32 x 8 threads owns 128 columns (4 a thread) and a
// chunk of rows; each thread keeps its columns' partial db in registers,
// the block sums its 8 rows of threads in order and writes one partial row
// a chunk.  A second launch sums the chunks' partial rows in order, one
// thread a column: db is deterministic, its sum taken in another order
// than torch's (chunks of rows, then the chunks), so it is held at the f32
// tolerance of a sum over M rows (1e-5 of the largest |db|).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kColsPerBlock = 128;  // 32 threads x 4 columns
constexpr int kRowThreads = 8;

__device__ __forceinline__ float act_grad(float x, int act) {
  switch (act) {
    case 1: {  // 0.5 x (1 + tanh(k0 (x + k1 x^3)))
      const float k0 = 0.7978845608028654f, k1 = 0.044715f;
      const float x2 = x * x;
      const float t = tanhf(k0 * (x + k1 * x2 * x));
      return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * k0 * (1.0f + 3.0f * k1 * x2);
    }
    case 2:  // x Phi(x)
      return normcdff(x) + x * 0.3989422804014327f * expf(-0.5f * x * x);
    case 3: {
      const float t = tanhf(x);
      return 1.0f - t * t;
    }
    default:
      return 1.0f;
  }
}

__global__ void __launch_bounds__(kColsPerBlock / 4 * kRowThreads)
dx_kernel(const float* __restrict__ dy, const float* __restrict__ y, const float* __restrict__ bias,
          float* __restrict__ dx, float* __restrict__ partial, int m, int n, int act, int rows_per_chunk) {
  __shared__ float4 red[kRowThreads][kColsPerBlock / 4];
  const int c = blockIdx.x * kColsPerBlock + threadIdx.x * 4;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(m, r0 + rows_per_chunk);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c < n) {
    const float4 b = act ? *reinterpret_cast<const float4*>(bias + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = r0 + threadIdx.y; r < r1; r += kRowThreads) {
      const size_t at = (size_t)r * n + c;
      float4 g = *reinterpret_cast<const float4*>(dy + at);
      if (act) {
        const float4 x = *reinterpret_cast<const float4*>(y + at);
        g.x *= act_grad(x.x + b.x, act);
        g.y *= act_grad(x.y + b.y, act);
        g.z *= act_grad(x.z + b.z, act);
        g.w *= act_grad(x.w + b.w, act);
        *reinterpret_cast<float4*>(dx + at) = g;
      }
      acc.x += g.x;
      acc.y += g.y;
      acc.z += g.z;
      acc.w += g.w;
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float4 s = red[0][threadIdx.x];
    for (int t = 1; t < kRowThreads; ++t) {
      const float4 u = red[t][threadIdx.x];
      s.x += u.x;
      s.y += u.y;
      s.z += u.z;
      s.w += u.w;
    }
    *reinterpret_cast<float4*>(partial + (size_t)blockIdx.y * n + c) = s;
  }
}

__global__ void colsum_kernel(const float* __restrict__ partial, float* __restrict__ out, int chunks, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.0f;
  for (int r = 0; r < chunks; ++r) s += partial[(size_t)r * n + c];
  out[c] = s;
}

}  // namespace

// dy: [m, n] f32; y: [m, n] f32, the product before the bias (null for
// act 0); bias: [n] f32; dx: [m, n] f32 (null for act 0: dx is dy);
// partial: [chunks, n] f32 scratch; db: [n] f32.  n % 4 == 0, pointers
// 16-byte aligned.  act: 0 none, 1 gelu_tanh, 2 gelu_erf, 3 tanh.  Two
// launches.  Returns a cudaError_t.
extern "C" int pw_bias_act_bwd(const void* dy, const void* y, const void* bias, void* dx, void* partial,
                               void* db, int m, int n, int act, int chunks, void* stream) {
  if (n % 4 || chunks < 1 || chunks > 65535 || (act && (!y || !dx))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_chunk = (m + chunks - 1) / chunks;
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, chunks);
  dx_kernel<<<grid, dim3(kColsPerBlock / 4, kRowThreads), 0, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y), static_cast<const float*>(bias),
      static_cast<float*>(dx), static_cast<float*>(partial), m, n, act, rows_per_chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  colsum_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial), static_cast<float*>(db),
                                               chunks, n);
  return (int)cudaGetLastError();
}
