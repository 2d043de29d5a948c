// K9: the vision tower's tail: f32 mean over the patches, the f32
// projection plus its bias, and the L2 normalise (bf16 in, f32 out).
//
// Replaces: VisionEncoderModel.__call__ in pathway_tpu/models/vision.py:81-87:
//   pooled = jnp.mean(x.astype(f32), axis=1) over all P patch rows (no
//   mask, and kept in f32: unlike the text tail, K7, it is not rounded back
//   to bf16); out = pooled @ kernel + bias, an f32 nn.Dense; then
//   out / max(||out||, 1e-12) (the encoder's eps, not the 1e-30 of the
//   index ingest).
//
// What bounds it on an H100: bytes.  It must read x once (B * P * H * 2
// bytes), the projection once ([E, H] f32) and write B * E * 4 bytes, for
// 2 * B * E * H operations of the product: at B = 256, P = 196, H = E = 768,
// 77 MB in 23 us at 3.35 TB/s against 0.3 GFLOP (4.5 us at the 67 TFLOP/s
// f32 rate).
//
// What the design does about it: one block per image, one thread per pair
// of columns for the mean (bf16x2 loads, a warp reads 128 contiguous
// bytes of a row; four rows' loads in flight), the pooled row kept in
// shared memory.  Then each warp takes output columns e in turn and reads
// row e of the [E, H] weight (the torch layout, contiguous in H) with
// 16-byte loads, a warp-sum per column; the projected row stays in shared
// memory for the block-wide norm and is written once.  Every block reads
// the whole 2.4 MB weight, from L2 after the first: 604 MB of L2 traffic
// at B = 256, which a later version cuts by giving a block several images.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 128;
constexpr int kMaxSmemFloats = 11 * 1024;  // 44 KB

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kMaxThreads)
vision_head_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out, int n_rows, int h,
                   int e_dim, float eps) {
  extern __shared__ float smem[];
  float* pooled = smem;       // [h]
  float* proj = smem + h;     // [e_dim]
  __shared__ float partial[kMaxThreads / 32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;

  // 1. the f32 mean of the P rows
  const int row_pairs = h / 2;
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(x + (size_t)b * n_rows * h);
  for (int pair = threadIdx.x; pair < row_pairs; pair += blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
    for (int l = 0; l < n_rows; ++l) {
      const float2 f = __bfloat1622float2(xs[(size_t)l * row_pairs + pair]);
      s0 += f.x;
      s1 += f.y;
    }
    // jnp.mean divides the sum by the count
    pooled[2 * pair] = s0 / (float)n_rows;
    pooled[2 * pair + 1] = s1 / (float)n_rows;
  }
  __syncthreads();

  // 2. out[e] = pooled . weight[e] + bias[e], one warp per column at a time
  const float4* p4 = reinterpret_cast<const float4*>(pooled);
  for (int e = warp; e < e_dim; e += warps) {
    const float4* w4 = reinterpret_cast<const float4*>(weight + (size_t)e * h);
    float acc = 0.0f;
    for (int i = lane; i < h / 4; i += 32) {
      const float4 w = __ldg(w4 + i);
      const float4 p = p4[i];
      acc += w.x * p.x + w.y * p.y + w.z * p.z + w.w * p.w;
    }
    acc = warp_sum(acc);
    if (lane == 0) proj[e] = acc + bias[e];
  }
  __syncthreads();

  // 3. out / max(||out||, eps)
  float ss = 0.0f;
  for (int e = threadIdx.x; e < e_dim; e += blockDim.x) ss += proj[e] * proj[e];
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < warps; ++w) total += partial[w];
  const float denom = fmaxf(sqrtf(total), eps);
  for (int e = threadIdx.x; e < e_dim; e += blockDim.x) out[(size_t)b * e_dim + e] = proj[e] / denom;
}

}  // namespace

// x: [b, n_rows, h] bf16; weight: [e_dim, h] f32; bias: [e_dim] f32;
// out: [b, e_dim] f32.  h % 4 == 0, h <= 2 * 1024, h + e_dim <= kMaxSmemFloats
// (the dynamic shared memory under the 48 KB default, beside the block's
// static 4 KB); weight 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int pw_vision_head(const void* x, const void* weight, const void* bias, void* out,
                              int b, int n_rows, int h, int e_dim, float eps, void* stream) {
  if (b == 0) return 0;
  if (h % 4 != 0 || h <= 0 || h > 2 * kMaxThreads || e_dim <= 0 || n_rows <= 0 ||
      h + e_dim > kMaxSmemFloats)
    return (int)cudaErrorInvalidValue;
  int threads = ((h / 2 + 31) / 32) * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  const size_t smem = (size_t)(h + e_dim) * sizeof(float);
  vision_head_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(out), n_rows, h, e_dim, eps);
  return (int)cudaGetLastError();
}
