// K10: the dual encoder's pairwise logits, img . txt^T * exp(s) + b (f32).
//
// Replaces: DualEncoderModel.__call__ in pathway_tpu/models/vision.py:120:
//   img @ txt.T * jnp.exp(logit_scale) + logit_bias, in that order (the
//   product, then a rounded multiply, then a rounded add), with the two
//   scalars read from device memory so no host sync is needed.
//
// What bounds it on an H100: at the sizes a batch gives, neither: at
// 256 x 256 x 768 it moves 1.8 MB (0.5 us at 3.35 TB/s) for 0.1 GFLOP of
// f32-accurate product (0.6 us as three TF32 passes at 495 TFLOP/s), so
// the latency of one launch, its loads and its dependent steps dominates.
//
// What the design does about it: spread the product over the card and keep
// each block's chain of dependent steps short.  A cluster of 8 blocks owns
// a 64 x 64 tile of the output and splits d between its blocks (96 values
// each at d = 768: 4 x 4 tiles x 8 = 128 blocks at 256 x 256).  A block
// loads its slice of img raw and of txt split into TF32 hi and lo parts
// (tf32x3.cuh) into shared memory in the 64-byte swizzle, runs the three
// products on the tensor cores (wgmma m64n64k8, tf32x3_stage) and leaves
// its 64 x 64 partial sums in shared memory.  Each stage's six products go
// into a fresh accumulator that the partial sums take by an IEEE add (the
// kRound form of tf32x3_stage_rows): summed straight into the partial
// sums, the tensor core's truncating accumulation left the logits of a row
// against itself (q.x = |q||x| = 1 at d = 768, logit scale e^2.3) 8.8e-6
// low on average, 1.1e-5 at most (C15, measured on an H100).  Then block
// q of the cluster sums rows 8 q .. 8 q + 7 of the eight partials through
// distributed shared memory, always in the order of the blocks (the result
// does not depend on timing; no atomics), and applies exp(s) and b with
// explicit round-to-nearest multiply and add (no fused multiply-add), as
// the JAX program rounds between them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace pw_ptx;
using namespace pw_sm90;
using namespace pw_tf32x3;

constexpr int kTile = 64;      // output rows and columns of a cluster
constexpr int kSplit = 8;      // blocks of a cluster, each a slice of d
constexpr int kThreads = 128;  // one warpgroup
constexpr int kGroup = 6;      // 16-value stages held at once (96 values)
constexpr int kStageBytes = kTile * kRowBytes;  // 4 KB: one tile of 64 rows
constexpr int kPer = kGroup * kTile * 4 / kThreads;  // 16-byte chunks of each operand a thread
constexpr int kA = 0;
constexpr int kHi = kA + kGroup * kStageBytes;
constexpr int kLo = kHi + kGroup * kStageBytes;
constexpr int kPitch = kTile + 4;  // floats a row of the partial sums
constexpr int kSmemBytes = kLo + kGroup * kStageBytes + 1024;  // + the alignment slack
static_assert(kTile * kPitch * 4 <= kLo + kGroup * kStageBytes, "the partial sums reuse the operand tiles");

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
dual_logits_kernel(const float* __restrict__ img, const float* __restrict__ txt,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ out, int m, int n, int k, int tiles_n) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kSplit;
  const int m0 = tile / tiles_n * kTile, n0 = tile % tiles_n * kTile;

  // this block's stages of d: an even share of the 16-value steps
  const int steps = (k + kRowFloats - 1) / kRowFloats;
  const int per = (steps + kSplit - 1) / kSplit;
  const int s_begin = min(steps, rank * per), s_end = min(steps, s_begin + per);

  float acc[kTile / 2];
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) acc[i] = 0.0f;
  for (int g0 = s_begin; g0 < s_end; g0 += kGroup) {
    const int g_n = min(kGroup, s_end - g0);
    if (g0 != s_begin) __syncthreads();  // the last group's tiles are read
    // 64 rows x 4 chunks of 16 bytes a stage, of each operand: img's
    // copied raw, txt's loaded (all at once), split and stored
    float4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int st = c / (kTile * 4), row = c / 4 % kTile, chunk = c % 4;
      const int col = (g0 + st) * kRowFloats + 4 * chunk;
      const bool a_in = st < g_n && m0 + row < m && col < k;
      if (st < g_n)
        cp_async16(reinterpret_cast<float*>(smem + kA + st * kStageBytes) + swz(row, 4 * chunk),
                   a_in ? img + (size_t)(m0 + row) * k + col : img, a_in ? 16 : 0);
      const bool b_in = st < g_n && n0 + row < n && col < k;
      v[i] = b_in ? __ldg(reinterpret_cast<const float4*>(txt + (size_t)(n0 + row) * k + col))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int st = c / (kTile * 4);
      if (st < g_n)
        store_split(reinterpret_cast<float*>(smem + kHi + st * kStageBytes),
                    reinterpret_cast<float*>(smem + kLo + st * kStageBytes), c / 4 % kTile, c % 4, v[i]);
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the split tiles, to wgmma
    __syncthreads();
    float unused[1][2];
    for (int st = 0; st < g_n; ++st)  // kRound: C15, as K3's C13
      tf32x3_stage_rows<kTile, 1, false, true>(reinterpret_cast<float (&)[1][kTile / 2]>(acc),
                                               reinterpret_cast<const float*>(smem + kA + st * kStageBytes),
                                               reinterpret_cast<const float*>(smem + kHi + st * kStageBytes),
                                               reinterpret_cast<const float*>(smem + kLo + st * kStageBytes),
                                               unused);
  }

  // the partial sums, [64][kPitch] over the operand tiles
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  {
    const int lane = threadIdx.x % 32;
    const int r = 16 * (threadIdx.x / 32) + lane / 4, c = 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < kTile / 8; ++q) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(part + (r + 8 * i) * kPitch + 8 * q + c) =
            make_float2(acc[4 * q + 2 * i], acc[4 * q + 2 * i + 1]);
    }
  }
  cluster.sync();

  // rows 8 rank .. 8 rank + 7 of the tile: 4 columns a thread
  const int row = 8 * rank + threadIdx.x / 16, col = 4 * (threadIdx.x % 16);
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int q = 0; q < kSplit; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + row * kPitch + col);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const float es = expf(*scale), eb = *bias;
  const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
  if (m0 + row < m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (n0 + col + e < n) out[(size_t)(m0 + row) * n + n0 + col + e] = __fadd_rn(__fmul_rn(s4[e], es), eb);
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial sums
}

}  // namespace

// img: [m, k] f32, txt: [n, k] f32, both 16-byte aligned, k % 4 == 0;
// scale and bias: one f32 each, on the device; out: [m, n] f32.  Returns a
// cudaError_t (0 on success).
extern "C" int pw_dual_logits(const void* img, const void* txt, const void* scale,
                              const void* bias, void* out, int m, int n, int k, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k <= 0 || k % 4 != 0) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> done{0};
  const int err = allow_smem(dual_logits_kernel, done, kSmemBytes);
  if (err) return err;
  const int tiles_m = (m + kTile - 1) / kTile, tiles_n = (n + kTile - 1) / kTile;
  dual_logits_kernel<<<tiles_m * tiles_n * kSplit, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(txt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), m, n, k, tiles_n);
  return (int)cudaGetLastError();
}
