// K18: the in-batch contrastive loss and its gradient, and the backward of
// K7 (pooling + L2 normalise), f32.
//
// Replaces: loss_fn in __graft_entry__.py:117-124 between its two dense
//   products, and the transpose XLA derives for the encoder's tail
//   (pathway_tpu/models/encoder.py:196-202) under jax.value_and_grad:
//  - pw_contrastive_loss: from the logits' product raw = emb . emb^T [B, B],
//      x = raw * 20 - 1e9 on the diagonal (the JAX program's order);
//      lse_i = log sum_j exp(x_ij);  loss = mean_i (lse_i - x_{i, i^1});
//      G = (softmax(x) - onehot(i ^ 1)) * 20 / B = d loss / d raw.
//    B is even: row i's positive is its pair partner i ^ 1.
//  - pw_pool_normalize_bwd: from d emb [B, H] to d hidden [B, L, H]: the L2
//    normalise's backward (p / max(||p||, 1e-12): (g - e (e . g)) / ||p||,
//    or g / 1e-12 where the norm is below it), then CLS pooling's (row 0
//    gets it) or masked mean pooling's (each present token gets it over the
//    count).  The pooled row p is recomputed from the hidden rows.
//
// What bounds it on an H100: neither; both are tiny at the train step's
// sizes (a [64, 64] matrix; 25 MB of d hidden written, 7.5 us of bytes) and
// take a launch's time.
//
// What the design does about it: one launch each.  The loss runs in one
// block: a warp a row (row max, sum of exponentials, G's row), the rows'
// losses summed by each warp in order and the warps' sums in order, so the
// loss is deterministic.  The pool backward runs a block per batch row:
// the pooled row and its norm in shared memory, then d hidden written
// once, zeros included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLossThreads = 1024;
constexpr int kPoolThreads = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float logit(const float* raw, int B, int i, int j, float scale, float diag) {
  const float x = raw[(size_t)i * B + j] * scale;
  return j == i ? x - diag : x;
}

__global__ void __launch_bounds__(kLossThreads)
loss_kernel(const float* __restrict__ raw, float* __restrict__ loss, float* __restrict__ grad, int B, float scale,
            float diag) {
  __shared__ float part[kLossThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const float g_scale = scale / (float)B;
  float mine = 0.0f;  // this warp's rows' losses, in row order
  for (int i = warp; i < B; i += warps) {
    float m = -INFINITY;
    for (int j = lane; j < B; j += 32) m = fmaxf(m, logit(raw, B, i, j, scale, diag));
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < B; j += 32) s += expf(logit(raw, B, i, j, scale, diag) - m);
    const float lse = m + logf(warp_sum(s));
    const int pos = i ^ 1;
    mine += lse - logit(raw, B, i, pos, scale, diag);
    for (int j = lane; j < B; j += 32)
      grad[(size_t)i * B + j] = (expf(logit(raw, B, i, j, scale, diag) - lse) - (j == pos ? 1.0f : 0.0f)) * g_scale;
  }
  if (lane == 0) part[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < warps; ++w) total += part[w];
    *loss = total / (float)B;
  }
}

__global__ void __launch_bounds__(kPoolThreads)
pool_bwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask, const float* __restrict__ g,
                float* __restrict__ dh, int L, int H, int cls, int normalize, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* p = sm;       // [H]: the pooled row, then its gradient
  float* red = p + H;  // [kPoolThreads / 32 + 2]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* xb = x + (size_t)b * L * H;
  const uint8_t* mb = mask + (size_t)b * L;

  float count = 1.0f;
  if (!cls) {
    int c = 0;
    for (int l = tid; l < L; l += kPoolThreads) c += mb[l] != 0;
    c = (int)warp_sum((float)c);
    if (lane == 0) red[warp] = (float)c;
    __syncthreads();
    float total = 0.0f;
    for (int w = 0; w < kPoolThreads / 32; ++w) total += red[w];
    count = fmaxf(total, 1.0f);
    __syncthreads();
  }
  for (int c = tid; c < H; c += kPoolThreads) {
    float s;
    if (cls) {
      s = xb[c];
    } else {
      s = 0.0f;
      for (int l = 0; l < L; ++l) s += mb[l] ? xb[(size_t)l * H + c] : 0.0f;
      s /= count;
    }
    p[c] = s;
  }
  if (normalize) {
    float ss = 0.0f, eg = 0.0f;
    for (int c = tid; c < H; c += kPoolThreads) ss += p[c] * p[c];
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float norm = 0.0f;
    for (int w = 0; w < kPoolThreads / 32; ++w) norm += red[w];
    norm = sqrtf(norm);
    const float den = fmaxf(norm, eps);
    __syncthreads();
    for (int c = tid; c < H; c += kPoolThreads) eg += p[c] / den * g[(size_t)b * H + c];
    eg = warp_sum(eg);
    if (lane == 0) red[warp] = eg;
    __syncthreads();
    float dot = 0.0f;
    for (int w = 0; w < kPoolThreads / 32; ++w) dot += red[w];
    for (int c = tid; c < H; c += kPoolThreads) {
      const float gc = g[(size_t)b * H + c];
      p[c] = norm > eps ? (gc - p[c] / den * dot) / den : gc / eps;
    }
  } else {
    for (int c = tid; c < H; c += kPoolThreads) p[c] = g[(size_t)b * H + c];
  }
  __syncthreads();
  float* db = dh + (size_t)b * L * H;
  for (size_t e = tid; e < (size_t)L * H; e += kPoolThreads) {
    const int l = (int)(e / H);
    const int c = (int)(e % H);
    db[e] = cls ? (l == 0 ? p[c] : 0.0f) : (mb[l] ? p[c] / count : 0.0f);
  }
}

}  // namespace

// raw: [B, B] f32, the product emb . emb^T; loss: [1] f32; grad: [B, B] f32,
// d loss / d raw.  B even, >= 2.  One launch.  Returns a cudaError_t.
extern "C" int pw_contrastive_loss(const void* raw, void* loss, void* grad, int B, float scale, float diag,
                                   void* stream) {
  if (B < 2 || B % 2) return (int)cudaErrorInvalidValue;
  const int threads = B * 32 < kLossThreads ? B * 32 : kLossThreads;
  loss_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(raw), static_cast<float*>(loss), static_cast<float*>(grad), B, scale, diag);
  return (int)cudaGetLastError();
}

// x: [B, L, H] f32, the hidden rows K7 pooled; mask: [B, L] uint8; g:
// [B, H] f32, the gradient of K7's output; dh: [B, L, H] f32.  cls: CLS
// pooling (else masked mean); normalize: K7 normalised.  H <= 8,192.  One
// launch.  Returns a cudaError_t.
extern "C" int pw_pool_normalize_bwd(const void* x, const void* mask, const void* g, void* dh, int B, int L, int H,
                                     int cls, int normalize, float eps, void* stream) {
  if (B == 0) return 0;
  if (L < 1 || H < 1 || H > 8192) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(H + kPoolThreads / 32 + 2) * 4;
  pool_bwd_kernel<<<B, kPoolThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(mask), static_cast<const float*>(g),
      static_cast<float*>(dh), L, H, cls, normalize, eps);
  return (int)cudaGetLastError();
}
