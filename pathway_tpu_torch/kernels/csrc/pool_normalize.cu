// K7: the sentence encoder's tail: masked mean or CLS pooling, then the
// optional L2 normalise (bf16 or f32 in, f32 out).
//
// Replaces: the tail of TextEncoderModel.__call__ in
//   pathway_tpu/models/encoder.py:196-202 with ops/pooling.py:11-21.
//   Mean: the f32 sum of x * m over the sequence divided by max(count, 1),
//   rounded to the hidden type (bf16 or f32) as masked_mean_pool casts
//   back; CLS: row 0.  Normalise, when set: in f32, p / max(||p||, 1e-12) (the
//   encoder's eps, not the 1e-30 of the index ingest).
//
// What bounds it on an H100: for mean pooling, bytes: the valid rows of
// x (L * H * 2 bytes per sequence at most) and the mask, for 2 operations
// per value read.  At B = 256, L = 256, H = 768 that is at most 101 MB,
// 30 us at 3.35 TB/s.  CLS pooling reads B * H * 2 bytes (393 KB at
// B = 256): launch latency dominates it.
//
// What the design does about it: one block per sequence, one thread per
// pair of columns (bf16x2 or float2 loads; a warp reads 128 or 256
// contiguous bytes of a row; the element type is a template parameter).
// Each thread walks the sequence, unrolled by 4 so four rows' loads are
// in flight, multiplying every row by its mask value as the
// JAX program does (a padded row is read and weighted 0, so it costs
// bytes the bound does not count), and keeps its two sums in registers;
// the block then reduces the squared norm through shared memory and
// writes the f32 row once.  The eager version runs six passes (cast,
// multiply, two sums, divide, cast) before the normalise's four.

#include "vec8.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // h <= 2048

// Columns 2i, 2i + 1 of a row as floats.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, size_t i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[i]);
}
__device__ __forceinline__ float2 load2(const float* row, size_t i) {
  return reinterpret_cast<const float2*>(row)[i];
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pool_normalize_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int seq_len, int h, int cls, int normalize) {
  __shared__ float partial[kMaxThreads / 32];
  const int b = blockIdx.x;
  const int pair = threadIdx.x;  // columns 2 * pair, 2 * pair + 1
  const bool active = 2 * pair < h;
  const T* xs = x + (size_t)b * seq_len * h;
  const int row_pairs = h / 2;

  float p0 = 0.0f, p1 = 0.0f;
  if (active) {
    if (cls) {
      const float2 f = load2(xs, pair);
      p0 = f.x;
      p1 = f.y;
    } else {
      const uint8_t* m = mask + (size_t)b * seq_len;
      float count = 0.0f;
#pragma unroll 4
      for (int l = 0; l < seq_len; ++l) {
        const float w = (float)__ldg(m + l);
        const float2 f = load2(xs, (size_t)l * row_pairs + pair);
        count += w;
        p0 += f.x * w;
        p1 += f.y * w;
      }
      count = fmaxf(count, 1.0f);
      p0 = pw::round_to<T>(p0 / count);
      p1 = pw::round_to<T>(p1 / count);
    }
  }

  float denom = 1.0f;
  if (normalize) {
    float ss = p0 * p0 + p1 * p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    float total = 0.0f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) total += partial[w];
    denom = fmaxf(sqrtf(total), 1e-12f);
  }
  if (active) {
    float2 o;
    o.x = normalize ? p0 / denom : p0;
    o.y = normalize ? p1 / denom : p1;
    reinterpret_cast<float2*>(out + (size_t)b * h)[pair] = o;
  }
}

template <typename T>
int launch(const void* x, const void* mask, void* out, int b, int l, int h, int cls,
           int normalize, cudaStream_t stream) {
  const int threads = ((h / 2 + 31) / 32) * 32;
  pool_normalize_kernel<T><<<b, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask), static_cast<float*>(out), l,
      h, cls, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, l, h] bf16 (f32 = 0) or f32 (f32 = 1); mask: [b, l] uint8 (unused
// when cls); out: [b, h] f32.  h even, h <= 2048.  Returns a cudaError_t
// (0 on success).
extern "C" int pw_pool_normalize(const void* x, const void* mask, void* out, int b, int l,
                                 int h, int cls, int normalize, int f32, void* stream) {
  if (b == 0) return 0;
  if (h % 2 != 0 || h <= 0 || h > 2 * kMaxThreads || l <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return launch<float>(x, mask, out, b, l, h, cls, normalize, s);
  return launch<__nv_bfloat16>(x, mask, out, b, l, h, cls, normalize, s);
}
