// K2: fused row normalise + cast + scatter into the KNN slab, and the
// matching clear of the valid flags.
//
// Replaces: _scatter_set_device (and its non-donating twin
//   _scatter_set_device_safe), _scatter_set and _scatter_clear in
//   pathway_tpu/parallel/sharded_knn.py:123-176: rows -> f32, optional
//   L2 normalise with eps 1e-30, cast to the slab dtype,
//   slab[slots[i]] = row i and valid[slots[i]] = 1 (or 0 to clear), with
//   slots outside [0, capacity) dropped as mode="drop" drops them.
//
// What bounds it on an H100: bytes.  Each row is read once (d * 4 bytes)
// and written once (d * 2 or 4 bytes); the normalise is 3 operations per
// element.  At an ingest chunk of 256 rows of 768 that is under 2 MB, so
// a single launch is a few microseconds, most of it launch latency.
//
// What the design does about it: one launch does what the unfused
// version does in four (norm, divide, cast, index_put, plus the valid
// flags): one block per row reads the row once into registers, reduces
// its squared norm across the block, and writes the cast row straight
// into its slot, in place.  Pad rows (slot == capacity) return at once.
// Rows wider than 2,048 values keep their first 2,048 in registers and
// read the rest twice (norm, then write).  The slab's rows may lie a pitch
// apart that is wider than d (an index keeps its rows 16-byte strided that
// way, the padding columns zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;  // values a thread holds: 2,048 a row, wider rows read twice

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ float load(const float* src) { return *src; }
__device__ __forceinline__ float load(const __nv_bfloat16* src) {
  return __bfloat162float(*src);
}

template <typename SlabT, typename ValT>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(SlabT* __restrict__ slab, float* __restrict__ valid,
               const int32_t* __restrict__ slots, const ValT* __restrict__ vals,
               int d, int64_t pitch, int64_t capacity, int normalize) {
  const int i = blockIdx.x;
  const int64_t slot = slots[i];
  if (slot < 0 || slot >= capacity) return;  // dropped, as mode="drop"
  const ValT* row = vals + (size_t)i * d;
  SlabT* dst = slab + (size_t)slot * pitch;
  constexpr int kHeld = kThreads * kMaxPerThread;  // values held in registers

  float x[kMaxPerThread];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    int c = threadIdx.x + j * kThreads;
    x[j] = c < d ? load(row + c) : 0.0f;
    ss += x[j] * x[j];
  }
  // a row wider than the registers hold: the rest of its squared norm
  for (int c = kHeld + threadIdx.x; c < d; c += kThreads) {
    const float y = load(row + c);
    ss += y * y;
  }

  float denom = 1.0f;
  if (normalize) {
    __shared__ float partial[kThreads / 32];
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
    denom = fmaxf(sqrtf(total), 1e-30f);
  }

#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    int c = threadIdx.x + j * kThreads;
    if (c < d) store(dst + c, normalize ? x[j] / denom : x[j]);
  }
  for (int c = kHeld + threadIdx.x; c < d; c += kThreads) {
    const float y = load(row + c);
    store(dst + c, normalize ? y / denom : y);
  }
  if (threadIdx.x == 0) valid[slot] = 1.0f;
}

__global__ void clear_kernel(float* __restrict__ valid, const int32_t* __restrict__ slots,
                             int n, int64_t capacity) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t slot = slots[i];
  if (slot >= 0 && slot < capacity) valid[slot] = 0.0f;
}

template <typename SlabT, typename ValT>
int launch(void* slab, void* valid, const void* slots, const void* vals, int n, int d,
           int64_t pitch, int64_t capacity, int normalize, cudaStream_t stream) {
  scatter_kernel<SlabT, ValT><<<n, kThreads, 0, stream>>>(
      static_cast<SlabT*>(slab), static_cast<float*>(valid),
      static_cast<const int32_t*>(slots), static_cast<const ValT*>(vals), d, pitch, capacity,
      normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// slab: [capacity, d] rows pitch elements apart (pitch >= d; the columns
// past d are never written) f32 (slab_bf16 = 0) or bf16 (1); valid:
// [capacity] f32; slots: [n] int32; vals: [n, d] f32 (vals_bf16 = 0) or
// bf16 (1), contiguous.  Returns a cudaError_t (0 on success).
extern "C" int pw_slab_scatter(void* slab, void* valid, const void* slots,
                               const void* vals, int n, int d, long long pitch, long long capacity,
                               int slab_bf16, int vals_bf16, int normalize,
                               void* stream) {
  if (n == 0) return 0;
  if (d < 1 || pitch < d) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!slab_bf16 && !vals_bf16)
    return launch<float, float>(slab, valid, slots, vals, n, d, pitch, capacity, normalize, s);
  if (!slab_bf16 && vals_bf16)
    return launch<float, __nv_bfloat16>(slab, valid, slots, vals, n, d, pitch, capacity, normalize, s);
  if (slab_bf16 && !vals_bf16)
    return launch<__nv_bfloat16, float>(slab, valid, slots, vals, n, d, pitch, capacity, normalize, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(slab, valid, slots, vals, n, d, pitch, capacity,
                                               normalize, s);
}

// valid[slots[i]] = 0 for every in-range slot.  Returns a cudaError_t.
extern "C" int pw_slab_clear(void* valid, const void* slots, int n, long long capacity,
                             void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  clear_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<float*>(valid),
                                               static_cast<const int32_t*>(slots), n,
                                               capacity);
  return (int)cudaGetLastError();
}
