// K7: the sentence encoder's tail: masked mean or CLS pooling, then the
// optional L2 normalise (bf16 or f32 in); written as an f32 row
// (pw_pool_normalize) or, on the index ingest, normalised again, cast and
// written straight into the slot of a KNN slab (pw_pool_normalize_into,
// the ingest tail, which takes K2's scatter into the same launch).
//
// Replaces: the tail of TextEncoderModel.__call__ in
//   pathway_tpu/models/encoder.py:196-202 with ops/pooling.py:11-21.
//   Mean: the f32 sum of x * m over the sequence divided by max(count, 1),
//   rounded to the hidden type (bf16 or f32) as masked_mean_pool casts
//   back; CLS: row 0.  Normalise, when set: in f32, p / max(||p||, 1e-12) (the
//   encoder's eps).  The ingest tail then does what _scatter_set_device
//   (pathway_tpu/parallel/sharded_knn.py:166-176) does to the encoder's
//   output: for a cosine index p / max(||p||, 1e-30) again (the ingest eps,
//   on the f32 row the first normalise left), the cast to the slab's type,
//   slab[slot] = row and valid[slot] = 1, a slot outside [0, capacity)
//   dropped as mode="drop" drops it.
//
// What bounds it on an H100: bytes.  Mean pooling reads the rows whose
// mask is set and the mask; CLS reads one row a sequence.  At B = 256,
// L = 256, H = 768 bf16 with lengths 64-256 that is about 63 MB, 19 us at
// 3.35 TB/s; CLS reads 393 KB, and the tail writes 256 slab rows: the
// launch is most of their time.
//
// What the design does about it:
// - Mean: one block a sequence.  The block's threads form R groups, a
//   thread one 16-byte vector of columns (8 bf16 or 4 f32 values); each
//   pass a group takes 8 consecutive rows (their mask values one 8-byte
//   word of the mask, staged in shared memory a tile at a time, so that no
//   row's load waits on a load of its mask value), a thread's 8 loads all
//   in flight, the block R * 8 rows; a row whose mask value is 0 is not
//   read (eight masked rows cost one word test), and rows are weighted by
//   their mask value, as the reference weights them.  The R partial rows
//   are summed through shared memory in row order, then divided, rounded,
//   normalised and written.  At least two blocks an SM (64 registers a
//   thread), so that B = 256 sequences run in one wave on 132 SMs.
//   (Splitting each sequence along L over a cluster of 4 blocks, 1,024
//   blocks in four waves at B = 256, measured slower on an H100: each wave
//   pays the blocks' fixed cost again.)
// - CLS into f32 rows (pw_pool_normalize, cls_out_kernel): one block a
//   sequence, one thread a pair of values of row 0, divided by the norm:
//   at H = 768 a block of 384 such threads measured faster on an H100 than
//   96 threads of 16-byte loads.
// - The ingest tail's CLS: one block a sequence, a thread a 16-byte
//   vector of row 0.
// - In the mean form and the ingest tail both norms are reduced in
//   registers and shared memory and applied as a product with the
//   reciprocal (within an ulp of the reference's division); the ingest
//   tail writes no [B, H] f32 intermediate, and a dropped slot's sequence
//   returns before any of its rows is read.
// Rows whose width is not a multiple of the vector fall back to pairs of
// values (4 or 8 bytes).

#include "vec8.cuh"

namespace {

constexpr int kMaxThreads = 1024;   // a block at h = 2,048 in pairs
constexpr int kMeanThreads = 512;   // a mean block's rows in flight: R = kMeanThreads / vectors a row, at least 1
constexpr int kMaxPart = 4096;      // floats of a mean block's partial rows: R * h <= 512 * 8, or h <= 2,048
constexpr int kUnroll = 8;          // rows a thread has in flight (one 8-byte word of the mask)
constexpr int kMaskTile = 2048;     // mask values a mean block stages in shared memory at a time

// V consecutive values of a row, 16 bytes (8 bf16 or 4 f32) or a pair, as
// loaded (Raw) and as floats (unpack); p aligned to the vector's bytes.
template <typename T, int V>
struct Raw;
template <>
struct Raw<__nv_bfloat16, 8> { uint4 v; };
template <>
struct Raw<__nv_bfloat16, 2> { __nv_bfloat162 v; };
template <>
struct Raw<float, 4> { float4 v; };
template <>
struct Raw<float, 2> { float2 v; };

template <int V>
__device__ __forceinline__ Raw<__nv_bfloat16, V> load_raw(const __nv_bfloat16* p) {
  if constexpr (V == 8) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
  } else {
    return {*reinterpret_cast<const __nv_bfloat162*>(p)};
  }
}
template <int V>
__device__ __forceinline__ Raw<float, V> load_raw(const float* p) {
  if constexpr (V == 4) {
    return {__ldg(reinterpret_cast<const float4*>(p))};
  } else {
    return {__ldg(reinterpret_cast<const float2*>(p))};
  }
}
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16, 8>& r, float* f) { pw::unpack8(r.v, f); }
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16, 2>& r, float* f) {
  const float2 v = __bfloat1622float2(r.v);
  f[0] = v.x;
  f[1] = v.y;
}
__device__ __forceinline__ void unpack(const Raw<float, 4>& r, float* f) {
  f[0] = r.v.x; f[1] = r.v.y; f[2] = r.v.z; f[3] = r.v.w;
}
__device__ __forceinline__ void unpack(const Raw<float, 2>& r, float* f) {
  f[0] = r.v.x;
  f[1] = r.v.y;
}

// V floats stored at p in its type; p aligned to the vector's bytes.
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    if constexpr (V >= 4) {
      reinterpret_cast<float4*>(p)[j / 4] = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    }
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  if constexpr (V == 8) {
    pw::store8(p, f);
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 2)
      reinterpret_cast<__nv_bfloat162*>(p)[j / 2] = __floats2bfloat162_rn(f[j], f[j + 1]);
  }
}

// Where a sequence's pooled row goes, rows pitch elements apart.  kInto 0:
// row b of out [b, h] f32 (pitch h); kInto 1 / 2: row slots[b] of an f32
// / bf16 slab, with valid[slots[b]] = 1.
struct Dst {
  void* base;
  float* valid;
  const int32_t* slots;
  long long pitch;
  long long capacity;
  int cos;  // the ingest tail: normalise again with eps 1e-30
};

// The destination row of sequence b, or -1 for a dropped slot.
template <int kInto>
__device__ __forceinline__ long long dst_row(const Dst& d, int b) {
  if constexpr (kInto == 0) {
    return b;
  } else {
    const long long slot = __ldg(d.slots + b);
    return slot < 0 || slot >= d.capacity ? -1 : slot;
  }
}

// The block's sum of v, the same in every thread and added in one order;
// red holds a float a warp, and a second call takes another red.  Every
// thread of the block calls it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) total += red[w];
  return total;
}

// The pooled row's tail, by the whole block: thread `vec` (holder) holds
// columns [vec * V, vec * V + V) in p.  Normalise (eps 1e-12), for the
// ingest tail normalise again (eps 1e-30), cast and store.  red: two
// floats a warp, one for each norm.
template <int V, int kInto>
__device__ __forceinline__ void finish(float* p, bool holder, int vec, const Dst& d, long long row,
                                       int normalize, float* red) {
  if (normalize) {
    float ss = 0.0f;
    if (holder) {
#pragma unroll
      for (int j = 0; j < V; ++j) ss += p[j] * p[j];
    }
    const float inv = 1.0f / fmaxf(sqrtf(block_sum(ss, red)), 1e-12f);
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] *= inv;
  }
  if (kInto != 0 && d.cos) {
    float ss = 0.0f;
    if (holder) {
#pragma unroll
      for (int j = 0; j < V; ++j) ss += p[j] * p[j];
    }
    const float inv = 1.0f / fmaxf(sqrtf(block_sum(ss, red + kMaxThreads / 32)), 1e-30f);
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] *= inv;
  }
  if (!holder) return;
  if constexpr (kInto == 2) {
    store_vec<V>(static_cast<__nv_bfloat16*>(d.base) + row * d.pitch + vec * V, p);
  } else {
    store_vec<V>(static_cast<float*>(d.base) + row * d.pitch + vec * V, p);
  }
  if (kInto != 0 && vec == 0) d.valid[row] = 1.0f;
}

// CLS into f32 rows: one block a sequence, one thread a pair of columns
// of row 0, p / max(||p||, 1e-12) by a division.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, size_t i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[i]);
}
__device__ __forceinline__ float2 load2(const float* row, size_t i) {
  return reinterpret_cast<const float2*>(row)[i];
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cls_out_kernel(const T* __restrict__ x, float* __restrict__ out, int seq_len, int h, int normalize) {
  __shared__ float partial[kMaxThreads / 32];
  const int b = blockIdx.x;
  const int pair = threadIdx.x;  // columns 2 * pair, 2 * pair + 1
  const bool active = 2 * pair < h;
  const T* xs = x + (size_t)b * seq_len * h;

  float p0 = 0.0f, p1 = 0.0f;
  if (active) {
    const float2 f = load2(xs, pair);
    p0 = f.x;
    p1 = f.y;
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

// The ingest tail's CLS: one block a sequence, one thread a vector of row 0.
template <typename T, int V, int kInto>
__global__ void __launch_bounds__(kMaxThreads)
cls_kernel(const T* __restrict__ x, Dst d, int seq_len, int h, int normalize) {
  __shared__ float red[2 * kMaxThreads / 32];
  const int b = blockIdx.x;
  const long long row = dst_row<kInto>(d, b);
  if (row < 0) return;  // dropped: nothing read
  const int vec = threadIdx.x;
  const bool holder = vec < h / V;
  float p[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = 0.0f;
  if (holder) unpack(load_raw<V>(x + (size_t)b * seq_len * h + vec * V), p);
  finish<V, kInto>(p, holder, vec, d, row, normalize, red);
}

// Mean: one block a sequence; thread (vec, r) of the block the vector vec
// of rows r, r + R, ... (R = rows_in_flight groups of kUnroll rows).
// Two blocks an SM at least (64 registers a thread): B = 256 sequences
// run in one wave on the H100's 132 SMs.
template <typename T, int V, int kInto>
__global__ void __launch_bounds__(V == 2 ? kMaxThreads : kMeanThreads, V == 2 ? 1 : 2)
mean_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask, Dst d, int seq_len, int h,
            int rows_in_flight, int normalize) {
  __shared__ __align__(16) float part[kMaxPart];  // the block's partial rows [R, h], then its sum [h]
  __shared__ float counts[kMaxThreads];            // the mask's sum by partial row
  __shared__ float block_count;
  __shared__ float red[2 * kMaxThreads / 32];
  __shared__ __align__(8) uint8_t smask[kMaskTile + kUnroll];  // + a word read past the last tile row
  const int b = blockIdx.x;
  const long long row = dst_row<kInto>(d, b);
  if (row < 0) return;  // dropped: nothing read
  const int R = rows_in_flight;
  const int nvec = h / V;
  const int vec = threadIdx.x % nvec, r = threadIdx.x / nvec;
  const bool active = r < R;
  const T* xs = x + (size_t)b * seq_len * h + vec * V;
  const uint8_t* ms = mask + (size_t)b * seq_len;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  float count = 0.0f;
  // the sequence's mask a tile at a time in shared memory, so that a row's
  // load waits on no load of its mask value; each pass of the block takes
  // R * kUnroll rows, thread group r the kUnroll consecutive ones at
  // r * kUnroll, whose mask values it reads as one 8-byte word
  for (int t0 = 0; t0 < seq_len; t0 += kMaskTile) {
    const int rows = min(kMaskTile, seq_len - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < rows; i += blockDim.x) smask[i] = __ldg(ms + t0 + i);
    __syncthreads();
    if (!active) continue;
    const T* xt = xs + (size_t)t0 * h;
    for (int i0 = r * kUnroll; i0 < rows; i0 += R * kUnroll) {
      const unsigned long long word = *reinterpret_cast<const unsigned long long*>(smask + i0);
      if (word == 0) continue;  // eight masked rows (a padded tail): nothing to read
      const T* row0 = xt + (size_t)i0 * h;
      Raw<T, V> raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u < rows && ((word >> (8 * u)) & 0xff)) raw[u] = load_raw<V>(row0 + u * h);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned m = (unsigned)(word >> (8 * u)) & 0xffu;
        if (i0 + u < rows && m) {
          const float w = (float)m;
          float v[V];
          unpack(raw[u], v);
          count += w;
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] += v[j] * w;
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) part[r * h + vec * V + j] = acc[j];
    if (vec == 0) counts[r] = count;
  }
  __syncthreads();
  // the R partial rows into row 0, in row order
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    float s = part[i];
    for (int q = 1; q < R; ++q) s += part[q * h + i];
    part[i] = s;
  }
  if (threadIdx.x == 0) {
    float n = 0.0f;
    for (int q = 0; q < R; ++q) n += counts[q];
    block_count = n;
  }
  __syncthreads();
  const bool holder = threadIdx.x < nvec;  // r == 0: vec == threadIdx.x
  const float inv_n = 1.0f / fmaxf(block_count, 1.0f);
  float p[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = holder ? pw::round_to<T>(part[vec * V + j] * inv_n) : 0.0f;
  finish<V, kInto>(p, holder, vec, d, row, normalize, red);
}

int round_up_warps(int threads) { return (threads + 31) / 32 * 32; }

template <typename T, int V, int kInto>
int launch(const void* x, const void* mask, const Dst& d, int b, int l, int h, int cls, int normalize,
           cudaStream_t s) {
  const int nvec = h / V;
  if constexpr (kInto != 0) {  // pw_pool_normalize's CLS form is cls_out_kernel
    if (cls) {
      cls_kernel<T, V, kInto><<<b, round_up_warps(nvec), 0, s>>>(static_cast<const T*>(x), d, l, h, normalize);
      return (int)cudaGetLastError();
    }
  }
  // R rows in flight, R * nvec <= kMeanThreads, so R * h <= kMaxPart; a row
  // of more vectors (only in pairs: h / 2 <= 1,024) takes R = 1 and a block
  // of up to kMaxThreads
  const int rows = nvec >= kMeanThreads ? 1 : kMeanThreads / nvec;
  mean_kernel<T, V, kInto><<<b, round_up_warps(rows * nvec), 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask), d, l, h, rows, normalize);
  return (int)cudaGetLastError();
}

// The vector width by the hidden type and row width: 16 bytes where the
// rows and x allow it, else pairs.
template <int kInto>
int dispatch(const void* x, const void* mask, const Dst& d, int b, int l, int h, int cls, int normalize,
             int x_f32, cudaStream_t s) {
  const bool wide = ((uintptr_t)x % 16 == 0) && h % (x_f32 ? 4 : 8) == 0;
  if (x_f32) {
    if (wide) return launch<float, 4, kInto>(x, mask, d, b, l, h, cls, normalize, s);
    return launch<float, 2, kInto>(x, mask, d, b, l, h, cls, normalize, s);
  }
  if (wide) return launch<__nv_bfloat16, 8, kInto>(x, mask, d, b, l, h, cls, normalize, s);
  return launch<__nv_bfloat16, 2, kInto>(x, mask, d, b, l, h, cls, normalize, s);
}

// What both entries refuse: an odd or too-wide row, a misaligned x.
bool refused(const void* x, int l, int h, int x_f32) {
  return h % 2 != 0 || h <= 0 || h > 2 * kMaxThreads || l <= 0 || (uintptr_t)x % (x_f32 ? 8 : 4) != 0;
}

}  // namespace

// x: [b, l, h] bf16 (f32 = 0) or f32 (f32 = 1), 4-byte (bf16) or 8-byte
// (f32) aligned; mask: [b, l] uint8 (unused when cls); out: [b, h] f32.
// h even, h <= 2048.  Returns a cudaError_t (0 on success).
extern "C" int pw_pool_normalize(const void* x, const void* mask, void* out, int b, int l, int h, int cls,
                                 int normalize, int f32, void* stream) {
  if (b == 0) return 0;
  if (refused(x, l, h, f32)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cls) {
    float* o = static_cast<float*>(out);
    if (f32) {
      cls_out_kernel<float><<<b, round_up_warps(h / 2), 0, s>>>(static_cast<const float*>(x), o, l, h, normalize);
    } else {
      cls_out_kernel<__nv_bfloat16><<<b, round_up_warps(h / 2), 0, s>>>(static_cast<const __nv_bfloat16*>(x), o,
                                                                        l, h, normalize);
    }
    return (int)cudaGetLastError();
  }
  const Dst d = {out, nullptr, nullptr, h, b, 0};
  return dispatch<0>(x, mask, d, b, l, h, 0, normalize, f32, s);
}

// The ingest tail: x and mask as above; slab: [capacity, h] f32
// (slab_bf16 = 0) or bf16 (1) rows pitch elements apart (pitch >= h,
// pitch % 8 == 0, 16-byte aligned; the columns past h are never written);
// valid: [capacity] f32; slots: [b] int32, a slot outside [0, capacity)
// dropped unread.  cos: normalise again with eps 1e-30 before the cast.
// Returns a cudaError_t.
extern "C" int pw_pool_normalize_into(const void* x, const void* mask, void* slab, void* valid,
                                      const void* slots, int b, int l, int h, long long pitch,
                                      long long capacity, int cls, int normalize, int cos, int x_f32,
                                      int slab_bf16, void* stream) {
  if (b == 0) return 0;
  if (refused(x, l, h, x_f32)) return (int)cudaErrorInvalidValue;
  if (pitch < h || pitch % 8 != 0 || (uintptr_t)slab % 16 != 0) return (int)cudaErrorInvalidValue;
  const Dst d = {slab, static_cast<float*>(valid), static_cast<const int32_t*>(slots), pitch, capacity, cos};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab_bf16) return dispatch<2>(x, mask, d, b, l, h, cls, normalize, x_f32, s);
  return dispatch<1>(x, mask, d, b, l, h, cls, normalize, x_f32, s);
}
