// K3: fused retrieval scores + valid mask + top-k over the KNN slab.
//
// Replaces: _search_jit -> run in pathway_tpu/parallel/sharded_knn.py:336-341
//   (scores = q . slab^T accumulated in f32, or -l2sq; invalid slots get
//   NEG_INF = -3.0e38; then jax.lax.top_k), with its building blocks
//   ops/distances.py:22,37 and ops/topk.py:17.
//
// What bounds it on an H100: bytes at small query batches.  Every query
// must see every valid slab row, so those rows (d * 4 bytes each for f32:
// 3.2 GB at 1,048,576 x 768 when all are valid, 0.96 ms at 3.35 TB/s) and
// the valid flags are read at least once per call.  The f32 arithmetic, 2 * nq * capacity * d operations at
// 67 TFLOP/s, passes the bytes at nq of about 40.
//
// What the design does about it: the [nq, capacity] score matrix never
// reaches device memory.  Pass 1 gives each block a tile of 256 slab rows
// and a group of up to 32 queries, and has two forms, chosen by nq:
//  - row streaming (few queries): the queries sit in shared memory; each
//    warp streams one row at a time into registers (16-byte loads) and
//    dots it with every query (f32 FMA, warp-shuffle reduction).  Rows
//    flagged invalid are skipped without being read.  One query reaches
//    the byte bound.
//  - tiled (many queries): rows and queries are staged 32 dimensions at a
//    time in shared memory and each thread keeps an 8-row x 4-query block
//    of scores in registers, so one 32-byte row read and one 16-byte
//    query read feed 32 FMAs.
// Either way the block then masks, applies the metric's epilogue and
// keeps each query's best k of the tile by k rounds of a warp-wide
// arg-max.  Slot ids carry an offset, a shard's first global slot (the
// `li + axis_index * shard_rows` of the mesh search, sharded_knn.py:358).
// For k above 128 (knn_topk.MAX_K) the k rounds would cost more than a
// select: the score-only form of pass 1 writes the tile's masked scores
// as they are, and K13 (topk_select.cu) selects from the [nq, capacity]
// scores.
// Pass 2 merges the partial lists in segments of up to 1024 entries until
// k remain.  Order: higher score first, lower slot first on ties, as
// jax.lax.top_k orders them.  Tensor cores (TF32 would change the f32
// results) are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "topk.cuh"

namespace {

using pw::better;
using pw::bitonic_sort;
using pw::kNegInf;
using pw::kPadIdx;
using pw::Row;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;          // slab rows per pass-1 block
constexpr int kMaxGroup = 32;       // queries per pass-1 block
constexpr int kMaxElems = 32;       // row elements per lane: d <= 1024

// Write the best kk (<= kRows) of each of `group` arrays of kRows (value,
// index) pairs in shared memory to out[(g0 + qi) * ntiles + tile][0..kk),
// best first.  Each warp takes whole arrays and runs kk rounds of a
// warp-wide arg-max (pw::warp_top_k; each lane holds kRows / 32 entries).
// All threads of the block take part.
__device__ void write_best(const float* v_s, const int* i_s, int group, int kk, int g0,
                           int tile, int ntiles, float* __restrict__ out_vals,
                           int32_t* __restrict__ out_idx) {
  constexpr int kPer = kRows / 32;
  const int lane = threadIdx.x % 32;
  for (int qi = threadIdx.x / 32; qi < group; qi += blockDim.x / 32) {
    float v[kPer];
    int id[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      v[e] = v_s[qi * kRows + lane + 32 * e];
      id[e] = i_s[qi * kRows + lane + 32 * e];
    }
    const size_t o = ((size_t)(g0 + qi) * ntiles + tile) * kk;
    pw::warp_top_k<kPer>(v, id, kk, [&](int j, float bv, int bi) {
      if (lane == 0) {
        out_vals[o + j] = bv;
        out_idx[o + j] = bi;
      }
    });
  }
}

// Pass 1's output for one tile of `group` queries: with kk > 0 each
// query's best kk (write_best); with kk == 0, the score-only pass for k
// above MAX_K, every score of the tile's rows, to out_vals[q * capacity +
// row], for K13 (topk_select.cu) to select from.  All threads take part.
__device__ void write_tile(const float* v_s, const int* i_s, int group, int kk, int g0,
                           int tile, int ntiles, int64_t capacity,
                           float* __restrict__ out_vals, int32_t* __restrict__ out_idx) {
  if (kk > 0) {
    write_best(v_s, i_s, group, kk, g0, tile, ntiles, out_vals, out_idx);
    return;
  }
  const int64_t row0 = (int64_t)tile * kRows;
  for (int e = threadIdx.x; e < group * kRows; e += blockDim.x) {
    const int qi = e / kRows;
    const int r = e % kRows;
    if (row0 + r < capacity) out_vals[(size_t)(g0 + qi) * capacity + row0 + r] = v_s[qi * kRows + r];
  }
}

template <typename SlabT>
__global__ void __launch_bounds__(kThreads)
score_partial_kernel(const float* __restrict__ q, const SlabT* __restrict__ slab,
                     const float* __restrict__ valid, float* __restrict__ out_vals,
                     int32_t* __restrict__ out_idx, int nq, int d, int64_t capacity,
                     int group, int kk, int l2sq, int64_t offset) {
  constexpr int kVec = Row<SlabT>::kVec;
  constexpr int kChunks = kMaxElems / kVec;  // 16-byte chunks per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // [group][d]
  float* qq_s = q_s + group * d;                               // [group]
  float* v_s = qq_s + kMaxGroup;                               // [group][kRows]
  int* i_s = reinterpret_cast<int*>(v_s + group * kRows);      // [group][kRows]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const int g0 = blockIdx.y * group;

  for (int i = threadIdx.x; i < group * d; i += kThreads) {
    const int qi = g0 + i / d;
    q_s[i] = qi < nq ? q[(size_t)g0 * d + i] : 0.0f;
  }
  __syncthreads();
  for (int qi = warp; qi < group; qi += kWarps) {
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s += q_s[qi * d + c] * q_s[qi * d + c];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) qq_s[qi] = s;
  }
  __syncthreads();

  const int nchunks = d / kVec;
  for (int r = warp; r < kRows; r += kWarps) {
    const int64_t row = (int64_t)tile * kRows + r;
    if (row >= capacity || valid[row] == 0.0f) {
      if (lane < group) {
        v_s[lane * kRows + r] = row >= capacity ? -INFINITY : kNegInf;
        i_s[lane * kRows + r] = row >= capacity ? kPadIdx : (int)(row + offset);
      }
      continue;
    }
    const SlabT* src = slab + row * d;
    float x[kMaxElems];
    float cc = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = lane + 32 * j;
      if (c < nchunks) {
        Row<SlabT>::load(src, c, x + j * kVec);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[j * kVec + e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) cc += x[j * kVec + e] * x[j * kVec + e];
    }
    if (l2sq) {
      for (int off = 16; off > 0; off >>= 1) cc += __shfl_xor_sync(0xffffffffu, cc, off);
    }
    for (int qi = 0; qi < group; ++qi) {
      const float* qrow = q_s + qi * d;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int c = lane + 32 * j;
        if (c < nchunks) {
#pragma unroll
          for (int e4 = 0; e4 < kVec / 4; ++e4) {
            const float4 qv = reinterpret_cast<const float4*>(qrow + c * kVec)[e4];
            const float* xe = x + j * kVec + e4 * 4;
            dot += xe[0] * qv.x;
            dot += xe[1] * qv.y;
            dot += xe[2] * qv.z;
            dot += xe[3] * qv.w;
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        v_s[qi * kRows + r] = l2sq ? -fmaxf(qq_s[qi] - 2.0f * dot + cc, 0.0f) : dot;
        i_s[qi * kRows + r] = (int)(row + offset);
      }
    }
  }
  __syncthreads();
  write_tile(v_s, i_s, min(group, nq - g0), kk, g0, tile, gridDim.x, capacity, out_vals, out_idx);
}

// Pass 1 for query batches: the same tile of 256 rows and 32 queries, but
// scored as a small matrix product.  Each stage stages 32 dimensions of
// the tile's rows (transposed) and of its queries in shared memory; each
// thread owns an 8-row x 4-query block of scores in registers.  The next
// stage's rows are fetched into registers while this one is multiplied.
// Then the scores go to shared memory (over the stage buffers) and the
// best k are written as in score_partial_kernel.
constexpr int kBK = 32;            // dimensions per stage
constexpr int kALd = kRows + 4;    // pitch of the transposed row tile
constexpr int kQLd = kMaxGroup + 4;

constexpr size_t tiled_smem() {
  return (size_t)(kBK * kALd + kBK * kQLd) * 4 > (size_t)kMaxGroup * kRows * 8
             ? (size_t)(kBK * kALd + kBK * kQLd) * 4
             : (size_t)kMaxGroup * kRows * 8;
}

template <typename SlabT, bool L2SQ>
__global__ void __launch_bounds__(kThreads, 2)
score_tiled_kernel(const float* __restrict__ q, const SlabT* __restrict__ slab,
                   const float* __restrict__ valid, float* __restrict__ out_vals,
                   int32_t* __restrict__ out_idx, int nq, int d, int64_t capacity, int kk,
                   int64_t offset) {
  constexpr int kVec = Row<SlabT>::kVec;
  constexpr int kChunks = kBK / kVec;               // 16-byte chunks per row per stage
  constexpr int kLoads = kRows * kChunks / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);      // [kBK][kALd]
  float* q_s = a_s + kBK * kALd;                    // [kBK][kQLd]
  float* v_s = reinterpret_cast<float*>(smem);      // after the products: [32][kRows]
  int* i_s = reinterpret_cast<int*>(v_s + kMaxGroup * kRows);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int rg = (tid / 32) * 4 + lane / 8;  // rows rg*8 .. rg*8+7 of the tile
  const int qg = lane % 8;                   // queries qg*4 .. qg*4+3 of the group
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int g0 = blockIdx.y * kMaxGroup;

  float acc[8][4];
  float cc[8];
  float qq[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) qq[j] = 0.0f;

  float pre[kLoads][kVec];
  float4 preq;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int64_t row = row0 + idx / kChunks;
      const int k = k0 + (idx % kChunks) * kVec;
      if (row < capacity && k < d) {
        Row<SlabT>::load(slab + row * d + k, 0, pre[i]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) pre[i][e] = 0.0f;
      }
    }
    const int qi = g0 + tid / 8;
    const int k = k0 + (tid % 8) * 4;
    preq = (qi < nq && k < d) ? *reinterpret_cast<const float4*>(q + (size_t)qi * d + k)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();  // every thread is done reading the previous stage
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) a_s[(c + e) * kALd + r] = pre[i][e];
    }
    {
      const int qi = tid / 8;
      const int c = (tid % 8) * 4;
      q_s[(c + 0) * kQLd + qi] = preq.x;
      q_s[(c + 1) * kQLd + qi] = preq.y;
      q_s[(c + 2) * kQLd + qi] = preq.z;
      q_s[(c + 3) * kQLd + qi] = preq.w;
    }
    __syncthreads();
    if (k0 + kBK < d) fetch(k0 + kBK);
#pragma unroll 4
    for (int kk2 = 0; kk2 < kBK; ++kk2) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk2 * kALd + rg * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk2 * kALd + rg * 8 + 4);
      const float4 b = *reinterpret_cast<const float4*>(q_s + kk2 * kQLd + qg * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bq[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bq[j], acc[i][j]);
      }
      if (L2SQ) {
#pragma unroll
        for (int i = 0; i < 8; ++i) cc[i] = fmaf(a[i], a[i], cc[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) qq[j] = fmaf(bq[j], bq[j], qq[j]);
      }
    }
  }
  __syncthreads();  // the stage buffers become the sort buffers

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    const int64_t row = row0 + r;
    const bool in = row < capacity;
    const bool live = in && valid[row] != 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = qg * 4 + j;
      const float s = L2SQ ? -fmaxf(qq[j] - 2.0f * acc[i][j] + cc[i], 0.0f) : acc[i][j];
      v_s[qi * kRows + r] = !in ? -INFINITY : (live ? s : kNegInf);
      i_s[qi * kRows + r] = in ? (int)(row + offset) : kPadIdx;
    }
  }
  __syncthreads();
  write_tile(v_s, i_s, min(kMaxGroup, nq - g0), kk, g0, blockIdx.x, gridDim.x, capacity,
             out_vals, out_idx);
}

// For each query, sort segment blockIdx.x (seg entries) of its n_in
// candidates and keep the best kk.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ in_vals, const int32_t* __restrict__ in_idx,
             float* __restrict__ out_vals, int32_t* __restrict__ out_idx, int n_in,
             int seg, int kk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v_s = reinterpret_cast<float*>(smem);
  int* i_s = reinterpret_cast<int*>(v_s + seg);
  const int qi = blockIdx.y;
  const int s = blockIdx.x;
  const size_t base = (size_t)qi * n_in;
  for (int e = threadIdx.x; e < seg; e += kThreads) {
    const int src = s * seg + e;
    v_s[e] = src < n_in ? in_vals[base + src] : -INFINITY;
    i_s[e] = src < n_in ? in_idx[base + src] : kPadIdx;
  }
  __syncthreads();
  bitonic_sort(v_s, i_s, seg, 1);
  const size_t o = ((size_t)qi * gridDim.x + s) * kk;
  for (int j = threadIdx.x; j < kk; j += kThreads) {
    out_vals[o + j] = v_s[j];
    out_idx[o + j] = i_s[j];
  }
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` once per device
// (`done` holds one bit per device it was raised on).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

size_t partial_smem(int group, int d) {
  return (size_t)(group * d + kMaxGroup + group * kRows) * 4 + (size_t)group * kRows * 4;
}

template <typename SlabT>
int launch_partial(const void* q, const void* slab, const void* valid, void* out_vals,
                   void* out_idx, int nq, int d, long long capacity, int group, int kk,
                   int l2sq, long long offset, cudaStream_t stream) {
  const size_t bytes = partial_smem(group, d);
  auto kernel = score_partial_kernel<SlabT>;
  static std::atomic<unsigned> done{0};
  cudaError_t err = allow_smem(kernel, partial_smem(kMaxGroup, kMaxElems * 32), done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((capacity + kRows - 1) / kRows), (nq + group - 1) / group);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const SlabT*>(slab),
      static_cast<const float*>(valid), static_cast<float*>(out_vals),
      static_cast<int32_t*>(out_idx), nq, d, capacity, group, kk, l2sq, offset);
  return (int)cudaGetLastError();
}

template <typename SlabT, bool L2SQ>
int launch_tiled(const void* q, const void* slab, const void* valid, void* out_vals,
                 void* out_idx, int nq, int d, long long capacity, int kk, long long offset,
                 cudaStream_t stream) {
  const size_t bytes = tiled_smem();
  auto kernel = score_tiled_kernel<SlabT, L2SQ>;
  static std::atomic<unsigned> done{0};
  cudaError_t err = allow_smem(kernel, bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((capacity + kRows - 1) / kRows), (nq + kMaxGroup - 1) / kMaxGroup);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const SlabT*>(slab),
      static_cast<const float*>(valid), static_cast<float*>(out_vals),
      static_cast<int32_t*>(out_idx), nq, d, capacity, kk, offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1.  q: [nq, d] f32 (rounded to the slab's type by the caller);
// slab: [capacity, d] f32 (slab_bf16 = 0) or bf16 (1); valid: [capacity]
// f32; group <= 32.  With 1 <= kk <= 256, out_vals/out_idx: [nq,
// ceil(capacity / 256), kk] f32/int32, each tile's best kk, the slot ids
// offset by `offset` (a shard's first global slot).  With kk = 0, the
// score-only pass: out_vals [nq, capacity] f32, every slot's score
// (NEG_INF where invalid), out_idx unused.  Returns a cudaError_t.
extern "C" int pw_knn_partial(const void* q, const void* slab, const void* valid,
                              void* out_vals, void* out_idx, int nq, int d,
                              long long capacity, int slab_bf16, int group, int kk,
                              int l2sq, long long offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kMaxGroup || kk < 0 || kk > kRows) return (int)cudaErrorInvalidValue;
  if (slab_bf16) {
    if (d % 8 != 0 || d > kMaxElems * 32) return (int)cudaErrorInvalidValue;
    return launch_partial<__nv_bfloat16>(q, slab, valid, out_vals, out_idx, nq, d, capacity,
                                         group, kk, l2sq, offset, s);
  }
  if (d % 4 != 0 || d > kMaxElems * 32) return (int)cudaErrorInvalidValue;
  return launch_partial<float>(q, slab, valid, out_vals, out_idx, nq, d, capacity, group, kk,
                               l2sq, offset, s);
}

// Pass 1 for query batches (score_tiled_kernel): the same arguments and
// output as pw_knn_partial, groups of 32 queries.  Returns a cudaError_t.
extern "C" int pw_knn_partial_tiled(const void* q, const void* slab, const void* valid,
                                    void* out_vals, void* out_idx, int nq, int d,
                                    long long capacity, int slab_bf16, int kk, int l2sq,
                                    long long offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk < 0 || kk > kRows || d % 4 != 0 || (slab_bf16 && d % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (slab_bf16)
    return l2sq ? launch_tiled<__nv_bfloat16, true>(q, slab, valid, out_vals, out_idx, nq, d, capacity, kk, offset, s)
                : launch_tiled<__nv_bfloat16, false>(q, slab, valid, out_vals, out_idx, nq, d, capacity, kk, offset, s);
  return l2sq ? launch_tiled<float, true>(q, slab, valid, out_vals, out_idx, nq, d, capacity, kk, offset, s)
              : launch_tiled<float, false>(q, slab, valid, out_vals, out_idx, nq, d, capacity, kk, offset, s);
}

// Pass 2.  in: [nq, n_in]; out: [nq, ceil(n_in / seg), kk], seg a power of
// two <= 1024 and kk <= seg.  Returns a cudaError_t.
extern "C" int pw_knn_merge(const void* in_vals, const void* in_idx, void* out_vals,
                            void* out_idx, int nq, int n_in, int seg, int kk, void* stream) {
  if (seg < 2 || seg > 1024 || (seg & (seg - 1)) != 0 || kk < 1 || kk > seg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n_in + seg - 1) / seg, nq);
  merge_kernel<<<grid, kThreads, (size_t)seg * 8, s>>>(
      static_cast<const float*>(in_vals), static_cast<const int32_t*>(in_idx),
      static_cast<float*>(out_vals), static_cast<int32_t*>(out_idx), n_in, seg, kk);
  return (int)cudaGetLastError();
}
