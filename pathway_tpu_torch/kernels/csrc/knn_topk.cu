// K3: fused retrieval scores + valid mask + top-k over the KNN slab.
//
// Replaces: _search_jit -> run in pathway_tpu/parallel/sharded_knn.py:336-341
//   (scores = q . slab^T accumulated in f32, or -l2sq; invalid slots get
//   NEG_INF = -3.0e38; then jax.lax.top_k), with its building blocks
//   ops/distances.py:22,37 and ops/topk.py:17.
//
// What bounds it on an H100: bytes.  Every query must see every valid
// slab row, so those rows (d * 4 bytes each for f32: 2.9 GB of the 3.2 GB
// slab at 1,048,576 x 768 with 10% of the slots invalid, 0.87 ms at 3.35
// TB/s) and the valid flags are read at least once per call.  The f32
// product, 2 * nq * rows * d operations, kept f32-accurate as three TF32
// passes on the tensor cores (165 TFLOP/s of f32 product), passes the
// bytes at nq of about 100; on the FMA units (67 TFLOP/s) it would at 40.
//
// What the design does about it: the [nq, capacity] score matrix never
// reaches device memory.  Pass 1 has two forms, chosen by nq:
//  - row streaming (few queries, score_partial_kernel): a block takes a
//    tile of 256 slab rows and a group of up to 32 queries, which sit in
//    shared memory; each warp streams one row at a time into registers
//    (16-byte loads) and dots it with every query (f32 FMA, warp-shuffle
//    reduction).  Rows flagged invalid are skipped without being read.
//    One query reaches the byte bound.
//  - tiled over an f32 slab (score_tc_kernel): the product on the tensor
//    cores in 3xTF32 (tf32x3.cuh).  A pre-pass splits the queries once a
//    call into TF32 hi and lo parts and their squared norms (scratch of
//    2 * nq * d + nq floats); the slab is never copied or split in device
//    memory.  A persistent grid (one block an SM) walks tiles of 256 slab
//    rows; a producer warp streams each tile's rows, 16 values of d a
//    stage, and the queries' parts, by TMA into a ring of 6 stages
//    (64-byte swizzle, mbarriers).  Two consumer warpgroups own 128 rows
//    each: they split the rows in registers and run wgmma m64nNk8 with the
//    queries as B, N = nq rounded up to 8, 16, 32 or 64, so up to 64
//    queries read the slab once (more run as groups of 64, one group over
//    every tile after another).  The epilogue masks the scores (valid flag,
//    capacity), applies l2sq with ||x||^2 summed from the same registers,
//    and stages them in shared memory.  A warp keeps each of its queries'
//    best k of every row the block has walked, one entry a lane (four for
//    k above 32), and a row enters only if it beats the k-th (a warp-wide
//    shift), so past the first tiles a tile costs a compare a row; the
//    block writes one list a query at the end.
//  - tiled over a bf16 slab (score_tiled_kernel): 256 rows x 32 queries a
//    block, rows and queries staged 32 dimensions at a time in shared
//    memory and an 8-row x 4-query block of scores a thread on the FMA
//    units; the queries are rounded to bf16 by the caller, so every
//    product is exact in f32.
// Slot ids carry an offset, a shard's first global slot (the `li +
// axis_index * shard_rows` of the mesh search, sharded_knn.py:358).  For
// k above 128 (knn_topk.MAX_K) the k rounds would cost more than a
// select: the score-only form of pass 1 writes the tile's masked scores
// as they are, and K13 (topk_select.cu) selects from the [nq, capacity]
// scores.
// Pass 2 merges the partial lists in segments of up to 1024 entries until
// k remain.  Order: higher score first, lower slot first on ties, as
// jax.lax.top_k orders them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"
#include "tf32x3.cuh"
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

// Pass 1 for query batches over a bf16 slab: the same tile of 256 rows
// and 32 queries, but scored as a small matrix product.  Each stage stages 32 dimensions of
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

// ---------------------------------------------------------------------------
// Pass 1 for query batches over an f32 slab: 3xTF32 on wgmma.

namespace tc {

using namespace pw_sm90;
using namespace pw_tf32x3;

constexpr int kStages = 6;
constexpr int kConsumers = 256;            // two warpgroups of 128 tile rows
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kABytes = kRows * kRowBytes; // 16 KB: a stage of the tile's rows
constexpr int kLdS = kRows + 4;            // pitch of the staged scores

template <int N>
struct Layout {
  static constexpr int kBBytes = N * kRowBytes;  // each of the queries' hi and lo
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kScores = kStages * kStageBytes;  // [N][kLdS] f32
  static constexpr int kBars = kScores + N * kLdS * 4;   // full[kStages], empty[kStages]
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + the alignment slack
};

// One warp a query row: its TF32 hi and lo parts and ||q||^2; rows nq ..
// rows - 1 are zeros.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ q, float* __restrict__ hi, float* __restrict__ lo,
             float* __restrict__ qq, int nq, int rows, int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  float sq = 0.0f;
  for (int k = 4 * lane; k < d; k += 128) {
    const float4 v = row < nq ? *reinterpret_cast<const float4*>(q + base + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + base + k) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + base + k) = make_uint4(l[0], l[1], l[2], l[3]);
    sq = fmaf(v.x, v.x, sq);
    sq = fmaf(v.y, v.y, sq);
    sq = fmaf(v.z, v.z, sq);
    sq = fmaf(v.w, v.w, sq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) qq[row] = sq;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

constexpr int kMaxRun = 128;  // = knn_topk.MAX_K: the longest running list, 4 entries a lane

// Offers one query's scores of a tile (v_row[r], r < kRows) to its running
// best kk <= 32 P of the rows this block has seen.  Entry p of the list is
// (bv[p / 32], bi[p / 32]) of lane p % 32, best first; entries kk.. hold
// what fell off.  Only a row better than the kk-th is inserted (the
// entries from its place on move one down, across lanes by shuffles), so
// past the first tiles a query's tile costs a compare a row.  Every lane
// of the warp calls it.
template <int P>
__device__ __forceinline__ void offer_tile(float (&bv)[P], int (&bi)[P], const float* v_row, int kk,
                                           int64_t row0, int64_t capacity, int64_t offset) {
  constexpr int kPer = kRows / 32;
  const int lane = threadIdx.x % 32;
  const int k_e = (kk - 1) / 32;
  const int k_lane = (kk - 1) % 32;
  float kv;
  int ki;
  auto kth = [&]() {  // the kk-th entry, on every lane
    float v = bv[0];
    int i = bi[0];
#pragma unroll
    for (int e = 1; e < P; ++e) {
      if (e == k_e) {
        v = bv[e];
        i = bi[e];
      }
    }
    kv = __shfl_sync(0xffffffffu, v, k_lane);
    ki = __shfl_sync(0xffffffffu, i, k_lane);
  };
  kth();
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int r = lane + 32 * e;
    const bool in = row0 + r < capacity;
    const float x = v_row[r];
    const int id = in ? (int)(row0 + r + offset) : kPadIdx;
    bool cand = in;
    for (unsigned m = __ballot_sync(0xffffffffu, cand && better(x, id, kv, ki)); m;
         m = __ballot_sync(0xffffffffu, cand && better(x, id, kv, ki))) {
      const int src = __ffs(m) - 1;
      const float nv = __shfl_sync(0xffffffffu, x, src);
      const int ni = __shfl_sync(0xffffffffu, id, src);
      int pos = 0;  // < kk: the entries better than the new one
#pragma unroll
      for (int f = 0; f < P; ++f) pos += __popc(__ballot_sync(0xffffffffu, better(bv[f], bi[f], nv, ni)));
      float up_v[P], last_v[P];
      int up_i[P], last_i[P];
#pragma unroll
      for (int f = 0; f < P; ++f) {
        up_v[f] = __shfl_up_sync(0xffffffffu, bv[f], 1);
        up_i[f] = __shfl_up_sync(0xffffffffu, bi[f], 1);
        last_v[f] = __shfl_sync(0xffffffffu, bv[f], 31);
        last_i[f] = __shfl_sync(0xffffffffu, bi[f], 31);
      }
#pragma unroll
      for (int f = 0; f < P; ++f) {
        const int p = 32 * f + lane;
        if (p > pos) {  // entry p takes entry p - 1 (p >= 1, so lane 0 has f >= 1)
          bv[f] = lane > 0 || f == 0 ? up_v[f] : last_v[f > 0 ? f - 1 : 0];
          bi[f] = lane > 0 || f == 0 ? up_i[f] : last_i[f > 0 ? f - 1 : 0];
        } else if (p == pos) {
          bv[f] = nv;
          bi[f] = ni;
        }
      }
      kth();
      if (lane == src) cand = false;
    }
  }
}

// P: entries a lane of each running list, kk <= 32 P (1 for the score-only
// pass, whose kk is 0).
template <int N, bool L2SQ, int P>
__global__ void __launch_bounds__(kThreads, 1)
score_tc_kernel(const __grid_constant__ CUtensorMap slab_map, const __grid_constant__ CUtensorMap hi_map,
                const __grid_constant__ CUtensorMap lo_map, const float* __restrict__ qq,
                const float* __restrict__ valid, float* __restrict__ out_vals,
                int32_t* __restrict__ out_idx, int nq, int d, int64_t capacity, int kk,
                int64_t offset) {
  using S = Layout<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* v_s = reinterpret_cast<float*>(smem + S::kScores);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  auto a_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * S::kStageBytes); };
  auto hi_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * S::kStageBytes + kABytes); };
  auto lo_tile = [&](int s) {
    return reinterpret_cast<float*>(smem + s * S::kStageBytes + kABytes + S::kBBytes);
  };

  const int ntiles = (int)((capacity + kRows - 1) / kRows);
  const int groups = (nq + N - 1) / N;
  const int k_steps = (d + kRowFloats - 1) / kRowFloats;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Work: each group of N queries in turn, and of each this block's tiles
  // (tile = blockIdx.x, + gridDim.x, ...), so that a block keeps the
  // running lists of one group at a time.
  if (warp == kConsumers / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      int j = 0;
      for (int g = 0; g < groups; ++g) {
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
          for (int ks = 0; ks < k_steps; ++ks, ++j) {
            const int s = j % kStages;
            if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
            mbar_expect_tx(&full[s], S::kStageBytes);
            tma_load_2d(a_tile(s), &slab_map, &full[s], ks * kRowFloats, tile * kRows);
            tma_load_2d(hi_tile(s), &hi_map, &full[s], ks * kRowFloats, g * N);
            tma_load_2d(lo_tile(s), &lo_map, &full[s], ks * kRowFloats, g * N);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 128 wg .. 128 wg + 127 of the tile, as two
  // blocks of 64.  This thread's rows are 128 wg + 64 m + r + 8 i (r = 16
  // (warp % 4) + lane / 4); its sums for query 8 n + 2 t + e of them are
  // acc[m][4 n + 2 i + e].  Consumer warp w keeps the running lists of
  // queries w + 8 u.
  const int wg = threadIdx.x / 128;
  const int r = 16 * (warp % 4) + lane / 4;
  const int t = lane % 4;
  float acc[2][N / 2];
  float run_v[N / 8][P];
  int run_i[N / 8][P];
  int j = 0;
  for (int g = 0; g < groups; ++g) {
    const int n_live = min(N, nq - g * N);
#pragma unroll
    for (int u = 0; u < N / 8; ++u) {
#pragma unroll
      for (int f = 0; f < P; ++f) {
        run_v[u][f] = -INFINITY;
        run_i[u][f] = kPadIdx;
      }
    }
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int64_t row0 = (int64_t)tile * kRows;
      float live[2][2];  // this thread's rows' valid flags, read while the products run
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int64_t row = row0 + 128 * wg + 64 * m + r + 8 * i;
          live[m][i] = row < capacity ? __ldg(valid + row) : 0.0f;
        }
      }
      float sq[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.0f;
      }
      for (int ks = 0; ks < k_steps; ++ks) {
        const int s = (j + ks) % kStages;
        mbar_wait(&full[s], ((j + ks) / kStages) & 1);
        tf32x3_stage_rows<N, 2, L2SQ>(acc, a_tile(s) + 128 * wg * kRowFloats, hi_tile(s), lo_tile(s), sq);
        mbar_arrive(&empty[s]);  // stage s may be loaded again
      }
      j += k_steps;

      // the epilogue: masked scores into shared memory, [query][row]
      if (L2SQ) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sq[m][i] += __shfl_xor_sync(0xffffffffu, sq[m][i], 1);
            sq[m][i] += __shfl_xor_sync(0xffffffffu, sq[m][i], 2);
          }
        }
      }
      consumers_sync();  // the previous tile's scores are read
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          const float qn = L2SQ ? __ldg(qq + g * N + c) : 0.0f;
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int rr = 128 * wg + 64 * m + r + 8 * i;
              const float dot = acc[m][4 * n + 2 * i + e];
              const float sc = L2SQ ? -fmaxf(qn - 2.0f * dot + sq[m][i], 0.0f) : dot;
              v_s[c * kLdS + rr] = row0 + rr >= capacity ? -INFINITY : (live[m][i] != 0.0f ? sc : kNegInf);
            }
          }
        }
      }
      consumers_sync();
      if (kk == 0) {  // score-only: every score of the tile's rows, for K13
        for (int e = threadIdx.x; e < n_live * kRows; e += kConsumers) {
          const int c = e / kRows;
          const int rr = e % kRows;
          if (row0 + rr < capacity) out_vals[(size_t)(g * N + c) * capacity + row0 + rr] = v_s[c * kLdS + rr];
        }
      } else {
#pragma unroll
        for (int u = 0; u < N / 8; ++u) {
          if (warp + 8 * u < n_live)
            offer_tile<P>(run_v[u], run_i[u], v_s + (warp + 8 * u) * kLdS, kk, row0, capacity, offset);
        }
      }
    }
    if (kk > 0) {  // this block's list of each query of the group
#pragma unroll
      for (int u = 0; u < N / 8; ++u) {
        const int c = warp + 8 * u;
#pragma unroll
        for (int f = 0; f < P; ++f) {
          const int p = 32 * f + lane;
          if (c < n_live && p < kk) {
            const size_t o = ((size_t)(g * N + c) * gridDim.x + blockIdx.x) * kk + p;
            out_vals[o] = run_v[u][f];
            out_idx[o] = run_i[u][f];
          }
        }
      }
    }
  }
}

// The tensor map of a [rows, d] f32 matrix, a box of [box_rows, 16] in the
// 64-byte swizzle; outside the matrix the box reads zeros.
int tensor_map(CUtensorMap* map, const void* base, long long rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kRowFloats, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int N, bool L2SQ, int P>
int start(const CUtensorMap (&maps)[3], const float* qq, const void* valid, void* out_vals, void* out_idx,
          int nq, int d, long long capacity, int kk, long long offset, int blocks, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const int err = allow_smem(score_tc_kernel<N, L2SQ, P>, done, Layout<N>::kBytes);
  if (err) return err;
  score_tc_kernel<N, L2SQ, P><<<blocks, kThreads, Layout<N>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], qq, static_cast<const float*>(valid), static_cast<float*>(out_vals),
      static_cast<int32_t*>(out_idx), nq, d, capacity, kk, offset);
  return (int)cudaGetLastError();
}

// The split of the queries, then pass 1 over the f32 slab on `blocks`
// blocks (at most one a tile).  scratch: 2 * rows * d + rows floats (rows =
// nq rounded up to a whole number of groups of N).  Two launches.
template <int N, bool L2SQ>
int launch(const void* q, const void* slab, const void* valid, void* scratch, void* out_vals,
           void* out_idx, int nq, int d, long long capacity, int kk, long long offset, int blocks,
           cudaStream_t stream) {
  const int rows = (nq + N - 1) / N * N;
  float* hi = static_cast<float*>(scratch);
  float* lo = hi + (size_t)rows * d;
  float* qq = lo + (size_t)rows * d;
  split_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const float*>(q), hi, lo, qq, nq, rows, d);
  int err = (int)cudaGetLastError();
  CUtensorMap maps[3];
  if (!err) err = tensor_map(&maps[0], slab, capacity, d, kRows);
  if (!err) err = tensor_map(&maps[1], hi, rows, d, N);
  if (!err) err = tensor_map(&maps[2], lo, rows, d, N);
  if (err) return err;
  if (kk > 32)  // lists of up to kMaxRun entries, 4 a lane
    return start<N, L2SQ, 4>(maps, qq, valid, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, stream);
  return start<N, L2SQ, 1>(maps, qq, valid, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, stream);
}

template <bool L2SQ>
int dispatch(const void* q, const void* slab, const void* valid, void* scratch, void* out_vals,
             void* out_idx, int nq, int d, long long capacity, int kk, long long offset, int blocks,
             cudaStream_t s) {
  if (nq <= 8) return launch<8, L2SQ>(q, slab, valid, scratch, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, s);
  if (nq <= 16) return launch<16, L2SQ>(q, slab, valid, scratch, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, s);
  if (nq <= 32) return launch<32, L2SQ>(q, slab, valid, scratch, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, s);
  return launch<64, L2SQ>(q, slab, valid, scratch, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, s);
}

}  // namespace tc

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

using pw_sm90::allow_smem;

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
  const int err = allow_smem(kernel, done, (int)partial_smem(kMaxGroup, kMaxElems * 32));
  if (err) return err;
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
  const int err = allow_smem(kernel, done, (int)bytes);
  if (err) return err;
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

// Pass 1 for query batches.  A bf16 slab runs score_tiled_kernel, groups
// of 32 queries, with the arguments and output of pw_knn_partial (scratch
// and blocks unused).  An f32 slab runs score_tc_kernel on `blocks` blocks
// (1 <= blocks <= ceil(capacity / 256); one an SM) after the split of the
// queries into scratch (2 * rows * d + rows floats, rows = nq rounded up to
// 8, 16, 32 or a multiple of 64; two launches; the slab 16-byte aligned).
// Its output is pw_knn_partial's, but for 1 <= kk <= 128 one list a block:
// out_vals/out_idx [nq, blocks, kk], the best kk of the rows each block
// walked.  Returns a cudaError_t.
extern "C" int pw_knn_partial_tiled(const void* q, const void* slab, const void* valid, void* scratch,
                                    void* out_vals, void* out_idx, int nq, int d,
                                    long long capacity, int slab_bf16, int kk, int l2sq,
                                    long long offset, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kk < 0 || kk > kRows || d % 4 != 0 || (slab_bf16 && d % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (slab_bf16)
    return l2sq ? launch_tiled<__nv_bfloat16, true>(q, slab, valid, out_vals, out_idx, nq, d, capacity, kk, offset, s)
                : launch_tiled<__nv_bfloat16, false>(q, slab, valid, out_vals, out_idx, nq, d, capacity, kk, offset, s);
  if (nq < 1 || kk > tc::kMaxRun || capacity >= (1LL << 31) || blocks < 1 ||
      blocks > (capacity + kRows - 1) / kRows)
    return (int)cudaErrorInvalidValue;
  return l2sq ? tc::dispatch<true>(q, slab, valid, scratch, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, s)
              : tc::dispatch<false>(q, slab, valid, scratch, out_vals, out_idx, nq, d, capacity, kk, offset, blocks, s);
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
