// K12: the IVF cell scan: score the valid rows of each query's probed
// cells and keep the best k per (query, cell share).
//
// Replaces: the gather -> score -> top-k of _search_jit -> block in
//   pathway_tpu/parallel/ivf_knn.py:318-339: sub = cells[probe] ([qb,
//   nprobe, cell_cap, d]), s = bf16(q) . sub accumulated in f32, invalid
//   slots NEG_INF = -3.0e38, top_k over the flattened probe, and the flat
//   id cell * cell_cap + slot.  The probe itself (:320-321) and the final
//   merge are K3's (csrc/knn_topk.cu).
//
// What bounds it on an H100: bytes.  A query must read the valid rows of
// its probed cells (d * 2 bytes each for bf16) and their valid flags; at
// 1M rows in 1,024 cells, 128 probed, that is about 201 MB per query, 0.06
// ms at 3.35 TB/s.  The f32 FMAs (2 * rows * d) are 2.4 per byte read.
//
// What the design does about it: the [qb, nprobe, cell_cap, d] gather of
// the JAX program (6.4 GB per 8-query block at 1M rows) is never
// materialised.  Each block takes one query, one probed cell and every
// `splits`-th tile of 256 slots of it, so a query's few live tiles spread
// over many SMs.  A tile's 256 valid flags are read with one coalesced
// load; a tile with none set costs nothing more.  Otherwise each warp
// streams the tile's valid rows one at a time into registers (16-byte
// loads) and dots them with the query, which each lane keeps in
// registers; then warp 0 merges the tile's scores into the block's
// running best k by k rounds of a warp-wide arg-max.  Rows flagged
// invalid are never read.  Order: higher score first, lower flat id
// first on ties.  For k above 128 (knn_topk.MAX_K) the running list
// would cost k rounds a tile: the score-only form (k = 0) keeps the whole
// tile instead, writing every slot's masked score and flat id of each
// probed cell, and K13 (topk_select.cu) selects from them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using pw::kNegInf;
using pw::kPadIdx;
using pw::Row;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;      // slots per tile: one valid flag per thread
constexpr int kMaxK = 128;           // knn_topk.MAX_K
constexpr int kCand = kTile + kMaxK; // a tile's scores and the running list
constexpr int kPer = kCand / 32;     // candidates per lane in a merge
constexpr int kMaxElems = 32;        // row elements per lane: d <= 1024

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ q, const int32_t* __restrict__ probe,
            const T* __restrict__ cells, const float* __restrict__ valid,
            float* __restrict__ out_vals, int32_t* __restrict__ out_idx, int nprobe, int d,
            int nlist, int cap, int splits, int k) {
  constexpr int kVec = Row<T>::kVec;
  constexpr int kChunks = kMaxElems / kVec;  // 16-byte chunks per lane
  __shared__ float v_s[kCand];  // [0, kTile): this tile's scores; [kTile, kTile + k): running best
  __shared__ int i_s[kCand];
  __shared__ float f_s[kTile];  // this tile's valid flags

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qi = blockIdx.y;
  const int split = blockIdx.x % splits;
  const int cell = probe[(size_t)qi * nprobe + blockIdx.x / splits];
  const bool in_range = cell >= 0 && cell < nlist;  // K3's probe always is
  const int64_t base = (int64_t)cell * cap;

  for (int j = tid; j < k; j += kThreads) {
    v_s[kTile + j] = -INFINITY;
    i_s[kTile + j] = kPadIdx;
  }

  const int nchunks = d / kVec;
  float qr[kMaxElems];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qr[j * kVec + e] = c < nchunks ? q[(size_t)qi * d + c * kVec + e] : 0.0f;
  }

  const int tiles = in_range ? (cap + kTile - 1) / kTile : 0;
  for (int t = split; t < tiles; t += splits) {
    const int slot0 = t * kTile;
    const float flag = slot0 + tid < cap ? valid[base + slot0 + tid] : 0.0f;
    f_s[tid] = flag;
    const int live = __syncthreads_or(flag != 0.0f);
    // a tile with no valid row only matters while the running list still
    // holds pads: its slots are NEG_INF sentinels, as in the JAX program
    if (!live && k > 0 && v_s[kTile + k - 1] != -INFINITY) continue;

    for (int r = warp; r < kTile; r += kWarps) {
      const int slot = slot0 + r;
      float v;
      if (slot >= cap) {
        v = -INFINITY;
      } else if (f_s[r] == 0.0f) {
        v = kNegInf;
      } else {
        const T* src = cells + (base + slot) * d;
        float x[kMaxElems];
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c = lane + 32 * j;
          if (c < nchunks) {
            Row<T>::load(src, c, x + j * kVec);
#pragma unroll
            for (int e = 0; e < kVec; ++e) dot = fmaf(x[j * kVec + e], qr[j * kVec + e], dot);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        v = dot;
      }
      if (lane == 0) {
        v_s[r] = v;
        i_s[r] = slot < cap ? (int)(base + slot) : kPadIdx;
      }
    }
    __syncthreads();

    if (k == 0) {
      // score-only: the tile as it is, at (query, probe rank, slot)
      const size_t o = ((size_t)qi * nprobe + blockIdx.x / splits) * cap;
      for (int r = tid; r < kTile; r += kThreads) {
        if (slot0 + r < cap) {
          out_vals[o + slot0 + r] = v_s[r];
          out_idx[o + slot0 + r] = i_s[r];
        }
      }
    } else if (warp == 0) {
      // candidates: the tile's kTile scores and the running list's k
      const int n_cand = kTile + k;
      float cv[kPer];
      int ci[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int c = lane + 32 * e;
        cv[e] = c < n_cand ? v_s[c] : -INFINITY;
        ci[e] = c < n_cand ? i_s[c] : kPadIdx;
      }
      __syncwarp();
      pw::warp_top_k<kPer>(cv, ci, k, [&](int j, float bv, int bi) {
        if (lane == 0) {
          v_s[kTile + j] = bv;
          i_s[kTile + j] = bi;
        }
      });
    }
    __syncthreads();
  }

  const size_t o = ((size_t)qi * gridDim.x + blockIdx.x) * k;
  for (int j = tid; j < k; j += kThreads) {
    out_vals[o + j] = v_s[kTile + j];
    out_idx[o + j] = i_s[kTile + j];
  }
}

template <typename T>
int launch(const void* q, const void* probe, const void* cells, const void* valid,
           void* out_vals, void* out_idx, int nq, int nprobe, int d, int nlist, int cap,
           int splits, int k, cudaStream_t stream) {
  dim3 grid((unsigned)(nprobe * splits), (unsigned)nq);
  scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const int32_t*>(probe),
      static_cast<const T*>(cells), static_cast<const float*>(valid),
      static_cast<float*>(out_vals), static_cast<int32_t*>(out_idx), nprobe, d, nlist, cap,
      splits, k);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [nq, d] f32 (rounded to the cells' type by the caller); probe: [nq,
// nprobe] int32 cells; cells: [nlist, cap, d] f32 (cells_bf16 = 0) or bf16
// (1); valid: [nlist, cap] f32; out_vals/out_idx: [nq, nprobe * splits, k]
// f32/int32, each block's best k (score, cell * cap + slot), best first,
// padded with (-inf, 0x7fffffff) where it saw fewer than k slots; k <= 128.
// With k = 0, the score-only form: out_vals/out_idx [nq, nprobe, cap],
// every probed slot's score (NEG_INF where invalid) and flat id.
// nlist * cap < 2^31.  Returns a cudaError_t.
extern "C" int pw_ivf_scan(const void* q, const void* probe, const void* cells,
                           const void* valid, void* out_vals, void* out_idx, int nq,
                           int nprobe, int d, int nlist, int cap, int splits, int k,
                           int cells_bf16, void* stream) {
  if (nq == 0 || nprobe == 0) return 0;
  if (k < 0 || k > kMaxK || splits < 1 || cap < 1 || nq > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cells_bf16) {
    if (d % 8 != 0 || d > kMaxElems * 32) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(q, probe, cells, valid, out_vals, out_idx, nq, nprobe, d, nlist,
                                 cap, splits, k, s);
  }
  if (d % 4 != 0 || d > kMaxElems * 32) return (int)cudaErrorInvalidValue;
  return launch<float>(q, probe, cells, valid, out_vals, out_idx, nq, nprobe, d, nlist, cap,
                       splits, k, s);
}
