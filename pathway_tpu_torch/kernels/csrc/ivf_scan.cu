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
// What bounds it on an H100: bytes.  A batch must read the valid rows of
// the cells its queries probe (d * 2 bytes each for bf16) and their valid
// flags: at 1M rows in 1,024 cells, 128 probed, about 201 MB for one
// query, 1.6 GB for the union of 32 queries' cells (0.48 ms at 3.35
// TB/s).  The products are a few FLOP a byte.
//
// Two forms, picked by the wrapper by the number of queries
// (kernels/ivf_scan.py CELL_MAJOR_MIN_QUERIES):
//
// Query-major (pw_ivf_scan, few queries).  Each block takes one query, one
// probed cell and every `splits`-th tile of 256 slots of it, so a query's
// few live tiles spread over many SMs.  A tile's 256 valid flags are read
// with one coalesced load; a tile with none set costs nothing more.
// Otherwise each warp streams the tile's valid rows one at a time into
// registers (16-byte loads) and dots them with the query, which each lane
// keeps in registers; then warp 0 merges the tile's scores into the
// block's running best k by k rounds of a warp-wide arg-max.  A row that
// m queries probe is read m times.  For k above 128 (knn_topk.MAX_K) the
// running list would cost k rounds a tile: the score-only form (k = 0)
// keeps the whole tile instead, writing every slot's masked score and flat
// id of each probed cell, and K13 (topk_select.cu) selects from them.
//
// Cell-major (pw_ivf_scan_cells, batches, k <= 128).  kShares blocks take
// one cell and every (query, probe rank) pair that probes it, found by
// reading `probe` (16 KB at 32 x 128, from L2).  Block s of the cell owns
// every kShares-th granule of 64 slots from granule s on (a thread a
// granule), so the live rows, which fill a cell's first slots, spread
// evenly over the shares and a crowded cell over several SMs; it reads only
// its granules' valid flags (prefetched into L2 while the probe is read)
// as a bit mask a thread.  For each group of kG pairs it holds the
// queries, in the cells' type, in shared memory and streams each live row
// of its share once from HBM through a 3-stage cp.async ring (64 rows x
// 256 bytes a stage); each warp scores a 16-row, 8-pair tile of the stage
// on the tensor cores: bf16 mma.sync m16n8k16 with f32 accumulation (the
// bf16 products are exact in f32, as the JAX program's are), f32 as 3xTF32
// mma.sync m16n8k8 (tf32x3.cuh).  Every 256 rows a warp merges each pair's
// scores into the pair's running best k.  Invalid slots score NEG_INF, as
// in the JAX program: a list that saw fewer than k live rows goes on with
// the share's first invalid slots in slot order.  Each share writes its
// k-lists to scratch and takes a ticket; the last share of the cell to
// finish merges the shares' lists of each pair and writes the pair's best
// k of the cell, so no block waits for another.  The merge fan-in per
// query is nprobe * k, as the query-major form's at 16 queries and more.
//
// Order, both forms: higher score first, lower flat id first on ties.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"
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
constexpr int kMaxElems = 32;        // row elements per lane in one slice of 1024 dims

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

  constexpr int kSlice = kMaxElems * 32;  // dims a lane's registers hold at once
  const int nchunks = min(d, kSlice) / kVec;
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
        // the first 1,024 dims against the query in registers, wider rows
        // slice by slice against the query read from memory (L1-resident)
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
        for (int d0 = kSlice; d0 < d; d0 += kSlice) {
          const int nc = min(d - d0, kSlice) / kVec;
          const float* qs = q + (size_t)qi * d + d0;
#pragma unroll
          for (int j = 0; j < kChunks; ++j) {
            const int c = lane + 32 * j;
            if (c < nc) {
              Row<T>::load(src + d0, c, x + j * kVec);
#pragma unroll
              for (int e = 0; e < kVec; ++e) dot = fmaf(x[j * kVec + e], __ldg(qs + c * kVec + e), dot);
            }
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

// ---------------------------------------------------------------------------
// The cell-major form

namespace cm {

using pw::better;
using pw::kNegInf;
using pw::kPadIdx;
using pw_ptx::cp_async16;
using pw_ptx::cp_async_commit;
using pw_ptx::cp_async_wait;
using pw_ptx::smem_u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShares = 4;                 // blocks a cell, each an even share of its live rows
constexpr int kMaxK = 128;                 // knn_topk.MAX_K
constexpr int kRows = 64;                  // live rows a stage holds: 4 tiles of 16 for mma
constexpr int kSliceBytes = 256;           // bytes of each row a stage holds
constexpr int kRowPitch = kSliceBytes + 16;  // 16 bytes apart mod 128: ldmatrix and LDS without conflicts
constexpr int kStages = 3;
constexpr int kStageBytes = kRows * kRowPitch;
constexpr int kChunk = 256;                // rows whose scores are merged at once
constexpr int kWindow = 2048;              // live rows whose slots are listed at once
constexpr int kPairs = 512;                // (query, probe rank) pairs buffered
constexpr int kScan = 16;                  // probe entries a thread reads a pass
constexpr int kBits = 64;                  // valid flags a thread owns (a granule)
constexpr int kMaxCap = kThreads * kShares * kBits;  // 65,536: a granule a thread
constexpr int kMergePer = (kChunk + kMaxK) / 32;   // a chunk's scores and a running list
constexpr int kSharePer = kShares * kMaxK / 32;    // the shares' lists of one pair
constexpr int kMaxSmem = 232448;

// Byte offsets of the dynamic shared memory, for rows of `row_bytes`, kG
// pairs a group and k kept: the same on host and device.
struct Layout {
  int qpb, ring, q, sc, lv, li, win, pairs, sent, scratch, total;
};

__host__ __device__ inline Layout layout(int row_bytes, int groups, int k) {
  Layout L;
  L.qpb = (row_bytes + 127) / 128 * 128 + 16;  // 16 bytes apart mod 128, and zeros past the row
  int off = 0;
  L.ring = off;
  off += kStages * kStageBytes;
  L.q = off;
  off += groups * L.qpb;
  L.sc = off;
  off += groups * kChunk * 4;
  L.lv = off;
  off += (groups * k * 4 + 15) / 16 * 16;
  L.li = off;
  off += (groups * k * 4 + 15) / 16 * 16;
  L.win = off;
  off += kWindow * 4;
  L.pairs = off;
  off += kPairs * 4;
  L.sent = off;
  off += kMaxK * 4;
  L.scratch = off;
  off += 2 * kWarps * 4;
  L.total = off;
  return L;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c[0..3] += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Exclusive prefix of v over the block's threads in thread order; the
// block's total in `total`.  Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  total = all;
  return before + x - v;
}

// One stage of a warp's 16 x 8 score tile: `steps` 32-byte steps of the
// rows in `stage` (m-tile mt) against the pairs' queries (n-tile nt) from
// column byte `col` on.
template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&acc)[4], const unsigned char* stage,
                                             const unsigned char* q_s, int qpb, int mt, int nt, int col,
                                             int steps) {
    const int lane = threadIdx.x % 32;
    const uint32_t a = smem_u32(stage + (mt * 16 + lane % 16) * kRowPitch + lane / 16 * 16);
    const uint32_t b = smem_u32(q_s + (nt * 8 + lane % 8) * qpb + col + lane / 8 % 2 * 16);
    for (int s = 0; s < steps; ++s) {
      uint32_t af[4], bf[2];
      ldmatrix_x4(af, a + 32 * s);
      ldmatrix_x2(bf, b + 32 * s);
      mma_bf16(acc, af, bf);
    }
  }
};

template <>
struct Tile<float> {
  static __device__ __forceinline__ void run(float (&acc)[4], const unsigned char* stage,
                                             const unsigned char* q_s, int qpb, int mt, int nt, int col,
                                             int steps) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* a0 = reinterpret_cast<const float*>(stage + (mt * 16 + g) * kRowPitch) + t;
    const float* a1 = a0 + 8 * (kRowPitch / 4);
    const float* b = reinterpret_cast<const float*>(q_s + (nt * 8 + g) * qpb + col) + t;
    for (int s = 0; s < steps; ++s) {
      uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
      pw_tf32x3::split_tf32(a0[8 * s], ah[0], al[0]);
      pw_tf32x3::split_tf32(a1[8 * s], ah[1], al[1]);
      pw_tf32x3::split_tf32(a0[8 * s + 4], ah[2], al[2]);
      pw_tf32x3::split_tf32(a1[8 * s + 4], ah[3], al[3]);
      pw_tf32x3::split_tf32(b[8 * s], bh0, bl0);
      pw_tf32x3::split_tf32(b[8 * s + 4], bh1, bl1);
      pw_tf32x3::mma_3xtf32(acc, ah, al, bh0, bl0, bh1, bl1);
    }
  }
};

// grid: (nlist + 1) * kShares blocks, kShares per cell and one more group
// for probe entries outside [0, nlist).  q [nq, d] in the cells' type;
// lists [nq * nprobe, kShares, k] scratch; tickets [nlist + 1, flushes]
// zeros; out [nq, nprobe, k].
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, 2)
cells_kernel(const T* __restrict__ q, const int32_t* __restrict__ probe,
             const unsigned char* __restrict__ cells, const float* __restrict__ valid,
             float* __restrict__ lists_v, int32_t* __restrict__ lists_i, int32_t* __restrict__ tickets,
             float* __restrict__ out_vals, int32_t* __restrict__ out_idx, int nq, int nprobe, int d,
             int nlist, int cap, int k, int flushes) {
  constexpr int kNT = kG / 8;  // n-tiles of 8 pairs
  extern __shared__ __align__(128) unsigned char smem[];
  const int share = blockIdx.x % kShares;
  const int cell = blockIdx.x / kShares;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool pad_cell = cell == nlist;  // the probe entries out of range
  if (pad_cell && share != 0) return;

  const int row_bytes = d * (int)sizeof(T);
  const Layout L = layout(row_bytes, kG, k);
  unsigned char* ring = smem + L.ring;
  unsigned char* q_s = smem + L.q;
  float* sc_s = reinterpret_cast<float*>(smem + L.sc);
  float* lv_s = reinterpret_cast<float*>(smem + L.lv);
  int* li_s = reinterpret_cast<int*>(smem + L.li);
  int* win_s = reinterpret_cast<int*>(smem + L.win);
  int* pairs_s = reinterpret_cast<int*>(smem + L.pairs);
  int* sent_s = reinterpret_cast<int*>(smem + L.sent);
  int* scratch = reinterpret_cast<int*>(smem + L.scratch);
  const int64_t base = (int64_t)cell * cap;

  // This share's slots: granules of kBits slots, granule g = kShares * tid
  // + share for thread tid, so that a cell's live rows, which fill its
  // first slots, spread evenly over its shares.  Their flags on their way
  // to L2 while the probe is read.
  const int s0 = (kShares * tid + share) * kBits;
  if (!pad_cell && s0 < cap) {
    asm volatile("prefetch.L2 [%0];\n" ::"l"(valid + base + s0));
    asm volatile("prefetch.L2 [%0];\n" ::"l"(valid + base + s0 + 32));
  }

  // the share's live rows: a bit a slot of the thread's granule, and the
  // live rank (in slot order) of the granule's first
  bool counted = false;
  uint64_t live = 0;
  int first = 0, n_live = 0, n_sent = 0;

  auto count_share = [&]() {
    uint64_t im = 0;
    if (s0 < cap) {
      float4 f[kBits / 4];
#pragma unroll
      for (int c = 0; c < kBits / 4; ++c)
        f[c] = s0 + 4 * c < cap ? __ldg(reinterpret_cast<const float4*>(valid + base + s0 + 4 * c))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int c = 0; c < kBits / 4; ++c) {
        if (s0 + 4 * c >= cap) continue;
        const float v4[4] = {f[c].x, f[c].y, f[c].z, f[c].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint64_t bit = 1ull << (4 * c + e);
          if (v4[e] != 0.0f) live |= bit; else im |= bit;
        }
      }
    }
    int total;
    const int pre = block_scan((__popcll(live) << 16) | __popcll(im), scratch, total);
    first = pre >> 16;
    n_live = total >> 16;
    // the share's first k invalid slots, in slot order: its sentinels
    int rank = pre & 0xffff;
    for (uint64_t m = im; m && rank < k; m &= m - 1, ++rank) sent_s[rank] = s0 + __ffsll((long long)m) - 1;
    n_sent = min(k, total & 0xffff);
    counted = true;
  };

  // list the slots of live ranks [wlo, whi) in win_s
  auto list_window = [&](int wlo, int whi) {
    int at = first;
    if (at < whi && at + __popcll(live) > wlo) {
      for (uint64_t m = live; m && at < whi; m &= m - 1, ++at)
        if (at >= wlo) win_s[at - wlo] = s0 + __ffsll((long long)m) - 1;
    }
    __syncthreads();
  };

  // merge a chunk's scores (rows [c0, c0 + n) of the window) into each
  // pair's running list
  auto merge_chunk = [&](int n_pairs, int c0, int n) {
    for (int p = warp; p < n_pairs; p += kWarps) {
      float* lv = lv_s + p * k;
      int* li = li_s + p * k;
      const float tv = lv[k - 1];
      const int ti = li[k - 1];
      float cv[kMergePer];
      int ci[kMergePer];
      bool any = false;
#pragma unroll
      for (int e = 0; e < kMergePer; ++e) {
        const int c = lane + 32 * e;
        if (c < kChunk) {
          const bool in = c < n;
          cv[e] = in ? sc_s[p * kChunk + c] : -INFINITY;
          ci[e] = in ? (int)(base + win_s[c0 + c]) : kPadIdx;
          any |= in && better(cv[e], ci[e], tv, ti);
        } else {
          const int j = c - kChunk;
          cv[e] = j < k ? lv[j] : -INFINITY;
          ci[e] = j < k ? li[j] : kPadIdx;
        }
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      __syncwarp();
      pw::warp_top_k<kMergePer>(cv, ci, k, [&](int j, float bv, int bi) {
        if (lane == 0) {
          lv[j] = bv;
          li[j] = bi;
        }
      });
      __syncwarp();
    }
  };

  // stream live ranks [wlo, wlo + nw) (listed in win_s) through the ring;
  // the first commit also carries the group's queries, if still in flight
  auto stream_window = [&](int n_pairs, int nw) {
    const int nsl = (row_bytes + kSliceBytes - 1) / kSliceBytes;
    const int nrb = (nw + kRows - 1) / kRows;
    const int nst = nrb * nsl;
    auto issue = [&](int j) {
      const int rb = j / nsl, sl = j % nsl;
      unsigned char* buf = ring + (j % kStages) * kStageBytes;
      for (int c = tid; c < kRows * (kSliceBytes / 16); c += kThreads) {
        const int r = c / (kSliceBytes / 16), off = sl * kSliceBytes + c % (kSliceBytes / 16) * 16;
        const int row = rb * kRows + r;
        const bool in = row < nw && off < row_bytes;
        const unsigned char* src = in ? cells + (size_t)(base + win_s[row]) * row_bytes + off : cells;
        cp_async16(buf + r * kRowPitch + off - sl * kSliceBytes, src, in ? 16 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst) issue(s);
      cp_async_commit();
    }
    const int mt = warp % 4, nt = warp / 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < nst; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage j landed; every warp is done with stage j - 1
      if (j + kStages - 1 < nst) issue(j + kStages - 1);
      cp_async_commit();
      const int rb = j / nsl, sl = j % nsl;
      if (nt < kNT) {
        const int bytes = min(kSliceBytes, row_bytes - sl * kSliceBytes);
        Tile<T>::run(acc, ring + (j % kStages) * kStageBytes, q_s, L.qpb, mt, nt, sl * kSliceBytes,
                     (bytes + 31) / 32);
      }
      if (sl == nsl - 1) {
        if (nt < kNT) {
          const int row = rb % (kChunk / kRows) * kRows + mt * 16 + lane / 4;
          const int col = nt * 8 + 2 * (lane % 4);
          sc_s[col * kChunk + row] = acc[0];
          sc_s[(col + 1) * kChunk + row] = acc[1];
          sc_s[col * kChunk + row + 8] = acc[2];
          sc_s[(col + 1) * kChunk + row + 8] = acc[3];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
        }
        if (rb % (kChunk / kRows) == kChunk / kRows - 1 || rb == nrb - 1) {
          __syncthreads();
          const int c0 = rb / (kChunk / kRows) * kChunk;
          merge_chunk(n_pairs, c0, min(kChunk, nw - c0));
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  // score this share of the cell for pairs_s[0, n), kG pairs at a time;
  // the last share to finish a flush merges the shares' lists of each pair
  int flush_no = 0;
  auto flush = [&](int n) {
    if (n == 0) return;
    if (pad_cell) {
      for (int i = tid; i < n * k; i += kThreads) {
        const size_t o = (size_t)pairs_s[i / k] * k + i % k;
        out_vals[o] = -INFINITY;
        out_idx[o] = kPadIdx;
      }
      __syncthreads();
      return;
    }
    if (!counted) count_share();
    for (int g0 = 0; g0 < n; g0 += kG) {
      const int n_pairs = min(kG, n - g0);
      // the group's queries (in T), zeros past the row and past the pairs
      for (int c = tid; c < kG * (L.qpb / 16); c += kThreads) {
        const int p = c / (L.qpb / 16), off = c % (L.qpb / 16) * 16;
        const bool in = p < n_pairs && off < row_bytes;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(q) +
                                   (in ? (size_t)(pairs_s[g0 + p] / nprobe) * row_bytes + off : 0);
        cp_async16(q_s + p * L.qpb + off, src, in ? 16 : 0);
      }
      for (int i = tid; i < kG * k; i += kThreads) {
        lv_s[i] = -INFINITY;
        li_s[i] = kPadIdx;
      }
      for (int wlo = 0; wlo < n_live; wlo += kWindow) {
        const int whi = min(n_live, wlo + kWindow);
        list_window(wlo, whi);
        stream_window(n_pairs, whi - wlo);
      }
      cp_async_commit();
      cp_async_wait<0>();  // the queries, where no row was streamed
      __syncthreads();
      // a pair's list that saw fewer than k live rows goes on with the
      // share's first invalid slots, NEG_INF as in the JAX program
      for (int p = tid; p < n_pairs; p += kThreads) {
        int m = 0;
        while (m < k && lv_s[p * k + m] != -INFINITY) ++m;
        for (int i = 0; i < n_sent && m + i < k; ++i) {
          lv_s[p * k + m + i] = kNegInf;
          li_s[p * k + m + i] = (int)(base + sent_s[i]);
        }
      }
      __syncthreads();
      // this share's lists of the group's pairs
      for (int i = tid; i < n_pairs * k; i += kThreads) {
        const size_t o = ((size_t)pairs_s[g0 + i / k] * kShares + share) * k + i % k;
        lists_v[o] = lv_s[i];
        lists_i[o] = li_s[i];
      }
      __syncthreads();  // the lists are read before the next group resets them
    }
    // the last share of this flush merges
    __threadfence();
    __syncthreads();
    if (tid == 0) scratch[0] = atomicAdd(tickets + (size_t)cell * flushes + flush_no, 1);
    __syncthreads();
    const bool last = scratch[0] == kShares - 1;
    __syncthreads();
    ++flush_no;
    if (!last) return;
    __threadfence();
    for (int p = warp; p < n; p += kWarps) {
      const size_t o = (size_t)pairs_s[p] * k;
      float cv[kSharePer];
      int ci[kSharePer];
#pragma unroll
      for (int e = 0; e < kSharePer; ++e) {
        const int c = lane + 32 * e;
        const bool in = c < kShares * k;
        cv[e] = in ? __ldcg(lists_v + o * kShares + c) : -INFINITY;
        ci[e] = in ? __ldcg(lists_i + o * kShares + c) : kPadIdx;
      }
      pw::warp_top_k<kSharePer>(cv, ci, k, [&](int j, float bv, int bi) {
        if (lane == 0) {
          out_vals[o + j] = bv;
          out_idx[o + j] = bi;
        }
      });
    }
    __syncthreads();
  };

  // the pairs that probe this cell (or, for the pad block, no cell), in
  // probe order, kPairs at most between flushes
  const int entries = nq * nprobe;
  int buffered = 0;
  for (int p0 = 0; p0 < entries; p0 += kThreads * kScan) {
    const int e0 = p0 + tid * kScan;
    int pv[kScan];
    if (e0 + kScan <= entries) {
#pragma unroll
      for (int i = 0; i < kScan / 4; ++i) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(probe + e0) + i);
        pv[4 * i] = v.x;
        pv[4 * i + 1] = v.y;
        pv[4 * i + 2] = v.z;
        pv[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScan; ++i) pv[i] = e0 + i < entries ? __ldg(probe + e0 + i) : cell - 1;
    }
    uint32_t match = 0;
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const bool hit = e0 + i < entries && (pad_cell ? (pv[i] < 0 || pv[i] >= nlist) : pv[i] == cell);
      match |= hit ? 1u << i : 0u;
    }
    int total;
    const int at = block_scan(__popc(match), scratch, total);
    if (buffered + total > kPairs) {
      flush(buffered);
      buffered = 0;
    }
    for (int sub = 0; sub < total; sub += kPairs) {
      int r = at;
      for (uint32_t m = match; m; m &= m - 1, ++r)
        if (r >= sub && r < sub + kPairs) pairs_s[buffered + r - sub] = e0 + __ffs(m) - 1;
      __syncthreads();
      buffered += min(kPairs, total - sub);
      if (sub + kPairs < total) {
        flush(buffered);
        buffered = 0;
      }
    }
  }
  flush(buffered);
}

// Most flushes a block makes for nq * nprobe probe entries.
__host__ __device__ inline int max_flushes(int entries) { return 2 * ((entries + kPairs - 1) / kPairs) + 1; }

// Pairs a group scores at once (16, else 8) for rows of d elements of T,
// k kept, cells of cap slots and `entries` probe entries; 0 where the
// form does not take them.
template <typename T>
int plan_groups(int d, int k, int cap, long long entries) {
  if (d < 1 || d % (16 / (int)sizeof(T)) || k < 1 || k > kMaxK || cap < 1 || cap % 4 || cap > kMaxCap ||
      entries < 1 || entries >= (1ll << 30))
    return 0;
  for (int g : {16, 8})
    if (layout(d * (int)sizeof(T), g, k).total <= kMaxSmem) return g;
  return 0;
}

template <typename T, int kG>
int launch_groups(const void* q, const void* probe, const void* cells, const void* valid, void* lists_v,
                  void* lists_i, void* tickets, void* out_vals, void* out_idx, int nq, int nprobe, int d,
                  int nlist, int cap, int k, cudaStream_t stream) {
  static std::atomic<unsigned> allowed{0};
  const int err = pw_sm90::allow_smem(cells_kernel<T, kG>, allowed, kMaxSmem);
  if (err) return err;
  cells_kernel<T, kG><<<(nlist + 1) * kShares, kThreads, layout(d * (int)sizeof(T), kG, k).total, stream>>>(
      static_cast<const T*>(q), static_cast<const int32_t*>(probe), static_cast<const unsigned char*>(cells),
      static_cast<const float*>(valid), static_cast<float*>(lists_v), static_cast<int32_t*>(lists_i),
      static_cast<int32_t*>(tickets), static_cast<float*>(out_vals), static_cast<int32_t*>(out_idx), nq, nprobe,
      d, nlist, cap, k, max_flushes(nq * nprobe));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* probe, const void* cells, const void* valid, void* lists_v,
           void* lists_i, void* tickets, void* out_vals, void* out_idx, int nq, int nprobe, int d, int nlist,
           int cap, int k, cudaStream_t stream) {
  switch (plan_groups<T>(d, k, cap, (long long)nq * nprobe)) {
    case 16:
      return launch_groups<T, 16>(q, probe, cells, valid, lists_v, lists_i, tickets, out_vals, out_idx, nq,
                                  nprobe, d, nlist, cap, k, stream);
    case 8:
      return launch_groups<T, 8>(q, probe, cells, valid, lists_v, lists_i, tickets, out_vals, out_idx, nq,
                                 nprobe, d, nlist, cap, k, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cm

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
    if (d % 8 != 0) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(q, probe, cells, valid, out_vals, out_idx, nq, nprobe, d, nlist,
                                 cap, splits, k, s);
  }
  if (d % 4 != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(q, probe, cells, valid, out_vals, out_idx, nq, nprobe, d, nlist, cap,
                       splits, k, s);
}

// The cell-major form's plan: for rows of d elements (bf16 where
// cells_bf16 is 1, else f32), k kept, nlist cells of cap slots and
// `entries` = nq * nprobe probe entries, returns the pairs a group scores
// at once (16 or 8), or 0 where the form does not take these arguments
// (k past 128, cap not a multiple of 4 up to 65,536, 2^30 entries or
// more, the block's shared memory past 227 KB); then the caller runs pw_ivf_scan.  Where it
// returns a group, it writes the scratch pw_ivf_scan_cells needs:
// scratch[0] f32 (and as many int32) list entries, scratch[1] int32
// tickets.
extern "C" int pw_ivf_scan_cells_plan(int d, int cells_bf16, int k, int nlist, int cap, long long entries,
                                      long long* scratch) {
  const int groups = cells_bf16 ? cm::plan_groups<__nv_bfloat16>(d, k, cap, entries)
                                : cm::plan_groups<float>(d, k, cap, entries);
  if (groups) {
    scratch[0] = entries * cm::kShares * k;
    scratch[1] = (long long)(nlist + 1) * cm::max_flushes((int)entries);
  }
  return groups;
}

// The cell-major form.  q: [nq, d] in the cells' type, rounded as the JAX
// program rounds it, rows 16-byte aligned; probe: [nq, nprobe] int32
// cells, 16-byte aligned; cells: [nlist, cap, d] f32 (cells_bf16 = 0) or
// bf16 (1); valid: [nlist, cap] f32, 16-byte aligned; lists_v/lists_i:
// f32/int32 scratch of pw_ivf_scan_cells_plan's scratch[0] entries (each
// share's lists, [nq * nprobe, kShares, k]); tickets: its scratch[1]
// int32 zeros ([nlist + 1, flushes]); out_vals/out_idx: [nq, nprobe, k]
// f32/int32, the best k of each (query, probed cell), best first, then
// the cell's first invalid slots as NEG_INF sentinels, then (-inf,
// 0x7fffffff) pads (also for probe entries outside [0, nlist)).  The
// arguments must have a plan.  Returns a cudaError_t.
extern "C" int pw_ivf_scan_cells(const void* q, const void* probe, const void* cells,
                                 const void* valid, void* lists_v, void* lists_i, void* tickets,
                                 void* out_vals, void* out_idx, int nq, int nprobe, int d, int nlist,
                                 int cap, int k, int cells_bf16, void* stream) {
  if (nq == 0 || nprobe == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cells_bf16 ? cm::launch<__nv_bfloat16>(q, probe, cells, valid, lists_v, lists_i, tickets, out_vals,
                                                out_idx, nq, nprobe, d, nlist, cap, k, s)
                    : cm::launch<float>(q, probe, cells, valid, lists_v, lists_i, tickets, out_vals, out_idx,
                                        nq, nprobe, d, nlist, cap, k, s);
}
