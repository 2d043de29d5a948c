// K13: exact top-k of each row of an f32 score array, for k above what
// K3's per-tile selection takes (knn_topk.MAX_K = 128).
//
// Replaces: jax.lax.top_k where k > 128 on the port's paths: the masked
//   top-k of _search_jit -> run (pathway_tpu/parallel/sharded_knn.py:
//   336-341) and of its mesh branch's global top_k (:357-364), the IVF's
//   probe top_k over the centroid scores and its top_k over the probed
//   cells (pathway_tpu/parallel/ivf_knn.py:321-332).  Order: higher score
//   first, lower position first on ties, as jax.lax.top_k orders them.
//
// What bounds it on an H100: bytes.  Each score is read (4 bytes) and k
// winners written; 32 rows of 1,048,576 scores are 134 MB, 0.04 ms at
// 3.35 TB/s.  A radix select reads the scores once per digit pass, so
// this design reads them five times (four passes and the collection).
//
// What the design does about it: a radix select over the order-preserving
// uint32 key of each score (sign-flipped f32 bits; -0 ranks with +0), as
// a chain of small launches on the caller's stream, each row cut into
// chunks so that even one row spreads over the card's SMs:
//  - per digit (8 bits, four passes): hist_kernel counts, over the
//    entries whose higher digits equal the row's prefix so far, each
//    digit in per-warp shared histograms (lanes with one digit add once,
//    after __match_any_sync) and adds them to the row's histogram;
//    choose_kernel (a warp per row) picks the digit where the count of
//    better entries reaches k, and marks the row done when that bin holds
//    exactly the entries still needed, which ends its later passes early;
//  - collect_kernel takes every entry whose masked key beats the prefix
//    and, when all of them are needed, the ones equal to it, each warp
//    claiming slots with one global atomic; where only some of the exact
//    ties are needed, ties_kernel takes the lowest positions, each chunk
//    starting after the ties counted in the chunks before it;
//  - sort_kernel sorts the k winners best first (bitonic, in shared
//    memory up to 4,096 slots, else in place in the scratch) and writes
//    them with their ids: `ids[pos]` when an id array is given (a
//    reduction of candidate lists), else `pos + offset` (a row of slot
//    scores).
// Loads are 16-byte vectors when the rows allow, four in flight a thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using pw::bitonic_sort;
using pw::kPadIdx;

constexpr int kThreads = 256;   // hist, collect and ties blocks
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kBins = 256;
constexpr int kSortThreads = 1024;
constexpr int kSmemSort = 4096;  // winners sorted in shared memory up to this many slots

// Per-row state of the select, in the caller's int32 scratch.
struct RowState {
  unsigned prefix;  // the digits chosen so far
  unsigned mask;    // the bits they cover
  int need;         // entries equal to the prefix still to take
  int done;         // the chosen bin held exactly `need` entries
  int ties;         // entries equal to the prefix
  int n_gt;         // slots claimed by entries above the prefix
  int n_eq;         // slots claimed by entries equal to it
  int pad;
};

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0 ranks with +0, as the float comparison does
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The kVec scores from position i on; with kVec == 4 the chunk bounds
// divide by 4, so a group is in range or out of it whole.
template <int kVec>
__device__ __forceinline__ void load_scores(const float* __restrict__ v, int i, int hi,
                                            float (&x)[kVec]) {
  if constexpr (kVec == 4) {
    if (i < hi) {
      const float4 t = *reinterpret_cast<const float4*>(v + i);
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    }
  } else {
    x[0] = i < hi ? v[i] : 0.0f;
  }
}

// Add the count of the warp's lanes with `take` set to `*count` (one
// atomic for the warp); returns this lane's slot.  Every lane calls it.
__device__ __forceinline__ int warp_claim(int* count, bool take, int lane) {
  const unsigned ballot = __ballot_sync(0xffffffffu, take);
  if (!ballot) return 0;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void init_kernel(int* __restrict__ hist, RowState* __restrict__ st, int k) {
  const int row = blockIdx.x;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) hist[row * kBins + b] = 0;
  if (threadIdx.x == 0) st[row] = RowState{0u, 0u, k, 0, 0, 0, 0, 0};
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ vals, int n, int chunk, int shift, int* __restrict__ hist,
            const RowState* __restrict__ st) {
  const int row = blockIdx.y;
  const RowState s = st[row];
  if (s.done) return;
  __shared__ int wh[kWarps][kBins];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int b = tid; b < kWarps * kBins; b += kThreads) (&wh[0][0])[b] = 0;
  __syncthreads();
  const float* v = vals + (size_t)row * n;
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  constexpr int kStep = kThreads * kVec * kUnroll;
  for (int base = lo; base < hi; base += kStep) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_scores<kVec>(v, base + (u * kThreads + tid) * kVec, hi, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = base + (u * kThreads + tid) * kVec + e;
        const unsigned key = order_key(x[u][e]);
        const bool in = i < hi && (key & s.mask) == s.prefix;
        const unsigned digit = (key >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(0xffffffffu, in ? digit : 0x100u + lane);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&wh[warp][digit], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int b = tid; b < kBins; b += kThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wh[w][b];
    if (sum) atomicAdd(&hist[row * kBins + b], sum);
  }
}

// One warp per row: lane l holds bins 255 - 8l - j, j = 0..7, a scan from
// the top bin down finds the digit; the row's bins are zeroed for the next
// pass.
__global__ void choose_kernel(int* __restrict__ hist, RowState* __restrict__ st, int shift) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  RowState s = st[row];
  if (s.done) return;
  int* h = hist + row * kBins;
  int c[8];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = h[255 - 8 * lane - j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  int acc = incl - sum;
  if (acc < s.need && s.need <= incl) {
    for (int j = 0; j < 8; ++j) {
      if (acc + c[j] >= s.need) {
        const unsigned digit = 255u - 8u * lane - j;
        s.need -= acc;
        s.prefix |= digit << shift;
        s.mask |= 0xffu << shift;
        s.done = c[j] == s.need;
        s.ties = c[j];
        st[row] = s;
        break;
      }
      acc += c[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) h[255 - 8 * lane - j] = 0;
}

// Entries above the prefix (any order), and those equal to it when all of
// them are needed; otherwise each chunk's count of ties, for ties_kernel.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
collect_kernel(const float* __restrict__ vals, int n, int chunk, int k, int kpow,
               RowState* __restrict__ st, float* __restrict__ cand_v, int* __restrict__ cand_p,
               int* __restrict__ chunk_ties) {
  const int row = blockIdx.y;
  const RowState s = st[row];
  const bool ordered = s.ties > s.need;
  const int n_gt = k - s.need;
  __shared__ int block_ties;
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) block_ties = 0;
  __syncthreads();
  const float* v = vals + (size_t)row * n;
  float* cv = cand_v + (size_t)row * kpow;
  int* cp = cand_p + (size_t)row * kpow;
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  constexpr int kStep = kThreads * kVec * kUnroll;
  int ties = 0;
  for (int base = lo; base < hi; base += kStep) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_scores<kVec>(v, base + (u * kThreads + tid) * kVec, hi, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = base + (u * kThreads + tid) * kVec + e;
        const unsigned key = order_key(x[u][e]) & s.mask;
        const bool gt = i < hi && key > s.prefix;
        const bool eq = i < hi && key == s.prefix;
        const int pg = warp_claim(&st[row].n_gt, gt, lane);
        if (gt) {
          cv[pg] = x[u][e];
          cp[pg] = i;
        }
        if (ordered) {
          ties += eq;
        } else {
          const int pe = warp_claim(&st[row].n_eq, eq, lane);
          if (eq) {
            cv[n_gt + pe] = x[u][e];
            cp[n_gt + pe] = i;
          }
        }
      }
    }
  }
  if (ordered) {
    atomicAdd(&block_ties, ties);
    __syncthreads();
    if (tid == 0) chunk_ties[row * gridDim.x + blockIdx.x] = block_ties;
  }
}

// Where only some of the exact ties are needed: the lowest positions,
// each chunk's ranks starting after the ties of the chunks before it.
__global__ void __launch_bounds__(kThreads)
ties_kernel(const float* __restrict__ vals, int n, int chunk, int k, int kpow,
            const RowState* __restrict__ st, float* __restrict__ cand_v,
            int* __restrict__ cand_p, const int* __restrict__ chunk_ties) {
  const int row = blockIdx.y;
  const RowState s = st[row];
  if (s.ties <= s.need) return;
  __shared__ int w_cnt[2][kWarps];
  __shared__ int w_tot[2];
  __shared__ int s_before;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) s_before = 0;
  __syncthreads();
  int before = 0;
  for (int b = tid; b < blockIdx.x; b += kThreads) before += chunk_ties[row * gridDim.x + b];
  atomicAdd(&s_before, before);
  __syncthreads();
  int taken = s_before;
  const int n_gt = k - s.need;
  const float* v = vals + (size_t)row * n;
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  for (int base = lo, it = 0; base < hi && taken < s.need; base += kThreads, it ^= 1) {
    const int i = base + tid;
    const float x = i < hi ? v[i] : 0.0f;
    const bool eq = i < hi && (order_key(x) & s.mask) == s.prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) w_cnt[it][warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int cnt = lane < kWarps ? w_cnt[it][lane] : 0;
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      if (lane < kWarps) w_cnt[it][lane] = incl - cnt;
      if (lane == 31) w_tot[it] = incl;
    }
    __syncthreads();
    const int pe = taken + w_cnt[it][warp] + __popc(ballot & ((1u << lane) - 1u));
    if (eq && pe < s.need) {
      cand_v[(size_t)row * kpow + n_gt + pe] = x;
      cand_p[(size_t)row * kpow + n_gt + pe] = i;
    }
    taken += w_tot[it];
  }
}

// Sort each row's k winners best first and write them with their ids.
__global__ void __launch_bounds__(kSortThreads)
sort_kernel(const int32_t* __restrict__ ids, int n, int k, int kpow, long long offset,
            float* __restrict__ cand_v, int* __restrict__ cand_p, float* __restrict__ out_vals,
            int32_t* __restrict__ out_ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  float* sv = cand_v + (size_t)row * kpow;
  int* sp = cand_p + (size_t)row * kpow;
  if (kpow <= kSmemSort) {
    float* v_s = reinterpret_cast<float*>(smem);
    int* p_s = reinterpret_cast<int*>(v_s + kpow);
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      v_s[j] = sv[j];
      p_s[j] = sp[j];
    }
    sv = v_s;
    sp = p_s;
  }
  for (int j = k + threadIdx.x; j < kpow; j += blockDim.x) {
    sv[j] = -INFINITY;
    sp[j] = kPadIdx;
  }
  __syncthreads();
  bitonic_sort(sv, sp, kpow, 1);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int pos = sp[j];
    out_vals[(size_t)row * k + j] = sv[j];
    out_ids[(size_t)row * k + j] = ids ? ids[(size_t)row * n + pos] : (int32_t)(pos + offset);
  }
}

template <int kVec>
void launch_select(const float* vals, const int32_t* ids, float* out_vals, int32_t* out_ids,
                   int* hist, RowState* st, int* chunk_ties, float* cand_v, int* cand_p, int nq,
                   int n, int k, int kpow, int splits, int chunk, long long offset,
                   cudaStream_t s) {
  init_kernel<<<nq, kBins, 0, s>>>(hist, st, k);
  const dim3 grid(splits, nq);
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist_kernel<kVec><<<grid, kThreads, 0, s>>>(vals, n, chunk, shift, hist, st);
    choose_kernel<<<nq, 32, 0, s>>>(hist, st, shift);
  }
  collect_kernel<kVec><<<grid, kThreads, 0, s>>>(vals, n, chunk, k, kpow, st, cand_v, cand_p,
                                                 chunk_ties);
  ties_kernel<<<grid, kThreads, 0, s>>>(vals, n, chunk, k, kpow, st, cand_v, cand_p, chunk_ties);
  const size_t smem = kpow <= kSmemSort ? (size_t)kpow * 8 : 0;
  sort_kernel<<<nq, kSortThreads, smem, s>>>(ids, n, k, kpow, offset, cand_v, cand_p, out_vals,
                                             out_ids);
}

}  // namespace

// Kernels one call of pw_topk_select launches: init, four hist + choose
// pairs, collect, ties, sort.
extern "C" int pw_topk_select_launches() { return 12; }

// vals: [nq, n] f32 scores; ids: [nq, n] int32 or null; out_vals/out_ids:
// [nq, k] f32/int32, best first; kpow: the power of two >= k; each row is
// cut into `splits` chunks of `chunk` entries (a multiple of 4);
// scratch_i: int32 [nq * (256 + 8 + kpow + splits)], scratch_f: f32
// [nq * kpow].  1 <= k <= n < 2^31, nq <= 65,535.  Returns a cudaError_t.
extern "C" int pw_topk_select(const void* vals, const void* ids, void* out_vals, void* out_ids,
                              void* scratch_i, void* scratch_f, int nq, int n, int k, int kpow,
                              int splits, int chunk, long long offset, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > n || kpow < k || (kpow & (kpow - 1)) != 0 || splits < 1 || chunk < 1 ||
      chunk % 4 != 0 || (long long)splits * chunk < n || nq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* hist = static_cast<int*>(scratch_i);
  RowState* st = reinterpret_cast<RowState*>(hist + (size_t)nq * kBins);
  int* cand_p = reinterpret_cast<int*>(st + nq);
  int* chunk_ties = cand_p + (size_t)nq * kpow;
  float* cand_v = static_cast<float*>(scratch_f);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (vec) {
    launch_select<4>(static_cast<const float*>(vals), static_cast<const int32_t*>(ids),
                     static_cast<float*>(out_vals), static_cast<int32_t*>(out_ids), hist, st,
                     chunk_ties, cand_v, cand_p, nq, n, k, kpow, splits, chunk, offset, s);
  } else {
    launch_select<1>(static_cast<const float*>(vals), static_cast<const int32_t*>(ids),
                     static_cast<float*>(out_vals), static_cast<int32_t*>(out_ids), hist, st,
                     chunk_ties, cand_v, cand_p, nq, n, k, kpow, splits, chunk, offset, s);
  }
  return (int)cudaGetLastError();
}
