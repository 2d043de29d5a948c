// K13: exact top-k of each row of an f32 score array, for k above what
// K3's per-tile selection takes (knn_topk.MAX_K = 128).
//
// Replaces: jax.lax.top_k where k > 128 on the port's paths: the masked
//   top-k of _search_jit -> run (pathway_tpu/parallel/sharded_knn.py:
//   336-341) and of its mesh branch's global top_k (:357-364), the IVF's
//   probe top_k over the centroid scores and its top_k over the probed
//   cells (pathway_tpu/parallel/ivf_knn.py:321-332).  Order: higher score
//   first, lower position first on ties, as jax.lax.top_k orders them
//   (-0 ranks with +0, as the float comparison does).
//
// What bounds it on an H100: bytes.  Each score is read (4 bytes) and k
// winners written; 32 rows of 1,048,576 scores are 134 MB, 0.04 ms at
// 3.35 TB/s.  A radix select with 8-bit digits reads every row once per
// digit; this design reads the scores of the paths twice.
//
// What the design does about it: a radix select over the order-preserving
// uint32 key of each score (sign-flipped f32 bits; -0 ranks with +0) with
// 11-bit digits (bits 31-21, 20-10, 9-0), after AIR top-k (Zhang et al.,
// SC '23), in six launches on the caller's stream, each row cut into
// chunks so that a few rows still fill the card:
//  - pass 0 counts the top digit of every entry in a per-block shared
//    histogram added to the row's.  The last block of the row to finish (an
//    atomic ticket after __threadfence) chooses the digit where the count of
//    better entries reaches k, in the same launch.
//  - passes 1-3: a row whose chosen bin, with the winners above it, fits
//    the row's candidate buffer (4,096 slots, or the next power of two of k
//    or of n) reads the row once more: entries above the bin go to the
//    winners, entries in it to the candidates, and the row is finished:
//    one sort of winners and candidates, best first with ties to the lower
//    position, gives its top k.  The scores of the paths land there after
//    two reads: the k-th best's bin holds a few hundred to a few thousand
//    entries.  A bin too large for the buffer (an all-equal row, one
//    dominant value, a row of ascending positions) is refined instead, as an
//    8-bit radix select does: the next pass reads the row filtered by the
//    prefix, takes what lies above it and counts the next digit (its last
//    block choosing again), until the bin fits, holds exactly the entries
//    still needed (all taken), or the key is complete; then the exact ties
//    of the k-th key that are needed are the lowest positions (ties: each
//    chunk's ranks start after the ties counted in the chunks before it).
//    A pass skips the rows it has nothing to do for, so the passes no row
//    needs cost a launch each and read nothing.
//  - sort: the k winners (or winners and candidates) of each row, bitonic,
//    in shared memory up to 4,096 slots, else in place in the scratch;
//    written with their ids: `ids[pos]` when an id array is given (a
//    reduction of candidate lists), else `pos + offset` (a row of slot
//    scores).
// Why this design: choosing the digit in the last block of a pass saves a
// launch per digit, and sorting the k-th best's bin with the winners
// saves the later digits' passes; an 8-bit radix select that chooses each
// digit in a launch of its own takes twelve launches and six reads.
// Loads are 16-byte vectors when the rows allow, four in flight a thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using pw::bitonic_sort;
using pw::kPadIdx;

constexpr int kThreads = 256;  // pass and ties blocks
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kBins = 2048;  // 11-bit digits
constexpr int kSortThreads = 1024;
constexpr int kSmemSort = 4096;  // slots sorted in shared memory up to this many
constexpr int kLevels = 3;
__constant__ int kShift[kLevels] = {21, 10, 0};
__constant__ unsigned kDigitMask[kLevels] = {0x7ffu, 0x7ffu, 0x3ffu};

// What a pass does for a row (RowState::mode after `level` digits).
enum Mode : int {
  kSearch = 0,  // no digit chosen yet (pass 0)
  kCand,        // above the prefix: winners; equal to it: candidates
  kTakeAll,     // above or equal to the prefix: winners
  kRefine,      // above: winners; equal: counted by the next digit
  kTies,        // the key is complete: above: winners; equal: ties to rank
};

// Per-row state of the select in the caller's int32 scratch (16 ints),
// zeroed by the launch function before pass 0.
struct RowState {
  unsigned prefix;  // the digits chosen so far
  unsigned mask;    // the bits they cover
  unsigned prev_prefix, prev_mask;  // the same one digit earlier
  int level;        // digits chosen
  int mode;
  int need;         // entries equal to the prefix still to take
  int ties;         // entries equal to the prefix
  int n_win;        // winner slots claimed
  int n_cand;       // candidate slots claimed
  int ticket;       // blocks of the current pass that have finished
  int pad[5];
};
constexpr int kStateInts = sizeof(RowState) / 4;
static_assert(kStateInts == 16, "RowState is 16 ints");

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

// The last block of a row's pass: choose the digit at level s.level from
// the row's histogram, set the row's next mode, and leave the histogram and
// the ticket at zero for the next pass.  `s` is the row's state as the pass
// found it; only the fields that no other block changes are written (the
// slot counters stay as their atomics left them).  Every thread of the
// block calls it.
__device__ void choose_digit(int* __restrict__ hist, RowState* __restrict__ st, const RowState& s,
                             int k, int slots) {
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int need = s.level ? s.need : k;
  // thread tid holds bins 2047 - 8 tid - j, j = 0..7: a scan from the top
  int c[8];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = __ldcg(hist + kBins - 1 - 8 * tid - j);
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int acc = incl - sum;  // entries in the bins above this thread's
  for (int w = 0; w < warp; ++w) acc += warp_sum[w];
  if (acc < need && need <= acc + sum) {
    for (int j = 0; j < 8; ++j) {
      if (acc + c[j] >= need) {
        const unsigned digit = kBins - 1 - 8 * tid - j;
        const int level = s.level + 1;
        const int left = need - acc;  // entries of the bin still to take
        st->prev_prefix = s.prefix;
        st->prev_mask = s.mask;
        st->prefix = s.prefix | (digit << kShift[s.level]);
        st->mask = s.mask | (kDigitMask[s.level] << kShift[s.level]);
        st->level = level;
        st->need = left;
        st->ties = c[j];
        // k - left winners lie above the new prefix, over all passes
        st->mode = k - left + c[j] <= slots ? kCand
                   : c[j] == left           ? kTakeAll
                   : level < kLevels        ? kRefine
                                            : kTies;
        st->ticket = 0;
        break;
      }
      acc += c[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) hist[kBins - 1 - 8 * tid - j] = 0;
}

// Pass `pass` over each row's chunks: the top digit's histogram (pass 0), or
// what the row's mode says for the rows with `pass` digits chosen.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const float* __restrict__ vals, int n, int chunk, int k, int slots, int pass,
            int* __restrict__ hist, RowState* __restrict__ st, float* __restrict__ cand_v,
            int* __restrict__ cand_p, int* __restrict__ chunk_ties) {
  const int row = blockIdx.y;
  RowState* rs = st + row;
  const RowState s = *rs;
  if (s.level != pass) return;
  const int mode = s.mode;
  const bool counting = mode == kSearch || mode == kRefine;
  __shared__ int sh[kBins];
  __shared__ int block_ties;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid % 32;
  if (counting)
    for (int b = tid; b < kBins; b += kThreads) sh[b] = 0;
  if (tid == 0) block_ties = 0;
  __syncthreads();
  const int shift = counting ? kShift[pass] : 0;
  const unsigned dmask = counting ? kDigitMask[pass] : 0u;
  const float* v = vals + (size_t)row * n;
  float* cv = cand_v + (size_t)row * slots;
  int* cp = cand_p + (size_t)row * slots;
  const int cand0 = k - s.need;  // candidates follow every winner above the prefix
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
        const unsigned key = order_key(x[u][e]);
        if (mode == kSearch) {
          if (i < hi) atomicAdd(&sh[(key >> shift) & dmask], 1);
          continue;
        }
        const bool in = i < hi && (key & s.prev_mask) == s.prev_prefix;
        const bool above = in && (key & s.mask) > s.prefix;
        const bool equal = in && (key & s.mask) == s.prefix;
        const bool win = above || (equal && mode == kTakeAll);
        const int pw = warp_claim(&rs->n_win, win, lane);
        if (win) {
          cv[pw] = x[u][e];
          cp[pw] = i;
        }
        if (mode == kCand) {
          const int pc = warp_claim(&rs->n_cand, equal, lane);
          if (equal) {
            cv[cand0 + pc] = x[u][e];
            cp[cand0 + pc] = i;
          }
        } else if (mode == kRefine) {
          if (equal) atomicAdd(&sh[(key >> shift) & dmask], 1);
        } else if (mode == kTies) {
          ties += equal;
        }
      }
    }
  }
  if (mode == kTies) {
    atomicAdd(&block_ties, ties);
    __syncthreads();
    if (tid == 0) chunk_ties[row * gridDim.x + blockIdx.x] = block_ties;
    return;
  }
  if (!counting) return;
  __syncthreads();
  int* h = hist + (size_t)row * kBins;
  for (int b = tid; b < kBins; b += kThreads)
    if (sh[b]) atomicAdd(&h[b], sh[b]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&rs->ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  choose_digit(h, rs, s, k, slots);
}

// Rows whose key is complete with more exact ties than entries needed: the
// lowest positions, each chunk's ranks starting after the ties of the
// chunks before it.
__global__ void __launch_bounds__(kThreads)
ties_kernel(const float* __restrict__ vals, int n, int chunk, int k, int slots,
            const RowState* __restrict__ st, float* __restrict__ cand_v,
            int* __restrict__ cand_p, const int* __restrict__ chunk_ties) {
  const int row = blockIdx.y;
  const RowState s = st[row];
  if (s.level != kLevels || s.mode != kTies) return;
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
  const int n_above = k - s.need;
  const float* v = vals + (size_t)row * n;
  const int lo = blockIdx.x * chunk;
  const int hi = min(n, lo + chunk);
  for (int base = lo, it = 0; base < hi && taken < s.need; base += kThreads, it ^= 1) {
    const int i = base + tid;
    const float x = i < hi ? v[i] : 0.0f;
    const bool eq = i < hi && order_key(x) == s.prefix;
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
      cand_v[(size_t)row * slots + n_above + pe] = x;
      cand_p[(size_t)row * slots + n_above + pe] = i;
    }
    taken += w_tot[it];
  }
}

// Sort each row's winners (and candidates) best first and write the first k
// with their ids.
__global__ void __launch_bounds__(kSortThreads)
sort_kernel(const int32_t* __restrict__ ids, int n, int k, int slots, long long offset,
            const RowState* __restrict__ st, float* __restrict__ cand_v, int* __restrict__ cand_p,
            float* __restrict__ out_vals, int32_t* __restrict__ out_ids) {
  __shared__ float v_s[kSmemSort];
  __shared__ int p_s[kSmemSort];
  const int row = blockIdx.x;
  const RowState s = st[row];
  const int count = s.mode == kCand ? k - s.need + s.ties : k;
  int size = 1;
  while (size < count) size <<= 1;
  float* sv = cand_v + (size_t)row * slots;
  int* sp = cand_p + (size_t)row * slots;
  if (size <= kSmemSort) {
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      v_s[j] = sv[j];
      p_s[j] = sp[j];
    }
    sv = v_s;
    sp = p_s;
  }
  for (int j = count + threadIdx.x; j < size; j += blockDim.x) {
    sv[j] = -INFINITY;
    sp[j] = kPadIdx;
  }
  __syncthreads();
  bitonic_sort(sv, sp, size, 1);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int pos = sp[j];
    out_vals[(size_t)row * k + j] = sv[j];
    out_ids[(size_t)row * k + j] = ids ? ids[(size_t)row * n + pos] : (int32_t)(pos + offset);
  }
}

template <int kVec>
void launch_select(const float* vals, const int32_t* ids, float* out_vals, int32_t* out_ids,
                   int* hist, RowState* st, int* chunk_ties, float* cand_v, int* cand_p, int nq,
                   int n, int k, int slots, int splits, int chunk, long long offset,
                   cudaStream_t s) {
  const dim3 grid(splits, nq);
  for (int pass = 0; pass <= kLevels; ++pass)
    pass_kernel<kVec><<<grid, kThreads, 0, s>>>(vals, n, chunk, k, slots, pass, hist, st, cand_v,
                                                cand_p, chunk_ties);
  ties_kernel<<<grid, kThreads, 0, s>>>(vals, n, chunk, k, slots, st, cand_v, cand_p, chunk_ties);
  sort_kernel<<<nq, kSortThreads, 0, s>>>(ids, n, k, slots, offset, st, cand_v, cand_p, out_vals,
                                          out_ids);
}

}  // namespace

// Kernels one call of pw_topk_select launches: passes 0-3, ties, sort.
extern "C" int pw_topk_select_launches() { return kLevels + 3; }

// vals: [nq, n] f32 scores; ids: [nq, n] int32 or null; out_vals/out_ids:
// [nq, k] f32/int32, best first.  slots: the row's winner and candidate
// buffer, a power of two >= k; each row is cut into `splits` chunks of
// `chunk` entries (a multiple of 4).  scratch_i: int32 [nq * (2048 + 16 +
// slots + splits)], scratch_f: f32 [nq * slots]; the first nq * (2048 + 16)
// ints are zeroed here on the stream.  1 <= k <= n < 2^31 - 2^16, slots <=
// 2^30, nq <= 65,535.  Returns a cudaError_t.
extern "C" int pw_topk_select(const void* vals, const void* ids, void* out_vals, void* out_ids,
                              void* scratch_i, void* scratch_f, int nq, int n, int k, int slots,
                              int splits, int chunk, long long offset, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > n || slots < k || slots > (1 << 30) || (slots & (slots - 1)) != 0 ||
      splits < 1 || chunk < 1 || chunk % 4 != 0 || (long long)splits * chunk < n || nq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* hist = static_cast<int*>(scratch_i);
  RowState* st = reinterpret_cast<RowState*>(hist + (size_t)nq * kBins);
  int* cand_p = reinterpret_cast<int*>(st + nq);
  int* chunk_ties = cand_p + (size_t)nq * slots;
  float* cand_v = static_cast<float*>(scratch_f);
  cudaError_t err = cudaMemsetAsync(scratch_i, 0, (size_t)nq * (kBins + kStateInts) * 4, s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  if (vec) {
    launch_select<4>(static_cast<const float*>(vals), static_cast<const int32_t*>(ids),
                     static_cast<float*>(out_vals), static_cast<int32_t*>(out_ids), hist, st,
                     chunk_ties, cand_v, cand_p, nq, n, k, slots, splits, chunk, offset, s);
  } else {
    launch_select<1>(static_cast<const float*>(vals), static_cast<const int32_t*>(ids),
                     static_cast<float*>(out_vals), static_cast<int32_t*>(out_ids), hist, st,
                     chunk_ties, cand_v, cand_p, nq, n, k, slots, splits, chunk, offset, s);
  }
  return (int)cudaGetLastError();
}
