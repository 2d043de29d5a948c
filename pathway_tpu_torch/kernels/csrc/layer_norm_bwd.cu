// K17: the backward of K5 (residual add + LayerNorm) and of K6's
// LayerNorm with the embedding gathers, f32.
//
// Replaces: the transpose XLA derives for the two nn.LayerNorm(x + a) of
//   EncoderBlock.__call__ (pathway_tpu/models/encoder.py:128-150) and for
//   Embeddings.__call__ (:152-176) under jax.value_and_grad in the
//   contrastive train step (__graft_entry__.py:117-131).  For a row s of H
//   values (s = x + r for K5; s = word[id] + position[l] (+ type[t]) for
//   K6), mean, rstd = 1 / sqrt(var + eps), xhat = (s - mean) * rstd and the
//   output's gradient dy:
//     g = dy * gamma;  ds = rstd * (g - mean(g) - xhat * mean(g * xhat));
//     dgamma = sum over rows of dy * xhat;  dbeta = sum over rows of dy.
//   K5: ds is the gradient of both x and r (dr = dx = ds).  K6: ds is
//   added into the rows of the word, position and type tables that the
//   row gathered (a row whose id is out of range gathered none: flax's
//   fill mode gives it no gradient, and its NaN row makes dgamma NaN).
//
// What bounds it on an H100: bytes.  K5 reads x, r and dy and writes ds:
// at the train step's [8192, 768] f32, 101 MB, 0.030 ms at 3.35 TB/s.  K6
// reads dy and the gathered rows and writes the dense gradient tables
// whole: at BGE-base's tables (30,522 + 512 + 2 rows of 768) 95 MB of them.
//
// What the design does about it.  Both forms are one cooperative launch
// of as many 256-thread blocks as the card holds at once (three an SM for
// K5 at 768 columns, two for K6): the rows' pass, then a grid-wide
// barrier, then dgamma and dbeta (and K6's split position rows) summed over
// the blocks' partial rows in block order, each block a share of the
// columns.  Every sum is taken in an order fixed by the shape and the
// card, so dgamma, dbeta, ds and d_position are the same bits on every
// call.  A warp takes a row: the statistics are recomputed from s in
// registers (row_ln.cuh's layout and two-pass arithmetic), so the forward
// saves nothing of its own; s's parts and dy are loaded together before
// the statistics, gamma is read from the block's copy in shared memory,
// and each warp adds its rows' dy * xhat and dy into its own dgamma and
// dbeta rows in shared memory (in registers they cost the occupancy that
// keeps the loads in flight).
//
// K6 first counts, for each word row, the in-range rows that gather it
// (a warp's equal ids add once), then zeroes the word rows that more than
// one row adds into, and after a second barrier walks the rows position
// by position: an item is the rows of one position (or of a share of the
// batch at that position, when the grid has more blocks than the sequence
// has positions).  The block sorts the item's rows by (type id, word id)
// in shared memory and its warps take them in sorted order, eight at a
// time; each warp stages its row's ds in shared memory, and the block then
// adds the eight in sorted order into running sums, each thread 4
// columns: the position's row (stored once per item, no atomic), the open
// word run and the open type run.  A run goes into its table row only when
// the id changes, and runs stay open across the block's items, so an id
// repeated by every row (CLS, PAD, all-ones ids, the one type) costs one
// 16-byte vector atomic row per block and item, not one per row: the cost
// does not grow with how often an id repeats.  A word row that one row
// gathers is stored, not added.  Between its rows, each block zeroes a
// slice of the word rows that no row gathers, so the table's zeroing
// streams while the rows' loads are in flight.  d_word and d_type are
// summed by atomics where rows share an id, in an order that varies from
// run to run; d_position, dgamma and dbeta are not.

#include <climits>
#include <cooperative_groups.h>

#include "row_ln.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = pw::kRowsPerBlock;
constexpr int kThreads = kWarps * 32;
// rows of one position an item of K6 sorts (one a thread)
constexpr int kItemRows = kThreads;
// the final sum of partial rows: kSumCols columns by kSumGroups row groups
constexpr int kSumCols = 8;
constexpr int kSumGroups = kThreads / kSumCols;
constexpr unsigned long long kNoKey = ~0ull;

// blocks an SM holds: K5's form three up to 768 columns (at most 85
// registers a thread), two beyond; K6's form (shared memory) two, and one
// beyond 768 columns
__host__ __device__ constexpr int min_blocks(int form, int vpt) {
  return form == 0 ? (vpt < 4 ? 3 : 2) : (vpt < 4 ? 2 : 1);
}

// floats of the block's partial sums: the warps' dgamma and dbeta rows
// [kWarps][2][h], later the final sum's kThreads
__host__ __device__ constexpr int red_floats(int h) { return kWarps * 2 * h > kThreads ? kWarps * 2 * h : kThreads; }

// kind: 0 = none (all zero), 1 = uint8, 2 = int16, 3 = int32, 4 = int64
__device__ __forceinline__ int64_t load_index(const void* p, int kind, size_t i) {
  switch (kind) {
    case 1: return static_cast<const uint8_t*>(p)[i];
    case 2: return static_cast<const int16_t*>(p)[i];
    case 3: return static_cast<const int32_t*>(p)[i];
    case 4: return static_cast<const int64_t*>(p)[i];
    default: return 0;
  }
}

__device__ __forceinline__ int64_t wrap_index(int64_t i, int n) {
  if (i < 0) i += n;
  return (i < 0 || i >= n) ? -1 : i;
}

// K6's gathers, the tables and the item plan.
struct Embed {
  const void* ids;
  int ids_kind;
  const void* types;
  int types_kind;
  const float* word;
  int vocab;
  const float* position;
  const float* type_table;
  int n_types;
  int batch;
  int seq_len;
  int n_pos;      // rows of the position table (and of d_position)
  int chunks;     // items a position is split into
  int item_rows;  // rows of an item (the last of a position may have fewer)
  float* d_word;
  float* d_position;
  float* d_type;
  float* pos_partial;  // [chunks * seq_len, h] when chunks > 1
  int* counts;         // [vocab], zero: the in-range rows that gather each word row
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One row's LayerNorm backward in a warp.  In: v = s (lane's vectors
// lane + 32 j, zero past nvec), d = dy.  Out: v = xhat, d = ds;
// dgamma += dy * xhat and dbeta += dy into the warp's rows acc_s [2][h]
// (each lane its own columns).
template <int VPT>
__device__ __forceinline__ void row_bwd(float (&v)[VPT][8], float (&d)[VPT][8], float* acc_s,
                                        const float* gamma_s, int lane, int nvec, int h, float eps) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[j][e];
  const float mean = pw::warp_sum(sum) / h;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (lane + 32 * j >= nvec) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = v[j][e] - mean;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(pw::warp_sum(sq) / h + eps);
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vec = lane + 32 * j;
    if (vec >= nvec) continue;
    const float4 g0 = reinterpret_cast<const float4*>(gamma_s)[2 * vec];
    const float4 g1 = reinterpret_cast<const float4*>(gamma_s)[2 * vec + 1];
    const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[j][e] = (v[j][e] - mean) * rstd;
    float4* a = reinterpret_cast<float4*>(acc_s + vec * 8);
    float4* b = reinterpret_cast<float4*>(acc_s + h + vec * 8);
    const float4 a0 = a[0], a1 = a[1], b0 = b[0], b1 = b[1];
    const float* x = v[j];
    const float* y = d[j];
    a[0] = make_float4(a0.x + y[0] * x[0], a0.y + y[1] * x[1], a0.z + y[2] * x[2], a0.w + y[3] * x[3]);
    a[1] = make_float4(a1.x + y[4] * x[4], a1.y + y[5] * x[5], a1.z + y[6] * x[6], a1.w + y[7] * x[7]);
    b[0] = make_float4(b0.x + y[0], b0.y + y[1], b0.z + y[2], b0.w + y[3]);
    b[1] = make_float4(b1.x + y[4], b1.y + y[5], b1.z + y[6], b1.w + y[7]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float g = d[j][e] * gm[e];
      d[j][e] = g;
      s1 += g;
      s2 += g * v[j][e];
    }
  }
  s1 = pw::warp_sum(s1) / h;
  s2 = pw::warp_sum(s2) / h;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) d[j][e] = rstd * (d[j][e] - s1 - v[j][e] * s2);
}

// The block's dgamma and dbeta, its warps' rows in red added in warp
// order, into partial[0][blockIdx.x] and partial[1][blockIdx.x].
__device__ __forceinline__ void block_partials(const float* red, float* partial, int h) {
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * h; c += kThreads) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += red[w * 2 * h + c];
    partial[((size_t)(c / h) * gridDim.x + blockIdx.x) * h + c % h] = t;
  }
  __syncthreads();
}

// After the grid barrier: out[c] = sum over the gridDim.x blocks of
// partial[blk][c] for the 2 h columns (dgamma then dbeta), each block
// kSumCols columns at a time; a column's sum over its kSumGroups row
// groups, then the groups in order.  red: red_floats(h) floats.
__device__ __forceinline__ void sum_block_partials(const float* partial, float* d_gamma, float* d_beta, int h,
                                                   float* red) {
  const int tc = threadIdx.x % kSumCols, tg = threadIdx.x / kSumCols;
  const int blocks = gridDim.x;
  const int groups = (2 * h + kSumCols - 1) / kSumCols;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int c = grp * kSumCols + tc;
    float s = 0.0f;
    if (c < 2 * h) {
      const float* p = partial + (size_t)(c / h) * blocks * h + c % h;
#pragma unroll 4
      for (int b = tg; b < blocks; b += kSumGroups) s += __ldcg(p + (size_t)b * h);
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (tg == 0 && c < 2 * h) {
      float t = 0.0f;
      for (int q = 0; q < kSumGroups; ++q) t += red[q * kSumCols + tc];
      (c < h ? d_gamma : d_beta)[c % h] = t;
    }
    __syncthreads();
  }
}

// ---- K5's backward --------------------------------------------------------

template <int VPT>
__global__ void __launch_bounds__(kThreads, min_blocks(0, VPT))
res_bwd_kernel(const float* __restrict__ x, const float* __restrict__ r, const float* __restrict__ dy,
               const float* __restrict__ gamma, float* __restrict__ dx, float* __restrict__ partial,
               float* __restrict__ d_gamma, float* __restrict__ d_beta, int m, int h, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* gamma_s = smem;    // [h]
  float* red = smem + h;    // red_floats(h)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = h / 8;
  for (int c = threadIdx.x; c < h; c += kThreads) gamma_s[c] = gamma[c];
  for (int c = threadIdx.x; c < red_floats(h); c += kThreads) red[c] = 0.0f;
  __syncthreads();
  for (int row = blockIdx.x * kWarps + warp; row < m; row += gridDim.x * kWarps) {
    float v[VPT][8], d[VPT][8];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vec = lane + 32 * j;
      if (vec < nvec) {
        const size_t at = (size_t)row * h + vec * 8;
        pw::load8(x + at, v[j]);
        pw::load8(dy + at, d[j]);
        if (r != nullptr) {
          float b[8];
          pw::load8(r + at, b);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[j][e] += b[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[j][e] = d[j][e] = 0.0f;
      }
    }
    row_bwd<VPT>(v, d, red + warp * 2 * h, gamma_s, lane, nvec, h, eps);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vec = lane + 32 * j;
      if (vec < nvec) pw::store8(dx + (size_t)row * h + vec * 8, d[j]);
    }
  }
  block_partials(red, partial, h);
  cg::this_grid().sync();
  sum_block_partials(partial, d_gamma, d_beta, h, red);
}

// ---- K6's backward --------------------------------------------------------

// Shared memory of emb_bwd_kernel, in floats: gamma [h], the position row
// [h], the warps' staged ds [kWarps][h], the reduction row red_floats(h),
// each thread's running sums (word run, type run, position row: float4
// [3][kThreads], kept out of registers while the warps walk rows); then
// the item's keys (u64) and sorted order (int).
__host__ __device__ constexpr size_t emb_smem_bytes(int h) {
  return ((size_t)(2 + kWarps) * h + red_floats(h) + 12 * kThreads) * sizeof(float) +
         kItemRows * (sizeof(unsigned long long) + sizeof(int));
}

// Zero the rows of d_word in [r0, r1) that `count_min` <= count <=
// `count_max` gather, a warp a row (streaming stores).
__device__ __forceinline__ void zero_word_rows(const Embed& emb, int r0, int r1, int count_min, int count_max,
                                               int h, int warp, int lane) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const int c = __ldcg(emb.counts + r);
    if (c < count_min || c > count_max) continue;
    float4* dst = reinterpret_cast<float4*>(emb.d_word + (size_t)r * h);
    for (int i = lane; i < h / 4; i += 32) __stcs(dst + i, zero);
  }
}

// A word run's sum into its row: a plain store where the run is the row's
// only row (count 1: nothing else writes it), else a vector atomic into the
// row zeroed before the rows' pass.
__device__ __forceinline__ void add_word_run(const Embed& emb, unsigned long long key, bool single, float4 run,
                                             int col4, int h) {
  float4* dst = reinterpret_cast<float4*>(emb.d_word + (key & 0xffffffffu) * h) + col4;
  if (single) {
    *dst = run;
  } else {
    atomicAdd(dst, run);
  }
}

template <int VPT>
__global__ void __launch_bounds__(kThreads, min_blocks(1, VPT))
emb_bwd_kernel(Embed emb, const float* __restrict__ dy, const float* __restrict__ gamma,
               float* __restrict__ partial, float* __restrict__ d_gamma, float* __restrict__ d_beta, int h,
               float eps) {
  extern __shared__ __align__(16) float smem[];
  float* gamma_s = smem;                      // [h]
  float* pos_row = smem + h;                  // [h]
  float* stage = smem + 2 * h;                // [kWarps][h]
  float* red = smem + (2 + kWarps) * h;       // red_floats(h)
  float4* sums = reinterpret_cast<float4*>(red + red_floats(h));             // [3][kThreads]
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(sums + 3 * kThreads);  // [kItemRows]
  int* order = reinterpret_cast<int*>(keys + kItemRows);                                 // [kItemRows]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = h / 8;
  const int L = emb.seq_len;
  const int n_items = L * emb.chunks;
  // the combining thread's 4 columns (h / 4 <= kThreads)
  const int col4 = threadIdx.x;
  const bool owns = col4 < h / 4;
  for (int c = threadIdx.x; c < h; c += kThreads) gamma_s[c] = gamma[c];
  for (int c = threadIdx.x; c < red_floats(h); c += kThreads) red[c] = 0.0f;
  // open runs (the same keys in every thread of the block); the sums in
  // sums[0] (word run), sums[1] (type run), sums[2] (position row)
  unsigned long long run_key = kNoKey;
  bool run_single = false;
  int run_type = -1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < 3; ++i) sums[i * kThreads + threadIdx.x] = zero;
  cg::grid_group grid = cg::this_grid();

  // 1. each word row's count of in-range rows; d_type and the position
  // rows past the sequence zeroed
  {
    const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x, step = (size_t)gridDim.x * kThreads;
    // a warp's equal ids add once (all-ones ids would otherwise queue
    // every row's add on one counter)
    const size_t m = (size_t)emb.batch * L;
    for (size_t i = tid; i - lane < m; i += step) {
      long long wi = -1;
      if (i < m) {
        wi = wrap_index(load_index(emb.ids, emb.ids_kind, i), emb.vocab);
        if (emb.type_table != nullptr && wrap_index(load_index(emb.types, emb.types_kind, i), emb.n_types) < 0)
          wi = -1;
      }
      const unsigned same = __match_any_sync(0xffffffffu, wi);
      if (wi >= 0 && lane == __ffs(same) - 1) atomicAdd(emb.counts + wi, __popc(same));
    }
    if (emb.type_table != nullptr)
      for (size_t i = tid; i < (size_t)emb.n_types * h; i += step) emb.d_type[i] = 0.0f;
    for (size_t i = (size_t)L * h + tid; i < (size_t)emb.n_pos * h; i += step) emb.d_position[i] = 0.0f;
  }
  grid.sync();
  // 2. the word rows more than one row adds into, zeroed (this block's
  // share of the table); the rows no row gathers are zeroed in step 3,
  // while the rows' loads are in flight
  const int share = (emb.vocab + gridDim.x - 1) / gridDim.x;
  const int z0 = min(emb.vocab, (int)blockIdx.x * share), z1 = min(emb.vocab, z0 + share);
  zero_word_rows(emb, z0, z1, 2, INT_MAX, h, warp, lane);
  grid.sync();
  // 3. the rows, position by position; a slice of the untouched rows
  // zeroed with each eight rows
  int waves = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int n = min(emb.item_rows, emb.batch - (item / L) * emb.item_rows);
    waves += (max(n, 0) + kWarps - 1) / kWarps;
  }
  const int slice = waves > 0 ? (z1 - z0 + waves - 1) / waves : 0;
  int wave = 0;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int l = item % L;
    const int b0 = (item / L) * emb.item_rows;
    const int n = min(emb.item_rows, emb.batch - b0);
    if (threadIdx.x < n) {
      const size_t row = (size_t)(b0 + threadIdx.x) * L + l;
      const int64_t wi = wrap_index(load_index(emb.ids, emb.ids_kind, row), emb.vocab);
      int64_t ti = 0;
      if (emb.type_table != nullptr) ti = wrap_index(load_index(emb.types, emb.types_kind, row), emb.n_types);
      keys[threadIdx.x] = (wi < 0 || ti < 0) ? kNoKey : ((unsigned long long)ti << 32) | (unsigned long long)wi;
    }
    for (int c = threadIdx.x; c < h; c += kThreads) pos_row[c] = __ldg(emb.position + (size_t)l * h + c);
    __syncthreads();
    // rank sort by (key, index): stable, the same order on every call
    if (threadIdx.x < n) {
      const unsigned long long key = keys[threadIdx.x];
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const unsigned long long kj = keys[j];
        rank += (kj < key) || (kj == key && j < (int)threadIdx.x);
      }
      order[rank] = threadIdx.x;
    }
    __syncthreads();
    for (int p0 = 0; p0 < n; p0 += kWarps) {
      // each warp one row of the sorted order: ds staged in shared memory
      const int p = p0 + warp;
      if (p < n) {
        const int t = order[p];
        const unsigned long long key = keys[t];
        const size_t row = (size_t)(b0 + t) * L + l;
        const bool ok = key != kNoKey;
        const float* wp = emb.word + (ok ? (size_t)(key & 0xffffffffu) * h : 0);
        const float* tp = emb.type_table != nullptr && ok ? emb.type_table + (size_t)(key >> 32) * h : nullptr;
        float v[VPT][8], d[VPT][8];
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int vec = lane + 32 * j;
          if (vec < nvec) {
            float a[8], b[8];
            pw::load_f32x8(wp + vec * 8, a);
            pw::load8(dy + row * h + vec * 8, d[j]);
            if (tp != nullptr) {
              pw::load_f32x8(tp + vec * 8, b);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) b[e] = 0.0f;
            }
            const float4 q0 = reinterpret_cast<const float4*>(pos_row)[2 * vec];
            const float4 q1 = reinterpret_cast<const float4*>(pos_row)[2 * vec + 1];
            const float q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
            // as the forward summed them: word + position, then + type
#pragma unroll
            for (int e = 0; e < 8; ++e) v[j][e] = ok ? a[e] + q[e] + b[e] : __int_as_float(0x7fc00000);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[j][e] = d[j][e] = 0.0f;
          }
        }
        row_bwd<VPT>(v, d, red + warp * 2 * h, gamma_s, lane, nvec, h, eps);
        if (ok) {
#pragma unroll
          for (int j = 0; j < VPT; ++j) {
            const int vec = lane + 32 * j;
            if (vec < nvec) pw::store8(stage + warp * h + vec * 8, d[j]);
          }
        }
      }
      zero_word_rows(emb, min(z1, z0 + wave * slice), min(z1, z0 + (wave + 1) * slice), 0, 0, h, warp, lane);
      ++wave;
      __syncthreads();
      // the block adds the staged rows in sorted order; out-of-range rows
      // sort last and add nothing
      const int nw = min(kWarps, n - p0);
      float4 run = sums[col4], trun = sums[kThreads + col4], pos = sums[2 * kThreads + col4];
      for (int w = 0; w < nw; ++w) {
        const unsigned long long key = keys[order[p0 + w]];
        if (key == kNoKey) break;
        if (key != run_key) {
          if (run_key != kNoKey && owns) add_word_run(emb, run_key, run_single, run, col4, h);
          run_key = key;
          run_single = __ldcg(emb.counts + (key & 0xffffffffu)) == 1;
          run = zero;
          const int ti = (int)(key >> 32);
          if (emb.type_table != nullptr && ti != run_type) {
            if (run_type >= 0 && owns)
              atomicAdd(reinterpret_cast<float4*>(emb.d_type + (size_t)run_type * h) + col4, trun);
            run_type = ti;
            trun = zero;
          }
        }
        if (owns) {
          const float4 s = reinterpret_cast<const float4*>(stage + w * h)[col4];
          run = add4(run, s);
          trun = add4(trun, s);
          pos = add4(pos, s);
        }
      }
      sums[col4] = run;
      sums[kThreads + col4] = trun;
      sums[2 * kThreads + col4] = pos;
      __syncthreads();
    }
    // the position's row: whole, or this item's share of it
    if (owns) {
      float* dst = emb.chunks == 1 ? emb.d_position + (size_t)l * h : emb.pos_partial + (size_t)item * h;
      reinterpret_cast<float4*>(dst)[col4] = sums[2 * kThreads + col4];
    }
    sums[2 * kThreads + col4] = zero;
  }
  if (owns && run_key != kNoKey) add_word_run(emb, run_key, run_single, sums[col4], col4, h);
  zero_word_rows(emb, min(z1, z0 + waves * slice), z1, 0, 0, h, warp, lane);
  if (owns && run_type >= 0)
    atomicAdd(reinterpret_cast<float4*>(emb.d_type + (size_t)run_type * h) + col4, sums[kThreads + col4]);
  block_partials(red, partial, h);
  grid.sync();
  sum_block_partials(partial, d_gamma, d_beta, h, red);
  if (emb.chunks > 1) {
    // a split position's row: its items' shares in order
    const size_t total = (size_t)L * h;
    for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total; i += (size_t)gridDim.x * kThreads) {
      float s = 0.0f;
      for (int c = 0; c < emb.chunks; ++c) s += __ldcg(emb.pos_partial + (size_t)c * total + i);
      emb.d_position[i] = s;
    }
  }
}

// ---- launch ---------------------------------------------------------------

template <int VPT>
const void* kernel_of(int form) {
  return form == 0 ? reinterpret_cast<const void*>(&res_bwd_kernel<VPT>)
                   : reinterpret_cast<const void*>(&emb_bwd_kernel<VPT>);
}

const void* kernel_for(int form, int h) {
  switch ((h / 8 + 31) / 32) {
    case 1: return kernel_of<1>(form);
    case 2: return kernel_of<2>(form);
    case 3: return kernel_of<3>(form);
    default: return kernel_of<4>(form);
  }
}

size_t smem_for(int form, int h) {
  return form == 0 ? (size_t)(h + red_floats(h)) * sizeof(float) : emb_smem_bytes(h);
}

bool bad_width(int h) { return h % 8 != 0 || h <= 0 || h > 32 * 8 * pw::kMaxVpt; }

// the kernel of `form` at width h, allowed its shared memory past 48 KB
int prepare(int form, int h) {
  const size_t smem = smem_for(form, h);
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel_for(form, h), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int cooperative(int form, int h, int blocks, void** args, cudaStream_t stream) {
  if (bad_width(h) || blocks < 1) return (int)cudaErrorInvalidValue;
  int err = prepare(form, h);
  if (!err)
    err = (int)cudaLaunchCooperativeKernel(kernel_for(form, h), dim3(blocks), dim3(kThreads), args,
                                           smem_for(form, h), stream);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// The most blocks of `form` (0: K5's backward, 1: K6's) at width h that
// the current card holds at once: the largest grid a call may launch.
// Returns a negative cudaError_t on failure.
extern "C" int pw_layer_norm_bwd_grid(int form, int h) {
  if (bad_width(h) || (form != 0 && form != 1)) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = prepare(form, h);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(form, h), kThreads,
                                                             smem_for(form, h));
  return err ? -err : sms * per_sm;
}

// K5's backward.  x, r (r may be null), dy, dx: [m, h] f32; gamma: [h] f32;
// partial: [2, blocks, h] f32 scratch; d_gamma, d_beta: [h] f32.  h % 8 ==
// 0, h <= 1024, pointers 16-byte aligned; blocks at most
// pw_layer_norm_bwd_grid(0, h).  One cooperative launch.  Returns a
// cudaError_t.
extern "C" int pw_layer_norm_bwd(const void* x, const void* r, const void* dy, const void* gamma, void* dx,
                                 void* partial, void* d_gamma, void* d_beta, int m, int h, float eps, int blocks,
                                 void* stream) {
  if (m == 0) return 0;
  if (x == nullptr || dx == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &r, &dy, &gamma, &dx, &partial, &d_gamma, &d_beta, &m, &h, &eps};
  return cooperative(0, h, blocks, args, static_cast<cudaStream_t>(stream));
}

// K6's backward.  ids, types: [batch, seq_len] of the given kinds (types
// may be null: all zero); word [vocab, h], position [>= seq_len, h] (from
// the block's first position), type_table [n_types, h] or null: f32, as K6
// read them (position: n_pos rows); d_word, d_position, d_type: their
// gradients, f32, written whole (d_type null with type_table);
// pos_partial: [chunks * seq_len, h] f32 scratch when chunks > 1; counts:
// [vocab] int32, zero; items of item_rows rows (chunks of them a
// position, covering the batch); dy: [batch * seq_len, h] f32; gamma,
// partial, d_gamma, d_beta, blocks as above (form 1).  One cooperative
// launch.  Returns a cudaError_t.
extern "C" int pw_embed_ln_bwd(const void* ids, int ids_kind, const void* types, int types_kind, const void* word,
                               int vocab, const void* position, int n_pos, const void* type_table, int n_types,
                               int batch, int seq_len, int chunks, int item_rows, void* d_word, void* d_position,
                               void* d_type, void* pos_partial, void* counts, const void* dy, const void* gamma,
                               void* partial, void* d_gamma, void* d_beta, int h, float eps, int blocks,
                               void* stream) {
  if (batch == 0 || seq_len == 0) return 0;
  if (seq_len < 1 || n_pos < seq_len || (type_table != nullptr && d_type == nullptr) || chunks < 1 ||
      item_rows < 1 || item_rows > kItemRows || (long long)chunks * item_rows < batch ||
      (chunks > 1 && pos_partial == nullptr) || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  Embed emb{ids, ids_kind, types, types == nullptr ? 0 : types_kind, static_cast<const float*>(word), vocab,
            static_cast<const float*>(position), static_cast<const float*>(type_table), n_types, batch, seq_len,
            n_pos, chunks, item_rows, static_cast<float*>(d_word), static_cast<float*>(d_position),
            static_cast<float*>(d_type), static_cast<float*>(pos_partial), static_cast<int*>(counts)};
  void* args[] = {&emb, &dy, &gamma, &partial, &d_gamma, &d_beta, &h, &eps};
  return cooperative(1, h, blocks, args, static_cast<cudaStream_t>(stream));
}
