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
//   fill mode gives it no gradient).
//
// What bounds it on an H100: bytes.  Per row it reads s's parts and dy
// and writes ds (or adds into the tables): at the train step's [8192, 768]
// f32, 75 MB for K5, 0.022 ms at 3.35 TB/s; K6's adds are 25 MB of
// atomics into three tables.
//
// What the design does about it: the forward's statistics are recomputed
// from s in registers (one warp a row, row_ln.cuh's layout and two-pass
// arithmetic), so the forward saves nothing of its own: K5's autograd
// Function keeps its inputs x and r, K6's the ids and tables.  A block of 8
// warps walks rows; each lane keeps its columns' dgamma and dbeta partials
// in registers over the rows it walks, the block's warps add theirs in
// order into one shared row, and the block writes one partial row each.
// A second launch sums the blocks' partial rows in order (one thread a
// column): dgamma and dbeta are deterministic, summed in another order
// than torch's, held at 1e-5 of the largest |value|.  K6's table adds are
// f32 atomics, in an order that varies from run to run (a word row shared
// by many tokens, the position rows by the batch, the type row by all).

#include "row_ln.cuh"

namespace {

constexpr int kWarps = pw::kRowsPerBlock;

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

// K6's gathers: the tables and the row's ids.
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
  int seq_len;
  float* d_word;
  float* d_position;
  float* d_type;
};

template <int VPT>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ r, Embed emb, const float* __restrict__ dy,
              const float* __restrict__ gamma, float* __restrict__ dx, float* __restrict__ partial, int m, int h,
              float eps) {
  extern __shared__ __align__(16) float red[];  // [2][h]: dgamma, dbeta
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = h / 8;
  float acc_g[VPT][8], acc_b[VPT][8];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_g[j][e] = acc_b[j][e] = 0.0f;

  for (int row = blockIdx.x * kWarps + warp; row < m; row += gridDim.x * kWarps) {
    // s, as the forward made it
    float v[VPT][8];
    int64_t wi = 0, ti = -1;
    bool nan_row = false;
    const float *wp = nullptr, *pp = nullptr, *tp = nullptr;
    if (x == nullptr) {
      wi = wrap_index(load_index(emb.ids, emb.ids_kind, row), emb.vocab);
      nan_row = wi < 0;
      wp = emb.word + (nan_row ? 0 : wi) * h;
      pp = emb.position + (size_t)(row % emb.seq_len) * h;
      if (emb.type_table != nullptr) {
        ti = wrap_index(load_index(emb.types, emb.types_kind, row), emb.n_types);
        nan_row |= ti < 0;
        tp = emb.type_table + (ti < 0 ? 0 : ti) * h;
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vec = lane + 32 * j;
      if (vec < nvec) {
        float a[8], b[8];
        if (x != nullptr) {
          pw::load8(x + (size_t)row * h + vec * 8, a);
          if (r != nullptr) {
            pw::load8(r + (size_t)row * h + vec * 8, b);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) b[e] = 0.0f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) v[j][e] = a[e] + b[e];
        } else {
          pw::load_f32x8(wp + vec * 8, a);
          pw::load_f32x8(pp + vec * 8, b);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[j][e] = a[e] + b[e];
          if (tp != nullptr) {
            pw::load_f32x8(tp + vec * 8, a);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[j][e] += a[e];
          }
        }
        if (nan_row) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[j][e] = __int_as_float(0x7fc00000);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[j][e] = 0.0f;
      }
    }
    // the statistics, as warp_layer_norm takes them
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
        const float d = v[j][e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(pw::warp_sum(sq) / h + eps);
    // xhat in v; g = dy * gamma in gy
    float gy[VPT][8], dyv[VPT][8];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vec = lane + 32 * j;
      if (vec < nvec) {
        float gm[8];
        pw::load8(dy + (size_t)row * h + vec * 8, dyv[j]);
        pw::load_f32x8(gamma + vec * 8, gm);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[j][e] = (v[j][e] - mean) * rstd;
          gy[j][e] = dyv[j][e] * gm[e];
          s1 += gy[j][e];
          s2 += gy[j][e] * v[j][e];
          acc_g[j][e] += dyv[j][e] * v[j][e];
          acc_b[j][e] += dyv[j][e];
        }
      }
    }
    s1 = pw::warp_sum(s1) / h;
    s2 = pw::warp_sum(s2) / h;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vec = lane + 32 * j;
      if (vec >= nvec) continue;
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = rstd * (gy[j][e] - s1 - v[j][e] * s2);
      if (x != nullptr) {
        pw::store8(dx + (size_t)row * h + vec * 8, d);
      } else if (!nan_row) {
        float* dw = emb.d_word + wi * h + vec * 8;
        float* dp = emb.d_position + (size_t)(row % emb.seq_len) * h + vec * 8;
        float* dt = ti >= 0 ? emb.d_type + ti * h + vec * 8 : nullptr;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          atomicAdd(dw + e, d[e]);
          atomicAdd(dp + e, d[e]);
          if (dt != nullptr) atomicAdd(dt + e, d[e]);
        }
      }
    }
  }
  // the block's dgamma and dbeta: its warps' partials added in order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int vec = lane + 32 * j;
        if (vec >= nvec) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = vec * 8 + e;
          red[c] = w == 0 ? acc_g[j][e] : red[c] + acc_g[j][e];
          red[h + c] = w == 0 ? acc_b[j][e] : red[h + c] + acc_b[j][e];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < h; c += kWarps * 32) {
    partial[(size_t)blockIdx.x * h + c] = red[c];
    partial[((size_t)gridDim.x + blockIdx.x) * h + c] = red[h + c];
  }
}

// out[c] = sum over the blocks of partial[blk][c], for 2 * h columns
// (dgamma then dbeta), in block order.
__global__ void colsum_kernel(const float* __restrict__ partial, float* __restrict__ d_gamma,
                              float* __restrict__ d_beta, int blocks, int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * h) return;
  const int which = c / h;
  const int col = c % h;
  const float* p = partial + (size_t)which * blocks * h + col;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += p[(size_t)b * h];
  (which ? d_beta : d_gamma)[col] = s;
}

template <int VPT>
int launch(const float* x, const float* r, const Embed& emb, const float* dy, const float* gamma, float* dx,
           float* partial, float* d_gamma, float* d_beta, int m, int h, float eps, int blocks,
           cudaStream_t stream) {
  const int bytes = 2 * h * 4;  // at most 8 KB
  ln_bwd_kernel<VPT><<<blocks, kWarps * 32, bytes, stream>>>(x, r, emb, dy, gamma, dx, partial, m, h, eps);
  const int e2 = (int)cudaGetLastError();
  if (e2) return e2;
  colsum_kernel<<<(2 * h + 255) / 256, 256, 0, stream>>>(partial, d_gamma, d_beta, blocks, h);
  return (int)cudaGetLastError();
}

int dispatch(const float* x, const float* r, const Embed& emb, const float* dy, const float* gamma, float* dx,
             float* partial, float* d_gamma, float* d_beta, int m, int h, float eps, int blocks,
             cudaStream_t s) {
  if (m == 0) return 0;
  if (h % 8 != 0 || h <= 0 || h > 32 * 8 * pw::kMaxVpt || blocks < 1) return (int)cudaErrorInvalidValue;
  switch ((h / 8 + 31) / 32) {
    case 1: return launch<1>(x, r, emb, dy, gamma, dx, partial, d_gamma, d_beta, m, h, eps, blocks, s);
    case 2: return launch<2>(x, r, emb, dy, gamma, dx, partial, d_gamma, d_beta, m, h, eps, blocks, s);
    case 3: return launch<3>(x, r, emb, dy, gamma, dx, partial, d_gamma, d_beta, m, h, eps, blocks, s);
    default: return launch<4>(x, r, emb, dy, gamma, dx, partial, d_gamma, d_beta, m, h, eps, blocks, s);
  }
}

}  // namespace

// K5's backward.  x, r (r may be null), dy, dx: [m, h] f32; gamma: [h] f32;
// partial: [2, blocks, h] f32 scratch; d_gamma, d_beta: [h] f32.  h % 8 ==
// 0, h <= 1024, pointers 16-byte aligned.  Two launches.  Returns a
// cudaError_t.
extern "C" int pw_layer_norm_bwd(const void* x, const void* r, const void* dy, const void* gamma, void* dx,
                                 void* partial, void* d_gamma, void* d_beta, int m, int h, float eps, int blocks,
                                 void* stream) {
  if (x == nullptr || dx == nullptr) return (int)cudaErrorInvalidValue;
  const Embed none{};
  return dispatch(static_cast<const float*>(x), static_cast<const float*>(r), none, static_cast<const float*>(dy),
                  static_cast<const float*>(gamma), static_cast<float*>(dx), static_cast<float*>(partial),
                  static_cast<float*>(d_gamma), static_cast<float*>(d_beta), m, h, eps, blocks,
                  static_cast<cudaStream_t>(stream));
}

// K6's backward.  ids, types: [b, l] of the given kinds (types may be
// null: all zero); word [vocab, h], position [>= l, h] (from the block's
// first position), type_table [n_types, h] or null: f32, as K6 read them;
// d_word, d_position, d_type: their gradients, f32, zeroed by the caller
// and added into (d_type null with type_table); dy: [b * l, h] f32;
// gamma, partial, d_gamma, d_beta as above.  Two launches.  Returns a
// cudaError_t.
extern "C" int pw_embed_ln_bwd(const void* ids, int ids_kind, const void* types, int types_kind, const void* word,
                               int vocab, const void* position, const void* type_table, int n_types, int seq_len,
                               void* d_word, void* d_position, void* d_type, const void* dy, const void* gamma,
                               void* partial, void* d_gamma, void* d_beta, int m, int h, float eps, int blocks,
                               void* stream) {
  if (seq_len < 1 || (type_table != nullptr && d_type == nullptr)) return (int)cudaErrorInvalidValue;
  const Embed emb{ids, ids_kind, types, types == nullptr ? 0 : types_kind, static_cast<const float*>(word), vocab,
                  static_cast<const float*>(position), static_cast<const float*>(type_table), n_types, seq_len,
                  static_cast<float*>(d_word), static_cast<float*>(d_position), static_cast<float*>(d_type)};
  return dispatch(nullptr, nullptr, emb, static_cast<const float*>(dy), static_cast<const float*>(gamma), nullptr,
                  static_cast<float*>(partial), static_cast<float*>(d_gamma), static_cast<float*>(d_beta), m, h,
                  eps, blocks, static_cast<cudaStream_t>(stream));
}
