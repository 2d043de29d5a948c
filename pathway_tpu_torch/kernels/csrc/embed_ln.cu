// K6: fused embedding gather + sum + LayerNorm (f32 tables in, bf16 out,
// or f32 out for the f32 configs).
//
// Replaces: Embeddings.__call__ in pathway_tpu/models/encoder.py:152-176,
//   in flax's order: each table is cast to the activation type T before
//   its gather (nn.Embed(dtype=T)), e = T(word[id] + position[l]), then
//   e = T(e + type[t]) when the config has a type vocabulary, then
//   LayerNorm as in K5 with no residual.  In f32 the roundings are the
//   identity.  Eager torch runs that as three
//   gathers, three casts, two adds and the LayerNorm with its own casts.
//
// What bounds it on an H100: bytes.  It must read each distinct word row,
// the L position rows and the type rows once (H * 4 bytes each, f32), the
// ids, and write B * L * H * 2 bytes.  At B = 256, L = 256, H = 768 the
// output alone is 101 MB, 30 us at 3.35 TB/s; the tables' rows are at most
// a few MB more and mostly hit L2 on repeats.
//
// What the design does about it: one warp per token, as in K5.  Each lane
// reads its id (int16, int32 or int64, as uploaded: no widening copy) and
// type id, gathers its 16-byte vectors of the three rows straight from
// the f32 tables with 32-byte loads, rounds as flax does, and normalises
// in registers (row_ln.cuh); the row is written once.  Word and type ids
// out of range follow flax nn.Embed (jnp.take with mode="fill"): an id
// in [-n, 0) wraps to n + id, and an id >= n or < -n gives a NaN row,
// which LayerNorm turns into a NaN output row.  Position ids are always
// in range.

#include "row_ln.cuh"

namespace {

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

// The table row of id i, or -1 where flax's gather fills NaN.
__device__ __forceinline__ int64_t wrap_index(int64_t i, int n) {
  if (i < 0) i += n;
  return (i < 0 || i >= n) ? -1 : i;
}

template <int VPT, typename T>
__global__ void __launch_bounds__(pw::kRowsPerBlock * 32)
embed_ln_kernel(const void* __restrict__ ids, int ids_kind, const void* __restrict__ types,
                int types_kind, const float* __restrict__ word, int vocab,
                const float* __restrict__ position, const float* __restrict__ type_table,
                int n_types, const float* __restrict__ scale, const float* __restrict__ bias,
                T* __restrict__ out, int rows, int seq_len, int h, float eps) {
  const int row = blockIdx.x * pw::kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int nvec = h / 8;
  const int64_t wi = wrap_index(load_index(ids, ids_kind, row), vocab);
  bool nan_row = wi < 0;
  const float* w = word + (nan_row ? 0 : wi) * h;
  const float* p = position + (size_t)(row % seq_len) * h;
  const float* t = nullptr;
  if (type_table != nullptr) {
    const int64_t ti = wrap_index(load_index(types, types_kind, row), n_types);
    nan_row |= ti < 0;
    t = type_table + (ti < 0 ? 0 : ti) * h;
  }
  float v[VPT][8];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vec = lane + 32 * j;
    if (vec < nvec) {
      float a[8], b[8];
      pw::load_f32x8(w + vec * 8, a);
      pw::load_f32x8(p + vec * 8, b);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[j][k] = pw::round_to<T>(pw::round_to<T>(a[k]) + pw::round_to<T>(b[k]));
      if (t != nullptr) {
        pw::load_f32x8(t + vec * 8, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[j][k] = pw::round_to<T>(v[j][k] + pw::round_to<T>(a[k]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = 0.0f;
    }
  }
  if (nan_row) {  // warp-uniform: one row per warp
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) v[j][k] = __int_as_float(0x7fc00000);  // quiet NaN
  }
  pw::warp_layer_norm<VPT>(v, lane, nvec, h, scale, bias, eps, out + (size_t)row * h);
}

template <int VPT, typename T>
int launch(const void* ids, int ids_kind, const void* types, int types_kind, const void* word,
           int vocab, const void* position, const void* type_table, int n_types,
           const void* scale, const void* bias, void* out, int rows, int seq_len, int h,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + pw::kRowsPerBlock - 1) / pw::kRowsPerBlock;
  embed_ln_kernel<VPT, T><<<blocks, pw::kRowsPerBlock * 32, 0, stream>>>(
      ids, ids_kind, types, types_kind, static_cast<const float*>(word), vocab,
      static_cast<const float*>(position), static_cast<const float*>(type_table), n_types,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), rows, seq_len, h, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// ids, types: [b, l] of the given kinds (types may be null: all zero);
// word [vocab, h], position [>= l, h] (row p is read for token position p:
// a block of a longer sequence passes the table from its first position
// on), type_table [n_types, h] (null when the config has no type
// vocabulary), scale, bias [h]: f32.  out: [b, l, h] bf16 (f32 = 0) or f32
// (f32 = 1).  h % 8 == 0, h <= 1024; tables 16-byte aligned.  Returns a
// cudaError_t (0 on success).
extern "C" int pw_embed_ln(const void* ids, int ids_kind, const void* types, int types_kind,
                           const void* word, int vocab, const void* position,
                           const void* type_table, int n_types, const void* scale,
                           const void* bias, void* out, int b, int l, int h, float eps, int f32,
                           void* stream) {
  const int rows = b * l;
  if (rows == 0) return 0;
  if (h % 8 != 0 || h <= 0 || h > 32 * 8 * pw::kMaxVpt) return (int)cudaErrorInvalidValue;
  if (types == nullptr) types_kind = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PW_EMBED_LN(V)                                                                       \
  return f32 ? launch<V, float>(ids, ids_kind, types, types_kind, word, vocab, position,    \
                                type_table, n_types, scale, bias, out, rows, l, h, eps, s)   \
             : launch<V, __nv_bfloat16>(ids, ids_kind, types, types_kind, word, vocab,      \
                                        position, type_table, n_types, scale, bias, out,    \
                                        rows, l, h, eps, s)
  switch ((h / 8 + 31) / 32) {
    case 1: PW_EMBED_LN(1);
    case 2: PW_EMBED_LN(2);
    case 3: PW_EMBED_LN(3);
    default: PW_EMBED_LN(4);
  }
#undef PW_EMBED_LN
}
