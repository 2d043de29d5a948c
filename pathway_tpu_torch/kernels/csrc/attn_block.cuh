// The attention block of K1 (attention.cu) and K14 (ring_block.cu): one
// block of 64 query rows walks the key tiles (64 keys) of its batch row
// with a running softmax, flash style.  Two forms, each templated on the
// head dim (16, 32 or 64) and on kRing:
//
//  - bf16 (wgmma_kernel): one consumer warpgroup (4 warps, 16 query rows
//    each) runs both products with wgmma (m64n64k16 for q.k^T from shared
//    memory, m64nDk16 for p.v with p in registers and v read through the
//    descriptor's transpose bit); a producer warp keeps a ring of 3 K/V
//    stages in flight with TMA and mbarriers.  A block walks 4 heads of its
//    batch row in turn: the walk is made once for them, q has two buffers,
//    and the ring runs on from one head into the next.  The tiles come
//    through a 4-D tensor map over [B, L, H, D] with a box of [1, 64, 1, D],
//    so a partial last tile is zero-filled inside its own batch row; rows of
//    128, 64 or 32 bytes (D = 64, 32, 16) use the swizzle of that width.
//  - f32 (tf32_kernel): both products as 3xTF32 on the tensor cores
//    (mma.sync m16n8k8, tf32x3.cuh), 4 warps of 16 query rows, k and v
//    tiles double-buffered in shared memory by cp.async.  p.v takes p
//    straight from the logit accumulators: its k index t of a key octet
//    stands for key 2t and t + 4 for key 2t + 1, and v's rows are read in
//    the same order.
//
// What kRing changes (K1: false, K14: true):
//  - the state: K1 starts from o = 0, l = 0 and writes o / l; K14 reads the
//    ring's state (o [B, H, L, D], m, l [B, H, L], f32) before the first
//    tile and writes it back after the last, or with finalize writes
//    o / max(l, 1e-30) instead;
//  - the logits: K1 keeps them f32 and works in log2 units (log2(e) folded
//    into the scale); K14 rounds them to the input type before the f32
//    scale, as the JAX ring step does, and keeps natural units, so that the
//    running max it hands on is the JAX step's;
//  - p.v in bf16: K1 rounds p to bf16 once, as the JAX program rounds its
//    probabilities; K14 keeps p f32 as the JAX ring step does: p is split
//    into a bf16 high part and the bf16 rounding of the rest, two wgmma
//    products carrying ~16 bits of p (v is exact in bf16);
//  - the length: K1 takes L <= 512; K14 up to kMaxRingLen (the walk's
//    shared memory grows with L, 10 bytes a tile).
//
// The walk (key_walk).  A block reads its batch row's mask into one bit a
// key (two words a tile) and lists the tiles it walks, in order, in shared
// memory.  Skipping a tile with no present key is exact when the batch row
// has a present key somewhere: a masked key's logit is -1e30 (plus -inf
// past L), so met after a present key it gets p = exp(-1e30 - m) = 0 and
// leaves alpha = 1; masked keys met before any present key leave m =
// -1e30, l = their count and o = their sum of v, which the first present
// key rescales by exp(-1e30 - m') = 0.  Either way the state after a
// present key is bit-equal to a walk of every tile.  K1 sees the whole
// sequence, so it skips when its own mask has a present key.  K14 sees one
// block of it: it skips where the caller's any_key[b] says the batch row
// has a present key in some block, and then walks no tile of a block with
// none (the state keeps l = 0 until the first present key, which a walk of
// every tile would have wiped anyway).  A row with no present key anywhere
// walks every tile, so it comes out as the uniform average of v over all
// its keys, as the JAX program gives it.  Query tiles are never skipped.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "ptx.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace pw_attn {

using namespace pw_ptx;
using namespace pw_sm90;
using namespace pw_tf32x3;

constexpr int kTile = 64;  // query rows per block and keys per tile
constexpr int kMaxLen = 512;            // K1
constexpr int kMaxRingLen = 1 << 19;    // K14: 8,192 tiles, 80 KB of walk
constexpr float kMaskBias = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The ring's state and K14's whole-sequence flag.
struct Ring {
  float* o;  // [B, H, L, D]
  float* m;  // [B, H, L]
  float* l;  // [B, H, L]
  const uint8_t* any_key;  // [B]: 1 where the batch row has a present key in some block
  int finalize;
};

// Shared memory of the walk for a length L: two mask words and a list
// entry per tile, rounded to 16 bytes; for K1 (bias) also the additive
// bias of every key, before them.
__host__ __device__ constexpr int walk_bytes(int L, bool bias) {
  return (((L + kTile - 1) / kTile) * (bias ? 4 * kTile + 10 : 10) + 15) / 16 * 16;
}

// The walk of batch row `mask_row`: words[2 t], words[2 t + 1] get the
// present bits of keys 0-31 and 32-63 of tile t, and list[0 .. count) the
// tiles to walk, in order: those with a present key when `skip`, else all.
// skip is any_key[b] when given (K14), else whether the row has a present
// key (K1).  With bias_s (K1), bias_s[key] gets the key's additive bias:
// 0 for a present key, mask_bias for a masked one, -inf past L.  Every
// thread of the block calls it; returns count, with the words, the list
// and the bias visible to all.
template <int kThreads>
__device__ __forceinline__ int key_walk(const uint8_t* __restrict__ mask_row, int L,
                                        const uint8_t* any_key, uint32_t* words, uint16_t* list,
                                        int* s_count, float* bias_s, float mask_bias) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kUnroll = 4;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int n_words = 2 * n_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned seen = 0u;
  for (int w0 = warp; w0 < n_words; w0 += kUnroll * kWarps) {
    bool x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the loads first, then the ballots
      const int key = (w0 + u * kWarps) * 32 + lane;
      x[u] = w0 + u * kWarps < n_words && key < L && mask_row[key] != 0;
      if (bias_s && w0 + u * kWarps < n_words) bias_s[key] = key >= L ? -INFINITY : (x[u] ? 0.0f : mask_bias);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned bits = __ballot_sync(0xffffffffu, x[u]);
      seen |= bits;
      if (lane == 0 && w0 + u * kWarps < n_words) words[w0 + u * kWarps] = bits;
    }
  }
  const int present = __syncthreads_or(seen != 0u);
  const bool skip = any_key ? *any_key != 0 : present != 0;
  if (warp == 0) {
    int base = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool take = t < n_tiles && (!skip || (words[2 * t] | words[2 * t + 1]) != 0u);
      const unsigned b = __ballot_sync(0xffffffffu, take);
      if (take) list[base + __popc(b & ((1u << lane) - 1u))] = static_cast<uint16_t>(t);
      base += __popc(b);
    }
    if (lane == 0) *s_count = base;
  }
  __syncthreads();
  return *s_count;
}

// The additive bias of column 8 n + c of a walked tile (n < 8, c < 8):
// 0 for a present key, mask_bias for a masked one, -inf for the keys past
// the sequence (the tile holds `lim` keys of it).
__device__ __forceinline__ float key_bias(uint32_t w0, uint32_t w1, int n, int c, int lim,
                                          float mask_bias) {
  const uint32_t w = n < 4 ? w0 : w1;
  return 8 * n + c >= lim ? -INFINITY : (((w >> (8 * (n & 3) + c)) & 1u) ? 0.0f : mask_bias);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// (a, b) as a bf16 pair (hi) and the bf16 pair of what hi leaves out (lo).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// The running max's rescale: in K14 exactly 1 where the max did not move
// (a skipped tile and a walked masked one then leave the same state).
template <bool kRing>
__device__ __forceinline__ float rescale(float m_old, float m_new) {
  if constexpr (kRing) return m_new == m_old ? 1.0f : ex2((m_old - m_new) * kLog2e);
  return ex2(m_old - m_new);  // log2 units; 0 on K1's first tile
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA

constexpr int kStages = 3;                     // K/V tiles in flight
constexpr int kHeads = 4;                      // heads a block walks, one after another
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kWgThreads = kConsumers + 32;    // and the producer warp

template <int D>
struct WgLayout {
  static constexpr int kRowBytes = D * 2;  // 128, 64 or 32: the swizzle width
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kMode = swizzle_mode(kRowBytes);
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // 8-row groups
  static constexpr int kQ = 0;                     // two buffers; every tile 1024-byte aligned
  static constexpr int kK = kQ + 2 * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  // full[kStages], empty[kStages], q_full[2], q_empty[2]
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kCount = kBars + (2 * kStages + 4) * 8;
  static constexpr int kWalk = kCount + 16;
  // + the walk and the alignment slack
  static constexpr int bytes(int L, bool bias) { return kWalk + walk_bytes(L, bias) + 1024; }
};

// One block: 64 query rows of batch row b, heads h0 .. h0 + kHeads - 1 in
// turn.  K1 writes out [B, L, H, D] bf16 (scale in log2 units); K14
// updates the ring's state or, with finalize, writes out.
template <int D, bool kRing>
__global__ void __launch_bounds__(kWgThreads)
wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int L, int H, float scale, Ring ring) {
  using S = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 2;
  int* s_count = reinterpret_cast<int*>(smem + S::kCount);
  const int n_tiles = (L + kTile - 1) / kTile;
  float* bias_s = kRing ? nullptr : reinterpret_cast<float*>(smem + S::kWalk);  // K1: in log2 units
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + S::kWalk + (kRing ? 0 : n_tiles * kTile * 4));
  uint16_t* list = reinterpret_cast<uint16_t*>(words + 2 * n_tiles);

  const int q0 = blockIdx.x * kTile;
  const int h0 = blockIdx.y * kHeads;
  const int n_heads = min(kHeads, H - h0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers);
    }
    fence_barrier_init();
  }
  const int count = key_walk<kWgThreads>(mask + (size_t)b * L, L, kRing ? ring.any_key + b : nullptr,
                                         words, list, s_count, bias_s, kMaskBias * kLog2e);

  if (warp == kConsumers / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      int j = 0;  // K/V stage uses, over all heads
      for (int hi = 0; hi < n_heads; ++hi) {
        const int h = h0 + hi;
        if (hi >= 2) mbar_wait(&q_empty[hi & 1], ((hi >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[hi & 1], S::kTileBytes);
        tma_load_4d(smem + S::kQ + (hi & 1) * S::kTileBytes, &q_map, &q_full[hi & 1], 0, h, q0, b);
        for (int i = 0; i < count; ++i, ++j) {
          const int t = list[i];
          const int s = j % kStages;
          if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
          mbar_expect_tx(&full[s], 2 * S::kTileBytes);
          tma_load_4d(smem + S::kK + s * S::kTileBytes, &k_map, &full[s], 0, h, t * kTile, b);
          tma_load_4d(smem + S::kV + s * S::kTileBytes, &v_map, &full[s], 0, h, t * kTile, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  This thread's rows of the tile are r and r + 8
  // (r = 16 warp + lane / 4); its accumulator columns 8 n + c0 and + 1.
  const int r = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  int j = 0;
  for (int hi = 0; hi < n_heads; ++hi) {
    const int h = h0 + hi;
    const size_t state_row = ((size_t)b * H + h) * L;  // the state's row of query 0
    const uint64_t q_desc = wgmma_desc(smem + S::kQ + (hi & 1) * S::kTileBytes, 16, S::kSbo, S::kMode);
    float o[D / 2];
    float m_run[2], l_run[2];  // l_run: this thread's part of the row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r + 8 * i;
      const bool in = kRing && row < L;
      m_run[i] = in ? ring.m[state_row + row] : (kRing ? kMaskBias : -INFINITY);
      l_run[i] = in && lane % 4 == 0 ? ring.l[state_row + row] : 0.0f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float2 s2 = in ? *reinterpret_cast<const float2*>(ring.o + (state_row + row) * D + 8 * n + c0)
                             : make_float2(0.0f, 0.0f);
        o[4 * n + 2 * i] = s2.x;
        o[4 * n + 2 * i + 1] = s2.y;
      }
    }
    mbar_wait(&q_full[hi & 1], (hi >> 1) & 1);

    for (int i = 0; i < count; ++i, ++j) {
      const int t = list[i];
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);

      // logits: 64 rows x 64 keys
      float sc[32];
      const uint64_t k_desc = wgmma_desc(smem + S::kK + s * S::kTileBytes, 16, S::kSbo, S::kMode);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax (K1 in log2 units, K14 in natural ones).  K1 reads
      // the bias; K14 makes it from the tile's mask words.  On a K14 tile of
      // present keys only there is no bias, and the scale is folded into
      // the exponent: max(x) = max(x_raw) * scale, and p = 2^(x_raw * scale
      // * log2(e) - m * log2(e)) in one FMA
      float alpha[2];
      uint32_t ph[4][4], pl[4][4];  // p as bf16 A operands of p.v; K14: ph + pl
      float sum[2] = {0.0f, 0.0f};
      auto softmax = [&](auto full_tile) {
        constexpr bool kFull = kRing && decltype(full_tile)::value;
        const uint32_t w0 = words[2 * t], w1 = words[2 * t + 1];
        const int lim = L - t * kTile;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            float x[2];
            if constexpr (kFull) {
              const float2 r = __bfloat1622float2(__floats2bfloat162_rn(sc[4 * n + e], sc[4 * n + e + 1]));
              x[0] = r.x;
              x[1] = r.y;
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                x[h] = kRing ? fmaf(round_bf16(sc[4 * n + e + h]), scale,
                                    key_bias(w0, w1, n, c0 + h, lim, kMaskBias))
                             : fmaf(sc[4 * n + e + h], scale, bias_s[t * kTile + 8 * n + c0 + h]);
              }
            }
            sc[4 * n + e] = x[0];
            sc[4 * n + e + 1] = x[1];
            mx[e / 2] = fmaxf(mx[e / 2], fmaxf(x[0], x[1]));
          }
        }
        float ml2[2];  // kFull: the running max in log2 units
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
          mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
          const float m_new = fmaxf(m_run[i2], kFull ? mx[i2] * scale : mx[i2]);
          alpha[i2] = rescale<kRing>(m_run[i2], m_new);
          m_run[i2] = m_new;
          ml2[i2] = m_new * kLog2e;
        }
        // k16 step kk covers keys 16 kk .. + 15, the accumulator's column
        // octets 2 kk and 2 kk + 1
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kFull) {
              p[e] = ex2(fmaf(sc[4 * n + e], scale * kLog2e, -ml2[e / 2]));
            } else {
              const float d = sc[4 * n + e] - m_run[e / 2];
              p[e] = ex2(kRing ? d * kLog2e : d);
            }
          }
          sum[0] += p[0] + p[1];
          sum[1] += p[2] + p[3];
          if constexpr (kRing) {
            split_bf16(p[0], p[1], ph[n / 2][2 * (n & 1)], pl[n / 2][2 * (n & 1)]);
            split_bf16(p[2], p[3], ph[n / 2][2 * (n & 1) + 1], pl[n / 2][2 * (n & 1) + 1]);
          } else {
            ph[n / 2][2 * (n & 1)] = pack_bf16(p[0], p[1]);
            ph[n / 2][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
          }
        }
      };
      if (kRing && (words[2 * t] & words[2 * t + 1]) == ~0u && t * kTile + kTile <= L) softmax(std::true_type{});
      else softmax(std::false_type{});
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) l_run[i2] = l_run[i2] * alpha[i2] + sum[i2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }

      // o += p . v (K14: the small part first)
      const uint64_t v_desc =
          wgmma_desc(smem + S::kV + s * S::kTileBytes, S::kSbo, S::kSbo, S::kMode);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vk = v_desc + ((kk * 16 * S::kRowBytes) >> 4);
        if constexpr (kRing) wgmma_rs_tb<D>(o, pl[kk], vk);
        wgmma_rs_tb<D>(o, ph[kk], vk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[s]);  // stage s may be loaded again
    }
    mbar_arrive(&q_empty[hi & 1]);  // this head's q is read

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + r + 8 * i;
      if (row >= L) continue;
      if (kRing && !ring.finalize) {
        float* st = ring.o + (state_row + row) * D + c0;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(st + 8 * n) = make_float2(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
        if (lane % 4 == 0) {
          ring.m[state_row + row] = m_run[i];
          ring.l[state_row + row] = l;
        }
        continue;
      }
      const float inv = 1.0f / (kRing ? fmaxf(l, 1e-30f) : l);
      __nv_bfloat16* dst = out + ((size_t)b * L + row) * H * D + (size_t)h * D + c0;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
  }
}

// The tensor map of a [B, L, H, D] bf16 tensor, a box of [1, 64, 1, D]
// (innermost first: D, H, L, B) with the swizzle of D * 2 bytes.
inline int tensor_map(CUtensorMap* map, const void* base, int B, int L, int H, int D) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, bool kRing>
int launch_wgmma(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
                 int L, int H, float scale, const Ring& ring, cudaStream_t stream) {
  using S = WgLayout<D>;
  static std::atomic<unsigned> done{0};
  int err = allow_smem(wgmma_kernel<D, kRing>, done, S::bytes(kRing ? kMaxRingLen : kMaxLen, !kRing));
  CUtensorMap maps[3];
  if (!err) err = tensor_map(&maps[0], q, B, L, H, D);
  if (!err) err = tensor_map(&maps[1], k, B, L, H, D);
  if (!err) err = tensor_map(&maps[2], v, B, L, H, D);
  if (err) return err;
  const dim3 grid((L + kTile - 1) / kTile, (H + kHeads - 1) / kHeads, B);
  wgmma_kernel<D, kRing><<<grid, kWgThreads, S::bytes(L, !kRing), stream>>>(
      maps[0], maps[1], maps[2], mask, static_cast<__nv_bfloat16*>(out), L, H,
      kRing ? scale : scale * kLog2e, ring);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync

constexpr int kTfThreads = 128;  // 4 warps of 16 query rows

template <int D>
struct TfLayout {
  static constexpr int kLd = D + 4;  // f32 pitch: fragment reads on distinct banks
  static constexpr int kTileBytes = kTile * kLd * 4;
  static constexpr int kK = 0;                      // two buffers
  static constexpr int kV = kK + 2 * kTileBytes;    // two buffers
  static constexpr int kCount = kV + 2 * kTileBytes;
  static constexpr int kWalk = kCount + 16;
  static constexpr int bytes(int L, bool bias) { return kWalk + walk_bytes(L, bias); }
};

template <int D, bool kRing>
__global__ void __launch_bounds__(kTfThreads)
tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const uint8_t* __restrict__ mask, float* __restrict__ out, int L, int H, float scale,
            Ring ring) {
  using S = TfLayout<D>;
  constexpr int kLd = S::kLd;
  constexpr int kKSteps = D / 8;  // k-steps of q.k^T, and output column octets
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_count = reinterpret_cast<int*>(smem + S::kCount);
  const int n_tiles = (L + kTile - 1) / kTile;
  float* bias_s = kRing ? nullptr : reinterpret_cast<float*>(smem + S::kWalk);  // K1
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + S::kWalk + (kRing ? 0 : n_tiles * kTile * 4));
  uint16_t* list = reinterpret_cast<uint16_t*>(words + 2 * n_tiles);
  auto k_buf = [&](int i) { return reinterpret_cast<float*>(smem + S::kK + i * S::kTileBytes); };
  auto v_buf = [&](int i) { return reinterpret_cast<float*>(smem + S::kV + i * S::kTileBytes); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and B column)
  const int tq = lane % 4;  // fragment column (and B row)
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = H * D;
  const size_t head_base = (size_t)b * L * row_stride + (size_t)h * D;
  const size_t state_row = ((size_t)b * H + h) * L;

  const int count = key_walk<kTfThreads>(mask + (size_t)b * L, L, kRing ? ring.any_key + b : nullptr,
                                         words, list, s_count, bias_s, kMaskBias);
  auto stage = [&](int t, int buf) {
    load_tile<float, D, S::kLd, kTfThreads>(k_buf(buf), k + head_base, t * kTile, L, row_stride);
    load_tile<float, D, S::kLd, kTfThreads>(v_buf(buf), v + head_base, t * kTile, L, row_stride);
  };
  if (count > 0) {
    stage(list[0], 0);
    cp_async_commit();
  }

  // this warp's 16 query rows as TF32 A fragments, split once
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  uint32_t qh[kKSteps][4], ql[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e & 1];
      const float x = row < L ? q[head_base + (size_t)row * row_stride + 8 * kk + tq + 4 * (e >> 1)] : 0.0f;
      split_tf32(x, qh[kk][e], ql[kk][e]);
    }
  }
  float o[kKSteps][4];
  float m_run[2], l_run[2];  // l_run: this thread's part of the row sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = kRing && rows[i] < L;
    m_run[i] = in ? ring.m[state_row + rows[i]] : (kRing ? kMaskBias : -INFINITY);
    l_run[i] = in && tq == 0 ? ring.l[state_row + rows[i]] : 0.0f;
#pragma unroll
    for (int n = 0; n < kKSteps; ++n) {
      const float2 s2 = in ? *reinterpret_cast<const float2*>(ring.o + (state_row + rows[i]) * D + 8 * n + 2 * tq)
                           : make_float2(0.0f, 0.0f);
      o[n][2 * i] = s2.x;
      o[n][2 * i + 1] = s2.y;
    }
  }

  for (int j = 0; j < count; ++j) {
    const int t = list[j];
    if (j + 1 < count) {
      stage(list[j + 1], (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_s = k_buf(j & 1);
    const float* v_s = v_buf(j & 1);
    // logits: 16 rows x 64 keys, as 8 column octets
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const float* kr = k_s + (8 * n + g) * kLd + 8 * kk + tq;
        uint32_t h0, l0, h1, l1;
        split_tf32(kr[0], h0, l0);
        split_tf32(kr[4], h1, l1);
        mma_3xtf32(s[n], qh[kk], ql[kk], h0, l0, h1, l1);
      }
    }

    // online softmax over this tile, rows r (s[n][0..1]) and r + 8
    // (s[n][2..3]); K1 reads the bias, K14 makes it from the mask words
    float mx[2] = {-INFINITY, -INFINITY};
    const uint32_t w0 = words[2 * t], w1 = words[2 * t + 1];
    const int lim = L - t * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * tq + (e & 1);
        s[n][e] = s[n][e] * scale + (kRing ? key_bias(w0, w1, n, c, lim, kMaskBias) : bias_s[t * kTile + 8 * n + c]);
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = kRing && m_new == m_run[i] ? 1.0f : expf(m_run[i] - m_new);  // 0 on K1's first tile
      m_run[i] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_run[e / 2]);
        sum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + sum[i];
    // K14 sums each tile's p . v apart and adds it to o in f32: its blocks
    // run to thousands of keys, and each tensor-core accumulation rounds
    float pv[kKSteps][4];
#pragma unroll
    for (int n = 0; n < kKSteps; ++n) {
      if constexpr (kRing) {
        pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.0f;
      } else {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    auto& acc = kRing ? pv : o;

    // acc += p . v over the key octets: A's k index tq is key 2 tq of the
    // octet, tq + 4 is key 2 tq + 1; v's rows are read in that order
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t ph[4], pl[4];
      split_tf32(s[n][0], ph[0], pl[0]);
      split_tf32(s[n][2], ph[1], pl[1]);
      split_tf32(s[n][1], ph[2], pl[2]);
      split_tf32(s[n][3], ph[3], pl[3]);
      const float* vr = v_s + (8 * n + 2 * tq) * kLd + g;
#pragma unroll
      for (int dn = 0; dn < kKSteps; ++dn) {
        uint32_t h0, l0, h1, l1;
        split_tf32(vr[8 * dn], h0, l0);
        split_tf32(vr[kLd + 8 * dn], h1, l1);
        mma_3xtf32(acc[dn], ph, pl, h0, l0, h1, l1);
      }
    }
    if constexpr (kRing) {
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e / 2], pv[n][e]);
      }
    }
    __syncthreads();  // buffer j & 1 is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rows[i];
    if (row >= L) continue;
    if (kRing && !ring.finalize) {
      float* st = ring.o + (state_row + row) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < kKSteps; ++n)
        *reinterpret_cast<float2*>(st + 8 * n) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (tq == 0) {
        ring.m[state_row + row] = m_run[i];
        ring.l[state_row + row] = l;
      }
      continue;
    }
    const float inv = 1.0f / (kRing ? fmaxf(l, 1e-30f) : l);
    float* dst = out + head_base + (size_t)row * row_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < kKSteps; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int D, bool kRing>
int launch_tf32(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
                int L, int H, float scale, const Ring& ring, cudaStream_t stream) {
  using S = TfLayout<D>;
  static std::atomic<unsigned> done{0};
  const int err = allow_smem(tf32_kernel<D, kRing>, done, S::bytes(kRing ? kMaxRingLen : kMaxLen, !kRing));
  if (err) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  tf32_kernel<D, kRing><<<grid, kTfThreads, S::bytes(L, !kRing), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
      static_cast<float*>(out), L, H, scale, ring);
  return (int)cudaGetLastError();
}

// The kernel for head dim D (16, 32 or 64) and the element type.  Returns
// a cudaError_t.
template <bool kRing>
int dispatch(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B, int L,
             int H, int D, float scale, int f32, const Ring& ring, cudaStream_t s) {
  if (f32) {
    if (D == 64) return launch_tf32<64, kRing>(q, k, v, mask, out, B, L, H, scale, ring, s);
    if (D == 32) return launch_tf32<32, kRing>(q, k, v, mask, out, B, L, H, scale, ring, s);
    if (D == 16) return launch_tf32<16, kRing>(q, k, v, mask, out, B, L, H, scale, ring, s);
  } else {
    if (D == 64) return launch_wgmma<64, kRing>(q, k, v, mask, out, B, L, H, scale, ring, s);
    if (D == 32) return launch_wgmma<32, kRing>(q, k, v, mask, out, B, L, H, scale, ring, s);
    if (D == 16) return launch_wgmma<16, kRing>(q, k, v, mask, out, B, L, H, scale, ring, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pw_attn
