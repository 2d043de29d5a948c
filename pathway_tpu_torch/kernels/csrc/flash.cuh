// Shared by K1 (attention.cu) and K14 (ring_block.cu): one block of 64
// query rows of one (batch, head) walks every key tile of a [B, L, H, D]
// K/V block with a running softmax, flash style.
//
// Two forms of the block, each templated on the head dim (16, 32 or 64)
// and on RING:
//
// - mma (bf16 q/k/v): 4 warps, 16 query rows each; q.k^T and p.v on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) with
//   operands loaded by ldmatrix; logits, the running max and sum and the
//   output accumulator stay in registers.
// - fma (f32 q/k/v): 256 threads, 4 per query row; each takes every 4th
//   key of a tile, keeps its row of q and its part of the output sum in
//   registers, and the four parts meet by warp shuffles.  Every product is
//   an f32 FMA: the f32 JAX program keeps logits, probabilities and p.v in
//   f32, and neither bf16 mma nor one-pass TF32 (10 mantissa bits) keeps
//   that precision.
//
// Both stage the key tiles (64 keys of k and v, and the mask's additive
// bias) in shared memory by cp.async, double-buffered, so the next tile
// loads while this one is multiplied.  A masked key gets -1e30 added to
// its logit, never skipped: a row whose keys are all masked comes out as
// the uniform average of v, as in the JAX program.  Keys past L get -inf.
//
// RING = false is K1, softmax(q.k^T / sqrt(d) + bias) . v in one pass,
// the JAX encoder's attention core: logits kept in f32 (the JAX program
// rounds them to the activation type; K1 is held at a bf16 tolerance),
// p rounded to bf16 for the second product as the JAX program rounds its
// probabilities.
//
// RING = true is K14, one step of the ring attention's _ring_body: the
// state (o [B, H, L, D], m, l [B, H, L], f32) is read at the start and
// written back at the end, or, with finalize, the step's o / max(l, 1e-30)
// is written as the [B, L, H, D] output instead.  As the JAX step does,
// the logits are rounded to the input type before the f32 scale, and p
// stays f32 for p.v: in bf16, p is split into a bf16 high part and the
// bf16 rounding of the rest, two mma products that carry ~16 bits of p
// (v is exact in bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace pw_flash {

constexpr int kTile = 64;  // query rows per block and keys per tile
constexpr float kMaskBias = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, L], 1 = key present
  void* out;            // [B, L, H, D] in q's type
  float* st_o;          // ring state [B, H, L, D]; null for K1
  float* st_m;          // [B, H, L]
  float* st_l;          // [B, H, L]
  int L;
  int H;
  float scale;
  int finalize;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy into shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[0..3] += a[0..3] (16x16 bf16, row) * b[0..1] (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16 pair (hi) and the bf16 pair of what hi leaves out (lo).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The additive bias of key `key` of batch row b: 0, the mask's -1e30, or
// -inf past the end.
__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int key, int L) {
  return key >= L ? -INFINITY : (mask[(size_t)b * L + key] ? 0.0f : kMaskBias);
}

// ---------------------------------------------------------------------------
// mma form (bf16)

constexpr int kMmaWarps = 4;  // 16 query rows each
constexpr int kMmaThreads = kMmaWarps * 32;

template <int D>
struct MmaSmem {
  static constexpr int kLd = D + 8;                    // bf16 pitch: conflict-free ldmatrix
  static constexpr int kTileBytes = kTile * kLd * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;            // two buffers
  static constexpr int kV = kK + 2 * kTileBytes;        // two buffers
  static constexpr int kBias = kV + 2 * kTileBytes;     // two buffers of kTile floats
  static constexpr int kBytes = kBias + 2 * kTile * 4;
};

// Async copy of rows [row0, row0+64) of one head of a [B, L, H, D] tensor
// into a shared tile; rows past L are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int L, int row_stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool in = row0 + r < L;
    const __nv_bfloat16* s = in ? src + (size_t)(row0 + r) * row_stride + col : src;
    cp_async16(dst + r * MmaSmem<D>::kLd + col, s, in ? 16 : 0);
  }
}

template <int D, bool RING>
__global__ void __launch_bounds__(kMmaThreads)
mma_kernel(Args a) {
  using S = MmaSmem<D>;
  constexpr int kLd = S::kLd;
  constexpr int kKSteps = D / 16;    // k-steps of q.k^T
  constexpr int kNTiles = kTile / 8; // 8-key column tiles of the logits
  constexpr int kDTiles = D / 8;     // 8-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = a.L;
  const int row_stride = a.H * D;
  const size_t head_base = (size_t)b * L * row_stride + (size_t)h * D;
  const size_t state_base = ((size_t)b * a.H + h) * L;  // state row of query 0
  const int n_tiles = (L + kTile - 1) / kTile;

  auto k_buf = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + S::kK + i * S::kTileBytes);
  };
  auto v_buf = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + S::kV + i * S::kTileBytes);
  };
  auto stage = [&](int t) {  // issue the loads of key tile t into buffer t & 1
    const int k0 = t * kTile;
    load_tile_bf16<D>(k_buf(t & 1), k + head_base, k0, L, row_stride);
    load_tile_bf16<D>(v_buf(t & 1), v + head_base, k0, L, row_stride);
    for (int j = threadIdx.x; j < kTile; j += kMmaThreads)
      bias_s[(t & 1) * kTile + j] = key_bias(a.mask, b, k0 + j, L);
  };

  load_tile_bf16<D>(q_s, q + head_base, q0, L, row_stride);
  stage(0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: r0 = lane/4 and r0 + 8, and
  // the two output columns of each 8-wide tile
  const int rows[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const int c0 = (lane % 4) * 2;
  uint32_t qf[kKSteps][4];
  float o[kDTiles][4];
  float m_run[2], l_run[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = RING && rows[i] < L;
    const size_t sr = state_base + rows[i];
    m_run[i] = in ? a.st_m[sr] : (RING ? kMaskBias : -INFINITY);
    l_run[i] = in ? a.st_l[sr] : 0.0f;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      const float2 s2 = in ? *reinterpret_cast<const float2*>(a.st_o + sr * D + n * 8 + c0)
                           : make_float2(0.0f, 0.0f);
      o[n][2 * i] = s2.x;
      o[n][2 * i + 1] = s2.y;
    }
  }
  const int mi = lane / 8;  // which 8x8 matrix this lane addresses in ldmatrix.x4
  const int mr = lane % 8;  // which row of it

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int row = warp * 16 + mr + 8 * (mi % 2);
        ldmatrix_x4(qf[kk], q_s + row * kLd + kk * 16 + 8 * (mi / 2));
      }
    }
    const __nv_bfloat16* k_s = k_buf(t & 1);
    const __nv_bfloat16* v_s = v_buf(t & 1);
    const float* bias = bias_s + (t & 1) * kTile;

    // logits: 16 rows x 64 keys, as 8 column tiles of 8 keys
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int p = 0; p < kNTiles / 2; ++p) {  // pairs of key tiles: keys 16p .. 16p+15
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t kb[4];
        const int key = 16 * p + mr + 8 * (mi / 2);
        ldmatrix_x4(kb, k_s + key * kLd + kk * 16 + 8 * (mi % 2));
        mma_bf16(s[2 * p], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // online softmax over this tile, rows r0 (s[n][0..1]) and r0+8 (s[n][2..3])
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const int c = n * 8 + c0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float logit = RING ? round_bf16(s[n][e]) : s[n][e];
        s[n][e] = logit * a.scale + bias[c + (e & 1)];
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);  // 0 on K1's first tile
      m_run[i] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_run[e / 2]);
        sum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p . v, p repacked from the logit accumulators as bf16 A operands
    // (K1), or as a bf16 high part and a bf16 rest (K14)
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {  // keys 16j .. 16j+15
      uint32_t pa[4], pl[4];
      if (RING) {
        split_bf16(s[2 * j][0], s[2 * j][1], pa[0], pl[0]);
        split_bf16(s[2 * j][2], s[2 * j][3], pa[1], pl[1]);
        split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], pa[2], pl[2]);
        split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], pa[3], pl[3]);
      } else {
        pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
#pragma unroll
      for (int dq = 0; dq < kDTiles / 2; ++dq) {  // output dims 16dq .. 16dq+15
        uint32_t vb[4];
        const int key = 16 * j + mr + 8 * (mi % 2);
        ldmatrix_x4_trans(vb, v_s + key * kLd + 16 * dq + 8 * (mi / 2));
        mma_bf16(o[2 * dq], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], pa, vb[2], vb[3]);
        if (RING) {
          mma_bf16(o[2 * dq], pl, vb[0], vb[1]);
          mma_bf16(o[2 * dq + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // buffer t & 1 is free for tile t + 2
  }

  // rows r0 and r0 + 8 of this warp, two dims per register pair
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= L) continue;
    if (RING && !a.finalize) {
      const size_t sr = state_base + row;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n)
        *reinterpret_cast<float2*>(a.st_o + sr * D + n * 8 + c0) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (lane % 4 == 0) {
        a.st_m[sr] = m_run[i];
        a.st_l[sr] = l_run[i];
      }
    } else {
      const float inv = RING ? 1.0f / fmaxf(l_run[i], 1e-30f) : 1.0f / l_run[i];
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + head_base +
                           (size_t)row * row_stride + c0;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fma form (f32)

constexpr int kParts = 4;  // threads per query row
constexpr int kFmaThreads = kTile * kParts;

template <int D>
struct FmaSmem {
  static constexpr int kLd = D + 4;  // f32 pitch: a quad's four keys on distinct banks
  static constexpr int kTileBytes = kTile * kLd * 4;
  static constexpr int kK = 0;                          // two buffers
  static constexpr int kV = kK + 2 * kTileBytes;        // two buffers
  static constexpr int kBias = kV + 2 * kTileBytes;     // two buffers of kTile floats
  static constexpr int kBytes = kBias + 2 * kTile * 4;
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int row0, int L,
                                              int row_stride) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kFmaThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool in = row0 + r < L;
    const float* s = in ? src + (size_t)(row0 + r) * row_stride + col : src;
    cp_async16(dst + r * FmaSmem<D>::kLd + col, s, in ? 16 : 0);
  }
}

template <int D, bool RING>
__global__ void __launch_bounds__(kFmaThreads, 1)
fma_kernel(Args a) {
  using S = FmaSmem<D>;
  constexpr int kLd = S::kLd;
  constexpr int kKeys = kTile / kParts;  // keys of a tile per thread
  constexpr int kD4 = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  const int part = threadIdx.x % kParts;  // the quad of a row is 4 adjacent lanes
  const int row = blockIdx.x * kTile + threadIdx.x / kParts;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = a.L;
  const int row_stride = a.H * D;
  const size_t head_base = (size_t)b * L * row_stride + (size_t)h * D;
  const size_t sr = ((size_t)b * a.H + h) * L + row;  // this row's state
  const int n_tiles = (L + kTile - 1) / kTile;
  const bool in = row < L;

  auto k_buf = [&](int i) { return reinterpret_cast<float*>(smem + S::kK + i * S::kTileBytes); };
  auto v_buf = [&](int i) { return reinterpret_cast<float*>(smem + S::kV + i * S::kTileBytes); };
  auto stage = [&](int t) {
    const int k0 = t * kTile;
    load_tile_f32<D>(k_buf(t & 1), k + head_base, k0, L, row_stride);
    load_tile_f32<D>(v_buf(t & 1), v + head_base, k0, L, row_stride);
    for (int j = threadIdx.x; j < kTile; j += kFmaThreads)
      bias_s[(t & 1) * kTile + j] = key_bias(a.mask, b, k0 + j, L);
  };
  stage(0);
  cp_async_commit();

  float qr[D], o[D];
  {
    const float4* src = reinterpret_cast<const float4*>(q + head_base + (size_t)row * row_stride);
    const float4* st = reinterpret_cast<const float4*>(a.st_o + sr * D);
#pragma unroll
    for (int d4 = 0; d4 < kD4; ++d4) {
      const float4 t = in ? src[d4] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      qr[4 * d4] = t.x; qr[4 * d4 + 1] = t.y; qr[4 * d4 + 2] = t.z; qr[4 * d4 + 3] = t.w;
      // the carried output enters through part 0; the others start at 0
      const float4 u = (RING && in && part == 0) ? st[d4] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      o[4 * d4] = u.x; o[4 * d4 + 1] = u.y; o[4 * d4 + 2] = u.z; o[4 * d4 + 3] = u.w;
    }
  }
  float m_run = (RING && in) ? a.st_m[sr] : (RING ? kMaskBias : -INFINITY);
  float l_run = (RING && in) ? a.st_l[sr] : 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_s = k_buf(t & 1);
    const float* v_s = v_buf(t & 1);
    const float* bias = bias_s + (t & 1) * kTile;

    float s[kKeys];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int key = part + kParts * jj;
      const float4* kr = reinterpret_cast<const float4*>(k_s + key * kLd);
      float acc = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        const float4 kv = kr[d4];
        acc = fmaf(qr[4 * d4], kv.x, acc);
        acc = fmaf(qr[4 * d4 + 1], kv.y, acc);
        acc = fmaf(qr[4 * d4 + 2], kv.z, acc);
        acc = fmaf(qr[4 * d4 + 3], kv.w, acc);
      }
      s[jj] = acc * a.scale + bias[key];
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);  // 0 on K1's first tile
    m_run = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      sum += s[jj];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * alpha + sum;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const float4* vr = reinterpret_cast<const float4*>(v_s + (part + kParts * jj) * kLd);
      const float p = s[jj];
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        const float4 vv = vr[d4];
        o[4 * d4] = fmaf(p, vv.x, o[4 * d4]);
        o[4 * d4 + 1] = fmaf(p, vv.y, o[4 * d4 + 1]);
        o[4 * d4 + 2] = fmaf(p, vv.z, o[4 * d4 + 2]);
        o[4 * d4 + 3] = fmaf(p, vv.w, o[4 * d4 + 3]);
      }
    }
    __syncthreads();  // buffer t & 1 is free for tile t + 2
  }

  // the row's output is the sum of its four parts'
#pragma unroll
  for (int d = 0; d < D; ++d) {
    o[d] += __shfl_xor_sync(0xffffffffu, o[d], 1);
    o[d] += __shfl_xor_sync(0xffffffffu, o[d], 2);
  }
  if (!in) return;
  if (RING && !a.finalize) {
    float4* st = reinterpret_cast<float4*>(a.st_o + sr * D);
#pragma unroll
    for (int d4 = 0; d4 < kD4; ++d4)
      if (d4 % kParts == part)
        st[d4] = make_float4(o[4 * d4], o[4 * d4 + 1], o[4 * d4 + 2], o[4 * d4 + 3]);
    if (part == 0) {
      a.st_m[sr] = m_run;
      a.st_l[sr] = l_run;
    }
  } else {
    const float inv = RING ? 1.0f / fmaxf(l_run, 1e-30f) : 1.0f / l_run;
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(a.out) + head_base +
                                            (size_t)row * row_stride);
#pragma unroll
    for (int d4 = 0; d4 < kD4; ++d4)
      if (d4 % kParts == part)
        dst[d4] = make_float4(o[4 * d4] * inv, o[4 * d4 + 1] * inv, o[4 * d4 + 2] * inv,
                              o[4 * d4 + 3] * inv);
  }
}

// ---------------------------------------------------------------------------
// launch

// Launch `kernel` over (query tiles, heads, batch) with `smem` bytes of
// dynamic shared memory, raising the device's limit for it once per device
// (one bit each).  Returns a cudaError_t.
template <typename Kernel>
int launch(Kernel kernel, std::atomic<unsigned>& done, int smem, int threads, int B, const Args& a,
           cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  dim3 grid((a.L + kTile - 1) / kTile, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool RING>
int launch_mma(int B, const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  return launch(mma_kernel<D, RING>, done, MmaSmem<D>::kBytes, kMmaThreads, B, a, stream);
}

template <int D, bool RING>
int launch_fma(int B, const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  return launch(fma_kernel<D, RING>, done, FmaSmem<D>::kBytes, kFmaThreads, B, a, stream);
}

// The kernel for head dim D (16, 32 or 64) and the element type.
template <bool RING>
int dispatch(int B, int D, int f32, const Args& a, cudaStream_t s) {
  if (f32) {
    if (D == 64) return launch_fma<64, RING>(B, a, s);
    if (D == 32) return launch_fma<32, RING>(B, a, s);
    if (D == 16) return launch_fma<16, RING>(B, a, s);
  } else {
    if (D == 64) return launch_mma<64, RING>(B, a, s);
    if (D == 32) return launch_mma<32, RING>(B, a, s);
    if (D == 16) return launch_mma<16, RING>(B, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pw_flash
