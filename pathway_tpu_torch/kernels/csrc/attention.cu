// K1: fused masked self-attention for the text and image encoders (bf16 in
// and out, or f32 in and out for the f32 configs).
//
// Replaces: the attention core of SelfAttention.__call__ in
//   pathway_tpu/models/encoder.py:113-117 (softmax(q.k^T / sqrt(d) + bias) . v,
//   bias = -1e30 on padded keys, non-causal), which XLA fuses on the TPU.
//
// What bounds it on an H100: the two products do 4*B*H*L*keys*d operations
// (keys: the present keys of a batch row) against 4*B*L*H*d bytes of q and
// out and 4*keys*H*d of k and v.  At the rerank path's B=256 L=512 with
// 75-283 keys present that is ~0.16 ms either way (bytes and bf16 tensor
// cores about even); in f32 the 67 TFLOP/s of the FMA units would bound it,
// the tensor cores' 495 TFLOP/s of TF32 do not.
//
// What the design does about it.  One block owns 64 query rows of one
// (batch, head) and walks the key tiles (64 keys) of its batch row.
//  - Tile skip: the block first reads the row's mask (at most 512 bytes)
//    and walks only the tiles that hold a present key.  That is exact: a
//    masked key's logit is -1e30 + x, and exp(-1e30 - m) is 0 in f32 against
//    the finite running max m a present key gives; a masked tile met first
//    is wiped by the rescale exp(m_old - m_new) = 0.  A row with no present
//    key walks every tile, so it comes out as the uniform average of v over
//    its L keys, as the JAX program gives it.  Keys past L get -inf.  Query
//    tiles are never skipped: padded query rows are computed as the plain
//    version computes them.
//  - bf16: one consumer warpgroup (4 warps, 16 query rows each) runs both
//    products with wgmma (m64n64k16 for q.k^T from shared memory, m64nDk16
//    for p.v with p in registers and v read through the descriptor's
//    transpose bit), and a producer warp keeps a ring of 3 K/V stages in
//    flight with TMA and mbarriers.  A block walks 4 heads of its batch row
//    in turn: the mask, the walk and the bias are made once for them, q has
//    two buffers, and the ring runs on from one head into the next, so the
//    next head's tiles load while this one's are multiplied (one head a
//    block took 1.2-1.6x as long at the path shapes on an H100 80GB HBM3 at
//    700 W).  The tiles come through a 4-D tensor map over [B, L, H, D]
//    with a box of [1, 64, 1, D], so a partial last tile (L = 196) is
//    zero-filled inside its own batch row; rows of 128, 64 or 32 bytes
//    (D = 64, 32, 16) use the swizzle of that width, and the wgmma
//    descriptors the same mode (sm90.cuh).  The logits, the online softmax
//    (exp2 with log2(e) folded into the scale) and the output stay in
//    registers; the logits stay f32 (the JAX program rounds them to bf16
//    before its f32 softmax; K1 is held at a bf16 tolerance) and p is
//    rounded to bf16 for p.v as the JAX program rounds its probabilities.
//  - f32: the JAX program keeps everything in f32, which neither bf16 nor
//    one-pass TF32 (10 mantissa bits) holds.  Both products run on the
//    tensor cores as 3xTF32 (mma.sync m16n8k8: a.b ~ a_hi.b_hi + a_hi.b_lo
//    + a_lo.b_hi, each part rounded to TF32, ~21 bits of each operand;
//    helpers in tf32x3.cuh), 4
//    warps of 16 query rows; k and v tiles double-buffered in shared memory
//    by cp.async.  p.v takes p straight from the logit accumulators: its k
//    index t of a key octet stands for key 2t and t + 4 for key 2t + 1, and
//    v's rows are read in the same order.
// Head dims 16, 32 and 64; L <= 512.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace pw_ptx;
using namespace pw_sm90;
using namespace pw_tf32x3;

constexpr int kTile = 64;  // query rows per block and keys per tile
constexpr int kMaxLen = 512;
constexpr float kMaskBias = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The key tiles the block walks, as a bit set (tile t = bit t): those of
// batch row `mask_row` that hold a present key, or all of them when none
// does.  Also fills bias_s[key] for the keys of every tile: 0 for a present
// key, `mask_bias` for a masked one, -inf past L.  Every thread of the
// block calls it; it ends with the bias and the set visible to all.
template <int kThreads>
__device__ __forceinline__ unsigned key_walk(const uint8_t* __restrict__ mask_row, int L,
                                             float mask_bias, float* bias_s, unsigned* s_bits) {
  const int n_tiles = (L + kTile - 1) / kTile;
  if (threadIdx.x == 0) *s_bits = 0u;
  __syncthreads();
  unsigned bits = 0u;
  for (int key = threadIdx.x; key < n_tiles * kTile; key += kThreads) {
    const bool in = key < L;
    const bool present = in && mask_row[key];
    bias_s[key] = !in ? -INFINITY : (present ? 0.0f : mask_bias);
    if (present) bits |= 1u << (key / kTile);
  }
  if (bits) atomicOr(s_bits, bits);
  __syncthreads();
  const unsigned present = *s_bits;
  return present ? present : (1u << n_tiles) - 1u;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
  static constexpr int kBias = kV + kStages * kTileBytes;  // kMaxLen floats
  // full[kStages], empty[kStages], q_full[2], q_empty[2]
  static constexpr int kBars = kBias + kMaxLen * 4;
  static constexpr int kBits = kBars + (2 * kStages + 4) * 8;
  static constexpr int kBytes = kBits + 16 + 1024;         // + the alignment slack
};

// One block: 64 query rows of batch row b, heads h0 .. h0 + kHeads - 1 in
// turn (the walk and the bias are the batch row's, made once).  The
// producer's ring of K/V stages runs on from one head into the next, and q
// has two buffers, so the next head's first tiles load while this one's
// last are multiplied.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int L, int H, float scale_log2) {
  using S = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 2;
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + S::kBits);

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
  const unsigned walk =
      key_walk<kWgThreads>(mask + (size_t)b * L, L, kMaskBias * kLog2e, bias_s, s_bits);

  if (warp == kConsumers / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      int j = 0;  // K/V stage uses, over all heads
      for (int hi = 0; hi < n_heads; ++hi) {
        const int h = h0 + hi;
        if (hi >= 2) mbar_wait(&q_empty[hi & 1], ((hi >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[hi & 1], S::kTileBytes);
        tma_load_4d(smem + S::kQ + (hi & 1) * S::kTileBytes, &q_map, &q_full[hi & 1], 0, h, q0, b);
        for (unsigned w = walk; w; w &= w - 1u, ++j) {
          const int t = __ffs(w) - 1;
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
    const uint64_t q_desc = wgmma_desc(smem + S::kQ + (hi & 1) * S::kTileBytes, 16, S::kSbo, S::kMode);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};  // this thread's part of the row sums
    mbar_wait(&q_full[hi & 1], (hi >> 1) & 1);

    for (unsigned w = walk; w; w &= w - 1u, ++j) {
      const int t = __ffs(w) - 1;
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

      // online softmax, in log2 units
      const float* bias = bias_s + t * kTile;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(sc[4 * n + e], scale_log2, bias[8 * n + c0 + (e & 1)]);
          sc[4 * n + e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = ex2(m_run[i] - m_new);  // 0 on the first tile
        m_run[i] = m_new;
      }
      // p as the bf16 A operand of p.v: k16 step kk covers keys 16 kk .. + 15,
      // the accumulator's column octets 2 kk and 2 kk + 1
      uint32_t pa[4][4];
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float p0 = ex2(sc[4 * n] - m_run[0]);
        const float p1 = ex2(sc[4 * n + 1] - m_run[0]);
        const float p2 = ex2(sc[4 * n + 2] - m_run[1]);
        const float p3 = ex2(sc[4 * n + 3] - m_run[1]);
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        pa[n / 2][2 * (n & 1)] = pack_bf16(p0, p1);
        pa[n / 2][2 * (n & 1) + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + sum[i];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }

      // o += p . v
      const uint64_t v_desc =
          wgmma_desc(smem + S::kV + s * S::kTileBytes, S::kSbo, S::kSbo, S::kMode);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<D>(o, pa[kk], v_desc + ((kk * 16 * S::kRowBytes) >> 4));
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
      const float inv = 1.0f / l;
      const int row = q0 + r + 8 * i;
      if (row >= L) continue;
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
int tensor_map(CUtensorMap* map, const void* base, int B, int L, int H, int D) {
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

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
                 int L, int H, float scale, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  int err = allow_smem(wgmma_kernel<D>, done, WgLayout<D>::kBytes);
  CUtensorMap maps[3];
  if (!err) err = tensor_map(&maps[0], q, B, L, H, D);
  if (!err) err = tensor_map(&maps[1], k, B, L, H, D);
  if (!err) err = tensor_map(&maps[2], v, B, L, H, D);
  if (err) return err;
  const dim3 grid((L + kTile - 1) / kTile, (H + kHeads - 1) / kHeads, B);
  wgmma_kernel<D><<<grid, kWgThreads, WgLayout<D>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], mask, static_cast<__nv_bfloat16*>(out), L, H, scale * kLog2e);
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
  static constexpr int kBias = kV + 2 * kTileBytes; // kMaxLen floats
  static constexpr int kBits = kBias + kMaxLen * 4;
  static constexpr int kBytes = kBits + 16;
};

template <int D>
__global__ void __launch_bounds__(kTfThreads)
tf32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const uint8_t* __restrict__ mask, float* __restrict__ out, int L, int H, float scale) {
  using S = TfLayout<D>;
  constexpr int kLd = S::kLd;
  constexpr int kKSteps = D / 8;  // k-steps of q.k^T, and output column octets
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + S::kBits);
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

  unsigned w = key_walk<kTfThreads>(mask + (size_t)b * L, L, kMaskBias, bias_s, s_bits);
  auto stage = [&](int t, int buf) {
    load_tile<float, D, TfLayout<D>::kLd, kTfThreads>(k_buf(buf), k + head_base, t * kTile, L, row_stride);
    load_tile<float, D, TfLayout<D>::kLd, kTfThreads>(v_buf(buf), v + head_base, t * kTile, L, row_stride);
  };
  stage(__ffs(w) - 1, 0);
  cp_async_commit();

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
#pragma unroll
  for (int n = 0; n < kKSteps; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  for (int j = 0; w; ++j) {
    const int t = __ffs(w) - 1;
    w &= w - 1u;
    if (w) {
      stage(__ffs(w) - 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_s = k_buf(j & 1);
    const float* v_s = v_buf(j & 1);
    const float* bias = bias_s + t * kTile;

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

    // online softmax over this tile, rows r (s[n][0..1]) and r + 8 (s[n][2..3])
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = s[n][e] * scale + bias[8 * n + 2 * tq + (e & 1)];
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);  // 0 on the first tile
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
#pragma unroll
    for (int n = 0; n < kKSteps; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p . v over the key octets: A's k index tq is key 2 tq of the
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
        mma_3xtf32(o[dn], ph, pl, h0, l0, h1, l1);
      }
    }
    __syncthreads();  // buffer j & 1 is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / l;
    const int row = rows[i];
    if (row >= L) continue;
    float* dst = out + head_base + (size_t)row * row_stride + 2 * tq;
#pragma unroll
    for (int n = 0; n < kKSteps; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, const uint8_t* mask, void* out, int B,
                int L, int H, float scale, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const int err = allow_smem(tf32_kernel<D>, done, TfLayout<D>::kBytes);
  if (err) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  tf32_kernel<D><<<grid, kTfThreads, TfLayout<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), mask,
      static_cast<float*>(out), L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, L, H, D] bf16 (f32 = 0) or f32 (f32 = 1), contiguous, 16-byte
// aligned; mask: [B, L] uint8 (1 = key present).  D is 16, 32 or 64, 1 <= L <=
// 512.  Returns a cudaError_t (0 on success); shapes are checked by the Python
// wrapper.
extern "C" int pw_attention(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int B, int L, int H, int D, float scale, int f32,
                            void* stream) {
  if (B == 0) return 0;
  if (L < 1 || L > kMaxLen) return (int)cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    if (D == 64) return launch_tf32<64>(q, k, v, m, out, B, L, H, scale, s);
    if (D == 32) return launch_tf32<32>(q, k, v, m, out, B, L, H, scale, s);
    if (D == 16) return launch_tf32<16>(q, k, v, m, out, B, L, H, scale, s);
  } else {
    if (D == 64) return launch_wgmma<64>(q, k, v, m, out, B, L, H, scale, s);
    if (D == 32) return launch_wgmma<32>(q, k, v, m, out, B, L, H, scale, s);
    if (D == 16) return launch_wgmma<16>(q, k, v, m, out, B, L, H, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
