// K15: the backward of K1's masked softmax attention, f32.
//
// Replaces: the transpose XLA derives for the attention core of
//   SelfAttention.__call__ (pathway_tpu/models/encoder.py:113-117) under
//   jax.value_and_grad in the contrastive train step
//   (__graft_entry__.py:117-131).  With s = q.k^T / sqrt(Dr) + bias (bias
//   -1e30 on a masked key), p = softmax(s) and o = p.v, for the output's
//   gradient dO:
//     dv = p^T . dO;  dp = dO . v^T;  ds = p * (dp - rowsum(dO * o));
//     dq = ds . k / sqrt(Dr);  dk = ds^T . q / sqrt(Dr).
//   p is recomputed from q, k and K1's saved log-sum-exp (lse): p =
//   exp(s - lse).  A batch row with no present key is the uniform average
//   of v in the forward (every logit -1e30, p = 1 / L); its p is that, and
//   its gradient follows from it as the plain version's autograd gives it.
//
// What bounds it on an H100: operations.  The five products do
// 10 * B * H * L * keys * Dr operations against the bytes of q, k, v, o,
// dO (read) and dq, dk, dv (written), 32 * B * L * H * Dr: at the train
// step's B=64 L=128 H=12 Dr=64 that is 8.05 GFLOP against 0.2 GB a layer,
// 40 operations a byte.  On the FMA units (67 TFLOP/s f32) the products
// bound it at 0.12 ms a layer; the bytes at 0.06 ms.
//
// What the design does about it: a simple, exact form first.  Two kernels,
// f32 FMA on tiles in shared memory, 64 x 64 each, 256 threads owning a
// 4 x 4 block of a tile product (rows ty + 16 a, columns tx + 16 b, so a
// warp's reads of the row operand broadcast and of the column operand fall
// on consecutive words; tiles are [64][D + 1], an odd pitch, so a column
// read is conflict-free too):
//  - dq_kernel: a block owns 64 query rows of one (batch, head); it first
//    writes delta = rowsum(dO * o) for them (read by dkv_kernel), then
//    walks the key tiles, recomputing s and dp, and sums ds . k.
//  - dkv_kernel: a block owns 64 keys; it walks every query tile,
//    recomputes s, p, dp and ds, and sums p^T . dO and ds^T . q.
// Both walk only the key tiles that hold a present key, as K1 does, when
// the batch row has one: a masked key's p is exactly 0, so its dk and dv
// are 0 and its ds adds nothing to dq.  Query rows past L and keys past L
// get p = 0.  Head dims: any multiple of 8 up to 128, run in the tile of
// 16, 32, 64 or 128 at or above it with zero columns.  Two launches a call.
// Making it fast (3xTF32 or wgmma, one pass over the keys with dq by
// atomics) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

using pw_sm90::allow_smem;

constexpr int kTile = 64;      // query rows and keys of a tile
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 block each
constexpr float kMaskBias = -1e30f;

template <int D>
struct Layout {
  static constexpr int kLd = D + 1;               // pitch of a [64, D] tile
  static constexpr int kRows = kTile * kLd;       // floats of a [64, D] tile
  static constexpr int kSq = kTile * (kTile + 1);  // floats of a [64, 64] tile
  // four [64, D] tiles, two [64, 64] tiles, and 4 x 64 row values
  static constexpr int kBytes = (4 * kRows + 2 * kSq + 4 * kTile) * 4;
};

// Rows [row0, row0 + 64) of one head of a [B, L, H, Dr] f32 tensor (src at
// the head's first element of row 0, rows row_stride apart) into a [64][D
// + 1] tile; rows past L and columns past Dr are zero.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0, int L,
                                          int row_stride, int Dr) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    dst[r * (D + 1) + c] = row0 + r < L && c < Dr ? src[(size_t)(row0 + r) * row_stride + c] : 0.0f;
  }
}

// 1 when the mask row has a present key; every thread takes part.
__device__ __forceinline__ int row_present(const uint8_t* __restrict__ mask_row, int L) {
  int any = 0;
  for (int j = threadIdx.x; j < L; j += kThreads) any |= mask_row[j] != 0;
  return __syncthreads_or(any);
}

// The bias of the tile's keys into kb (0 present, -1e30 masked, NaN past
// L, read as "no key"); returns whether the tile holds a present key.
__device__ __forceinline__ int key_tile(const uint8_t* __restrict__ mask_row, int j0, int L, float* kb) {
  int live = 0;
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    const bool in = j < L;
    live = in && mask_row[j] != 0;
    kb[threadIdx.x] = !in ? NAN : (live ? 0.0f : kMaskBias);
  }
  return __syncthreads_or(live);
}

// The 4 x 4 blocks of s = q.k^T and dp = dO.v^T this thread owns: rows
// (queries) ty + 16 a, columns (keys) tx + 16 b.
template <int D>
__device__ __forceinline__ void products(const float* q_s, const float* k_s, const float* do_s, const float* v_s,
                                         int ty, int tx, float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = q_s[(ty + 16 * a) * kLd + d];
      oa[a] = do_s[(ty + 16 * a) * kLd + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = k_s[(tx + 16 * b) * kLd + d];
      vb[b] = v_s[(tx + 16 * b) * kLd + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
}

// p and ds of the thread's 4 x 4 block from s and dp: p = exp(s * scale +
// bias - lse) (1 / L for a batch row with no present key; 0 past L), ds =
// p * (dp - delta).
__device__ __forceinline__ void softmax_grad(float (&s)[4][4], float (&dp)[4][4], const float* kb,
                                             const float* lse_s, const float* delta_s, int ty, int tx, int i0,
                                             int L, int present, float scale, float inv_l) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float bias = kb[tx + 16 * b];
      float p;
      if (i0 + i >= L || isnan(bias)) p = 0.0f;
      else if (!present) p = inv_l;
      else p = expf(fmaf(s[a][b], scale, bias) - lse_s[i]);
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - delta_s[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ dout, const uint8_t* __restrict__ mask,
          const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta, int L, int H,
          int Dr, float scale) {
  using S = Layout<D>;
  constexpr int kLd = S::kLd;
  constexpr int kC = D / 16;  // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + S::kRows;
  float* k_s = do_s + S::kRows;
  float* v_s = k_s + S::kRows;
  float* ds_s = v_s + S::kRows;  // [query][key]
  float* lse_s = ds_s + 2 * S::kSq;
  float* delta_s = lse_s + kTile;
  float* kb = delta_s + kTile;

  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int row_stride = H * Dr;
  const size_t head = (size_t)b * L * row_stride + (size_t)h * Dr;
  const size_t state = ((size_t)b * H + h) * L;  // [B, H, L] row of query 0
  const uint8_t* mask_row = mask + (size_t)b * L;

  load_rows<D>(q_s, q + head, i0, L, row_stride, Dr);
  load_rows<D>(do_s, dout + head, i0, L, row_stride, Dr);
  {  // delta = rowsum(dO * o): four threads a row
    const int r = tid / 4;
    float acc = 0.0f;
    if (i0 + r < L) {
      const float* orow = o + head + (size_t)(i0 + r) * row_stride;
      const float* drow = dout + head + (size_t)(i0 + r) * row_stride;
      for (int c = tid % 4; c < Dr; c += 4) acc = fmaf(drow[c], orow[c], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (tid % 4 == 0) {
      delta_s[r] = acc;
      lse_s[r] = i0 + r < L ? lse[state + i0 + r] : 0.0f;
      if (i0 + r < L) delta[state + i0 + r] = acc;
    }
  }
  const int present = row_present(mask_row, L);
  const float inv_l = 1.0f / (float)L;

  float acc[4][kC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.0f;

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    __syncthreads();  // the previous tile's k, v, kb and ds are read
    const int live = key_tile(mask_row, j0, L, kb);
    if (present && !live) continue;
    load_rows<D>(k_s, k + head, j0, L, row_stride, Dr);
    load_rows<D>(v_s, v + head, j0, L, row_stride, Dr);
    __syncthreads();
    float s[4][4], dp[4][4];
    products<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
    softmax_grad(s, dp, kb, lse_s, delta_s, ty, tx, i0, L, present, scale, inv_l);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b2 = 0; b2 < 4; ++b2) ds_s[(ty + 16 * a) * (kTile + 1) + tx + 16 * b2] = dp[a][b2];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) kc[c] = k_s[j * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = ds_s[(ty + 16 * a) * (kTile + 1) + j];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[a][c] = fmaf(d, kc[c], acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dr) dq[head + (size_t)i * row_stride + col] = acc[a][c] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const uint8_t* __restrict__ mask, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int L, int H, int Dr,
           float scale) {
  using S = Layout<D>;
  constexpr int kLd = S::kLd;
  constexpr int kC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + S::kRows;
  float* k_s = do_s + S::kRows;
  float* v_s = k_s + S::kRows;
  float* p_s = v_s + S::kRows;    // [query][key]
  float* ds_s = p_s + S::kSq;     // [query][key]
  float* lse_s = ds_s + S::kSq;
  float* delta_s = lse_s + kTile;
  float* kb = delta_s + kTile;

  const int j0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int row_stride = H * Dr;
  const size_t head = (size_t)b * L * row_stride + (size_t)h * Dr;
  const size_t state = ((size_t)b * H + h) * L;
  const uint8_t* mask_row = mask + (size_t)b * L;

  const int present = row_present(mask_row, L);
  const int live = key_tile(mask_row, j0, L, kb);
  float acc_k[4][kC], acc_v[4][kC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[a][c] = acc_v[a][c] = 0.0f;

  if (!present || live) {  // else no query attends to these keys: zeros
    load_rows<D>(k_s, k + head, j0, L, row_stride, Dr);
    load_rows<D>(v_s, v + head, j0, L, row_stride, Dr);
    const float inv_l = 1.0f / (float)L;
    const int n_tiles = (L + kTile - 1) / kTile;
    for (int t = 0; t < n_tiles; ++t) {
      const int i0 = t * kTile;
      __syncthreads();  // the previous tile's q, dO, p and ds are read
      load_rows<D>(q_s, q + head, i0, L, row_stride, Dr);
      load_rows<D>(do_s, dout + head, i0, L, row_stride, Dr);
      if (tid < kTile) {
        lse_s[tid] = i0 + tid < L ? lse[state + i0 + tid] : 0.0f;
        delta_s[tid] = i0 + tid < L ? delta[state + i0 + tid] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      products<D>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
      softmax_grad(s, dp, kb, lse_s, delta_s, ty, tx, i0, L, present, scale, inv_l);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b2 = 0; b2 < 4; ++b2) {
          p_s[(ty + 16 * a) * (kTile + 1) + tx + 16 * b2] = s[a][b2];
          ds_s[(ty + 16 * a) * (kTile + 1) + tx + 16 * b2] = dp[a][b2];
        }
      __syncthreads();
      // this thread's keys ty + 16 a, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        float qc[kC], oc[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          qc[c] = q_s[i * kLd + tx + 16 * c];
          oc[c] = do_s[i * kLd + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = p_s[i * (kTile + 1) + ty + 16 * a];
          const float d = ds_s[i * (kTile + 1) + ty + 16 * a];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc_v[a][c] = fmaf(p, oc[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(d, qc[c], acc_k[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= L) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dr) {
        dk[head + (size_t)j * row_stride + col] = acc_k[a][c] * scale;
        dv[head + (size_t)j * row_stride + col] = acc_v[a][c];
      }
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const uint8_t* mask, const float* lse, float* dq, float* dk, float* dv, float* delta, int B, int L,
           int H, int Dr, float scale, cudaStream_t stream) {
  constexpr int kBytes = Layout<D>::kBytes;
  static std::atomic<unsigned> done_q{0}, done_kv{0};
  int err = allow_smem(dq_kernel<D>, done_q, kBytes);
  if (!err) err = allow_smem(dkv_kernel<D>, done_kv, kBytes);
  if (err) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  dq_kernel<D><<<grid, kThreads, kBytes, stream>>>(q, k, v, o, dout, mask, lse, dq, delta, L, H, Dr, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dkv_kernel<D><<<grid, kThreads, kBytes, stream>>>(q, k, v, dout, mask, lse, delta, dk, dv, L, H, Dr, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (K1's output), dout (its gradient), dq, dk, dv: [B, L, H, D]
// f32, contiguous; mask: [B, L] uint8 (1 = key present); lse: [B, H, L]
// f32 (K1's); delta: [B, H, L] f32 scratch.  D a multiple of 8 up to 128;
// B, H <= 65,535.  Two launches.  Returns a cudaError_t.
extern "C" int pw_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                const void* mask, const void* lse, void* dq, void* dk, void* dv, void* delta,
                                int B, int L, int H, int D, float scale, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (D < 8 || D % 8 || D > 128 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* df = static_cast<const float*>(dout);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* lf = static_cast<const float*>(lse);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* de = static_cast<float*>(delta);
  if (D <= 16) return launch<16>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
  if (D <= 32) return launch<32>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
  if (D <= 64) return launch<64>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
  return launch<128>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
}
