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
//   Query rows and keys past L get p = 0; a masked key's p is exactly 0,
//   so only key tiles with a present key are walked when the batch row has
//   one.  Head dims: any multiple of 8 up to 128, run in the tile of 16,
//   32, 64 or 128 at or above it with zero columns.
//
// What bounds it on an H100: bytes, once the products run on the tensor
// cores.  The five products do 10 * B * H * L * keys * Dr operations against
// the bytes of q, k, v, o, dO (read) and dq, dk, dv (written), 32 * B * L
// * H * Dr: at the train step's B=64 L=128 H=12 Dr=64 8.05 GFLOP against
// 0.2 GB a layer.  On the FMA units (67 TFLOP/s f32) the products alone
// take 0.12 ms; as 3xTF32 on the tensor cores (165 TFLOP/s of f32
// product) 0.049 ms, under the bytes' 0.060 ms.
//
// Two forms; the wrapper picks one by shape (attention.py's bwd_form):
//
// The cluster form (cl::, L <= 512 and head dims up to 64, the limits
// attention.py sets: the train step's shape and every shorter one), one
// launch, after FlashAttention-2's
// backward.  A block of 8 warps owns 128 keys of one (batch, head); the
// ceil(L / 128) <= 4 blocks of a (batch, head) are one thread block
// cluster (one block at the train step's L = 128).  The block keeps its K
// and V in shared memory for the whole call, split once into TF32 high and
// low parts, and walks the query tiles of 64 rows.  For each it loads Q
// and dO, split as they land, the rows' lse and delta = rowsum(dO * o)
// (every block takes delta of the tile itself, from dO and o as it loads
// them: another block's reads come from L2), then
//  - S^T = K.Q^T and dP^T = V.dO^T, a warp 16 keys by the 64 rows;
//  - P^T = exp(S^T * scale + bias - lse) and dS^T = P^T * (dP^T - delta)
//    in registers;
//  - dV += P^T.dO and dK += dS^T.Q straight from those registers (their
//    accumulator layout read as the A operand), summed over the tiles in
//    the outputs' rows, which only this warp writes;
//  - dS^T through shared memory, and dQ's partial over the block's keys,
//    dS.K, a warp 16 rows by half the dims.
// All five are 3xTF32 mma.sync m16n8k8 (csrc/tf32x3.cuh).  The tensor
// cores truncate as they accumulate: S and dP keep the large hi.hi
// products and the small ones in two sums, and dK, dV and dQ sum each 32
// rows or keys fresh, all added in f32.  A warp whose 16 keys no row
// attends (masked, in a row with a present key) computes nothing, and dQ's
// product skips such key octets: the ragged batches of the train step
// leave a third of the keys so.  dQ without atomics: with one block its
// warps write the rows, and the block syncs before the next tile's Q lands
// over dS^T; with several, each block leaves its partial tile
// in shared memory, the cluster syncs, each rank sums a share of the
// tile's rows over the blocks in rank order through distributed shared
// memory and writes them (one rank a row), and the cluster syncs again
// before the space is reused: the same bits on every call.  The next
// tile's loads are issued before dQ's product, so their latency hides
// behind it.  Shared memory 209 KB at D = 64: one block (8 warps) an SM,
// which is what bounds it now: the warps' dependent chains of loads,
// splits and products leave the issue slots mostly idle.
//
// The two-pass form (tp::, longer sequences and head dims above 64, whose
// tiles do not fit the cluster form's shared memory and registers): the
// first simple form.  Two kernels, f32 FMA on tiles in shared memory, 64 x
// 64 each, 256 threads owning a 4 x 4 block of a tile product (rows ty +
// 16 a, columns tx + 16 b, so a warp's reads of the row operand broadcast
// and of the column operand fall on consecutive words; tiles are [64][D +
// 1], an odd pitch, so a column read is conflict-free too):
//  - dq_kernel: a block owns 64 query rows of one (batch, head); it first
//    writes delta = rowsum(dO * o) for them (read by dkv_kernel), then
//    walks the key tiles, recomputing s and dp, and sums ds . k.
//  - dkv_kernel: a block owns 64 keys; it walks every query tile,
//    recomputes s, p, dp and ds, and sums p^T . dO and ds^T . q.
// Seven tile products where five do, on the FMA units.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include <cooperative_groups.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;
using pw_sm90::allow_smem;

namespace tp {

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

}  // namespace tp

namespace cl {

using pw_tf32x3::mma_3xtf32;
using pw_tf32x3::mma_tf32;
using pw_tf32x3::split_tf32;

constexpr int kKeys = 128;          // keys a block owns
constexpr int kRows = 64;           // query rows of a step of its walk
constexpr int kWarps = 8;           // a warp: 16 keys (S^T, dP^T, dK, dV); 16 rows x half the dims (dQ)
constexpr int kThreads = 32 * kWarps;
// The form's limits come from the wrapper (kernels/attention.py's
// BWD_CLUSTER_MAX_LEN and BWD_CLUSTER_MAX_HEAD_DIM, passed by
// kernels/_build.py as -D flags): the choice of form and this form's
// checks read the same two numbers.
#if !defined(PW_BWD_CLUSTER_MAX_LEN) || !defined(PW_BWD_CLUSTER_MAX_HEAD_DIM)
#error "build with -DPW_BWD_CLUSTER_MAX_LEN=... -DPW_BWD_CLUSTER_MAX_HEAD_DIM=... (kernels/_build.py sets them)"
#endif
constexpr int kMaxLen = PW_BWD_CLUSTER_MAX_LEN;
constexpr int kMaxHeadDim = PW_BWD_CLUSTER_MAX_HEAD_DIM;
constexpr int kMaxCluster = kMaxLen / kKeys;  // blocks of a (batch, head)
static_assert(kMaxLen % kKeys == 0 && kMaxCluster >= 1 && kMaxCluster <= 8,
              "the cluster form takes whole blocks of 128 keys, at most 8 (a portable cluster)");
static_assert(kMaxHeadDim >= 8 && kMaxHeadDim <= 64 && kMaxHeadDim % 8 == 0,
              "the cluster form's tiles fit shared memory up to head dim 64");
constexpr float kMaskBias = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in floats; every tile has a pitch of 4 mod 32 words, so
// each fragment read below falls on 32 distinct banks:
//  - K and V [128][D + 4], split into TF32 hi and lo once, for the whole
//    call;
//  - Q and dO of the query tile [64][D + 4], split into TF32 hi and lo as
//    they land;
//  - dS^T [128 keys][68], over Q's hi and lo once they are read (apart
//    below D = 64), and the partial dQ tile [64][D + 4] over dO's hi;
//  - the tile's lse and delta rows, the keys' bias.
// 209 KB at D = 64: one block (8 warps) an SM.
template <int D>
struct Layout {
  static constexpr int kLd = D + 4;
  static constexpr int kLdS = kRows + 4;
  static constexpr int kKV = kKeys * kLd;
  static constexpr int kT = kRows * kLd;
  static constexpr int kKh = 0, kKl = kKV, kVh = 2 * kKV, kVl = 3 * kKV;
  static constexpr int kQh = 4 * kKV, kQl = kQh + kT, kOh = kQl + kT, kOl = kOh + kT;
  static constexpr int kEnd = kOl + kT;
  static constexpr bool kDsOverQ = kKeys * kLdS <= 2 * kT;
  static constexpr int kDsT = kDsOverQ ? kQh : kEnd;
  static constexpr int kDq = kOh;
  static constexpr int kLse = kDsOverQ ? kEnd : kDsT + kKeys * kLdS;
  static constexpr int kDelta = kLse + kRows, kBias = kDelta + kRows;
  static constexpr int kBytes = (kBias + kKeys) * 4;
};

__device__ __forceinline__ float4 f4add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void store_split(uint32_t* hi, uint32_t* lo, int at, float4 x) {
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + at) = h;
  *reinterpret_cast<uint4*>(lo + at) = l;
}

// c = A.B^T for A a warp's 16 rows (kr + g, kr + g + 8) of a split tile
// (pitch kLd) and B the 64 rows of another, over D: c[n] is the
// accumulator of row octet n.  The tensor cores truncate as they
// accumulate, and the error of s comes out of exp() relative: the large
// hi.hi products go into one sum and the small lo.hi and hi.lo into
// another, added in f32 at the end.
template <int kOct, int kLd>
__device__ __forceinline__ void rows_product(const uint32_t* a_h, const uint32_t* a_l, const uint32_t* bh,
                                             const uint32_t* bl, float (&c)[8][4], int kr, int g, int tq) {
  float small[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = small[n][e] = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < kOct; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (kr + g + 8 * (e & 1)) * kLd + 8 * kk + tq + 4 * (e >> 1);
      ah[e] = a_h[at];
      al[e] = a_l[at];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int at = (8 * n + g) * kLd + 8 * kk + tq;
      const uint32_t b0h = bh[at], b1h = bh[at + 4];
      mma_tf32(small[n], al, b0h, b1h);
      mma_tf32(small[n], ah, bl[at], bl[at + 4]);
      mma_tf32(c[n], ah, b0h, b1h);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += small[n][e];
}

// c = A.B over the tile's 64 query rows, A (16 keys x 64 rows) in the
// accumulator layout of S^T (a[n]: row octet n), B [row][column] split in
// shared memory (pitch kLd): the accumulator layout read as the A operand
// (k index tq is row 2 tq of the octet, tq + 4 is row 2 tq + 1, and B's
// rows are read in that order); 32 rows a fresh sum, added in f32.
template <int kOct, int kLd>
__device__ __forceinline__ void transposed_product(const float (&a)[8][4], const uint32_t* bh, const uint32_t* bl,
                                                   float (&c)[kOct][4], int g, int tq) {
#pragma unroll
  for (int dn = 0; dn < kOct; ++dn) c[dn][0] = c[dn][1] = c[dn][2] = c[dn][3] = 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float part[kOct][4];
#pragma unroll
    for (int dn = 0; dn < kOct; ++dn) part[dn][0] = part[dn][1] = part[dn][2] = part[dn][3] = 0.0f;
#pragma unroll
    for (int n = 4 * half; n < 4 * half + 4; ++n) {
      uint32_t ah[4], al[4];
      split_tf32(a[n][0], ah[0], al[0]);
      split_tf32(a[n][2], ah[1], al[1]);
      split_tf32(a[n][1], ah[2], al[2]);
      split_tf32(a[n][3], ah[3], al[3]);
#pragma unroll
      for (int dn = 0; dn < kOct; ++dn) {
        const int at = (8 * n + 2 * tq) * kLd + 8 * dn + g;
        mma_3xtf32(part[dn], ah, al, bh[at], bl[at], bh[at + kLd], bl[at + kLd]);
      }
    }
#pragma unroll
    for (int dn = 0; dn < kOct; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[dn][e] += part[dn][e];
  }
}

// The warp's 16 keys' rows of dK or dV (out at the head's row 0): the
// tile's sum c added to what the earlier tiles left there (the first
// writes it as is), times `mul` on the last tile.  Each key belongs to one
// block and warp: the sum over the tiles is in their order.
template <int kOct>
__device__ __forceinline__ void add_rows(float* __restrict__ out, const float (&c)[kOct][4], int key0, int L,
                                         int row_stride, int Dr, int g, int tq, bool first, bool last, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= L) continue;
#pragma unroll
    for (int dn = 0; dn < kOct; ++dn) {
      const int col = 8 * dn + 2 * tq;
      if (col >= Dr) continue;
      float2* at = reinterpret_cast<float2*>(out + (size_t)key * row_stride + col);
      float2 x = make_float2(c[dn][2 * i], c[dn][2 * i + 1]);
      if (!first) {
        const float2 prev = *at;
        x.x += prev.x;
        x.y += prev.y;
      }
      if (last) {
        x.x *= mul;
        x.y *= mul;
      }
      *at = x;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ o, const float* __restrict__ dout, const uint8_t* __restrict__ mask,
           const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
           int L, int H, int Dr, float scale) {
  using S = Layout<D>;
  constexpr int kLd = S::kLd;
  constexpr int kOct = D / 8;            // column octets of a head; k-steps over its dims
  constexpr int kHalfOct = kOct / 2;     // a warp's column octets of dQ
  constexpr int kChunks = D / 4;         // float4 of a row
  constexpr int kQuarter = kChunks / 4;  // float4 of a thread's quarter row
  extern __shared__ __align__(16) float smem[];
  uint32_t* kh = reinterpret_cast<uint32_t*>(smem + S::kKh);
  uint32_t* kl = reinterpret_cast<uint32_t*>(smem + S::kKl);
  uint32_t* vh = reinterpret_cast<uint32_t*>(smem + S::kVh);
  uint32_t* vl = reinterpret_cast<uint32_t*>(smem + S::kVl);
  uint32_t* qh = reinterpret_cast<uint32_t*>(smem + S::kQh);
  uint32_t* ql = reinterpret_cast<uint32_t*>(smem + S::kQl);
  uint32_t* oh = reinterpret_cast<uint32_t*>(smem + S::kOh);
  uint32_t* ol = reinterpret_cast<uint32_t*>(smem + S::kOl);
  float* ds_t = smem + S::kDsT;
  float* dq_part = smem + S::kDq;
  float* lse_s = smem + S::kLse;
  float* delta_s = smem + S::kDelta;
  float* kb = smem + S::kBias;
  __shared__ uint32_t block_bits[kWarps];
  __shared__ uint32_t octet_bits[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_kb = (L + kKeys - 1) / kKeys;  // the cluster's blocks
  const int n_qt = (L + kRows - 1) / kRows;  // the walk's query tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = rank * kKeys;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int row_stride = H * Dr;
  const size_t head = (size_t)b * L * row_stride + (size_t)h * Dr;
  const size_t state = ((size_t)b * H + h) * L;
  const uint8_t* mask_row = mask + (size_t)b * L;

  // which blocks' keys hold a present key of the batch row
  uint32_t bits = 0;
  for (int j = tid; j < L; j += kThreads) bits |= mask_row[j] ? 1u << (j / kKeys) : 0u;
  bits = __reduce_or_sync(0xffffffffu, bits);
  if (lane == 0) block_bits[warp] = bits;
  if (tid < kKeys) {
    const int j = j0 + tid;
    kb[tid] = j < L && mask_row[j] ? 0.0f : kMaskBias;
  }
  __syncthreads();
  bits = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) bits |= block_bits[w];
  const bool present = bits != 0;
  const uint32_t walking = present ? bits : (1u << n_kb) - 1;  // blocks that compute
  const bool walk = (walking >> rank) & 1;
  const float inv_l = 1.0f / (float)L;
  const int kr = 16 * warp;             // this warp's keys kr + g (+ 8) of the block
  const int qr = 16 * (warp % 4);       // ... and its dQ rows qr + g (+ 8)
  const int c0 = (warp / 4) * kHalfOct;  // ... and column octets c0..
  // the warp's keys that a row attends (present, or every key of a row
  // with none): a warp with none computes nothing of S^T to dK, and dQ's
  // product skips key octets with none (read once the tile's barrier has
  // passed)
  const int own_key = j0 + kr + (lane & 15);
  const uint32_t attended =
      __ballot_sync(0xffffffffu, lane < 16 && own_key < L && (!present || kb[kr + (lane & 15)] == 0.0f));
  const bool warp_live = attended != 0;
  if (lane == 0) octet_bits[warp] = (attended & 0xffu ? 1u : 0u) | (attended & 0xff00u ? 2u : 0u);

  if (walk) {  // K and V of the block's keys, split: every load issued first
    constexpr int kPer = kKeys * kChunks / kThreads;
    float4 xk[kPer], xv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + u * kThreads;
      const int r = c / kChunks;
      const int col = (c % kChunks) * 4;
      const bool in = j0 + r < L && col < Dr;
      const size_t at = head + (size_t)(j0 + r) * row_stride + col;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xk[u] = in ? __ldg(reinterpret_cast<const float4*>(k + at)) : zero;
      xv[u] = in ? __ldg(reinterpret_cast<const float4*>(v + at)) : zero;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = tid + u * kThreads;
      const int at = c / kChunks * kLd + (c % kChunks) * 4;
      store_split(kh, kl, at, xk[u]);
      store_split(vh, vl, at, xv[u]);
    }
  } else {  // no query attends to these keys: dK and dV are zero
    const float zero[kOct][4] = {};
    add_rows<kOct>(dk + head, zero, j0 + kr, L, row_stride, Dr, g, tq, true, false, 1.0f);
    add_rows<kOct>(dv + head, zero, j0 + kr, L, row_stride, Dr, g, tq, true, false, 1.0f);
  }

  // Q, dO and o of a query tile into registers, a thread a quarter row,
  // every load issued at once; the next tile's are fetched as soon as this
  // one's Q and dO are read, so their latency hides behind dQ's product
  const int fr = tid / 4;
  const int fc = (tid % 4) * kQuarter;
  float4 xq[kQuarter], xd[kQuarter], xo[kQuarter];
  float lse_r = 0.0f;
  auto fetch = [&](int i0) {
    const bool in = i0 + fr < L;
    const size_t row = head + (size_t)(i0 + fr) * row_stride;
#pragma unroll
    for (int u = 0; u < kQuarter; ++u) {
      const int col = 4 * (fc + u);
      const bool live = in && col < Dr;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xq[u] = live ? __ldg(reinterpret_cast<const float4*>(q + row + col)) : zero;
      xd[u] = live ? __ldg(reinterpret_cast<const float4*>(dout + row + col)) : zero;
      xo[u] = live ? __ldg(reinterpret_cast<const float4*>(o + row + col)) : zero;
    }
    lse_r = in ? lse[state + i0 + fr] : 0.0f;
  };
  if (walk) fetch(0);

  // with several blocks, this rank's rows of each query tile's dQ: [r_lo, r_hi)
  const int r_lo = rank * kRows / n_kb;
  const int r_hi = (rank + 1) * kRows / n_kb;
  for (int t = 0; t < n_qt; ++t) {
    const int i0 = t * kRows;
    float dqa[kHalfOct][4];
    if (walk) {
      {  // Q and dO split as they land, and delta = rowsum(dO * o)
        float acc = 0.0f;
#pragma unroll
        for (int u = 0; u < kQuarter; ++u) {
          const int at = fr * kLd + 4 * (fc + u);
          store_split(qh, ql, at, xq[u]);
          store_split(oh, ol, at, xd[u]);
          acc = fmaf(xd[u].x, xo[u].x, acc);
          acc = fmaf(xd[u].y, xo[u].y, acc);
          acc = fmaf(xd[u].z, xo[u].z, acc);
          acc = fmaf(xd[u].w, xo[u].w, acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (tid % 4 == 0) {
          delta_s[fr] = acc;
          lse_s[fr] = i0 + fr < L ? lse_r : INFINITY;  // a row past L: p = 0
        }
      }
      __syncthreads();

      uint32_t live_octets = 0;  // the block's key octets that a row attends
#pragma unroll
      for (int w = 0; w < kWarps; ++w) live_octets |= octet_bits[w] << (2 * w);

      // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 keys x the tile's 64 rows
      float s[8][4], dp[8][4];
      if (warp_live) {
        rows_product<kOct, kLd>(kh, kl, qh, ql, s, kr, g, tq);
        rows_product<kOct, kLd>(vh, vl, oh, ol, dp, kr, g, tq);
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      }
      // P^T and dS^T: keys kr + g (e 0, 1) and kr + g + 8 (e 2, 3), rows
      // 8 n + 2 tq + (e & 1).  p = exp(s * scale + bias - lse): 0 for a
      // masked key or a key past L (bias -1e30), 0 for a row past L (lse
      // +inf there); 1 / L over the keys below L for a row with no
      // present key
      bool key_on[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) key_on[i] = present ? kb[kr + g + 8 * i] == 0.0f : j0 + kr + g + 8 * i < L;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * tq);
        const float2 delta2 = *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_row = e & 1 ? lse2.y : lse2.x;
          float p;
          if (present) p = key_on[e >> 1] ? exp2f(fmaf(s[n][e], scale, -lse_row) * kLog2e) : 0.0f;
          else p = key_on[e >> 1] && lse_row < INFINITY ? inv_l : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - (e & 1 ? delta2.y : delta2.x));
        }
      }
      {  // dV += P^T.dO and dK += dS^T.Q, summed over the tiles in dv and dk
        float c[kOct][4] = {};
        const bool first = t == 0, last = t + 1 == n_qt;
        if (warp_live) transposed_product<kOct, kLd>(s, oh, ol, c, g, tq);
        if (warp_live || first) add_rows<kOct>(dv + head, c, j0 + kr, L, row_stride, Dr, g, tq, first, last, 1.0f);
        if (warp_live) transposed_product<kOct, kLd>(dp, qh, ql, c, g, tq);
        if (warp_live || first) add_rows<kOct>(dk + head, c, j0 + kr, L, row_stride, Dr, g, tq, first, last, scale);
      }
      __syncthreads();  // Q and dO are read: dS^T goes over Q's tiles
      if (t + 1 < n_qt) fetch(i0 + kRows);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(ds_t + (kr + g + 8 * i) * S::kLdS + 8 * n + 2 * tq) =
              make_float2(dp[n][2 * i], dp[n][2 * i + 1]);
      __syncthreads();
      // dQ's partial over the block's keys, dS.K: this warp's 16 rows x its
      // half of the columns; A = dS read from dS^T, B = K, both with the
      // key order k index tq -> key 2 tq, tq + 4 -> key 2 tq + 1 of the
      // octet; 32 keys a fresh sum, added in f32
#pragma unroll
      for (int dn = 0; dn < kHalfOct; ++dn) dqa[dn][0] = dqa[dn][1] = dqa[dn][2] = dqa[dn][3] = 0.0f;
#pragma unroll 1
      for (int quarter = 0; quarter < 4; ++quarter) {
        float part[kHalfOct][4];
#pragma unroll
        for (int dn = 0; dn < kHalfOct; ++dn) part[dn][0] = part[dn][1] = part[dn][2] = part[dn][3] = 0.0f;
#pragma unroll
        for (int n = 4 * quarter; n < 4 * quarter + 4; ++n) {
          if (!((live_octets >> n) & 1)) continue;  // every key of the octet has p = 0: dS = 0
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(ds_t[(8 * n + 2 * tq + (e >> 1)) * S::kLdS + qr + g + 8 * (e & 1)], ah[e], al[e]);
#pragma unroll
          for (int dn = 0; dn < kHalfOct; ++dn) {
            const int at = (8 * n + 2 * tq) * kLd + 8 * (c0 + dn) + g;
            mma_3xtf32(part[dn], ah, al, kh[at], kl[at], kh[at + kLd], kl[at + kLd]);
          }
        }
#pragma unroll
        for (int dn = 0; dn < kHalfOct; ++dn)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[dn][e] += part[dn][e];
      }
      if (n_kb > 1) {  // dO's hi tile is free since the barrier above
#pragma unroll
        for (int dn = 0; dn < kHalfOct; ++dn)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(dq_part + (qr + g + 8 * i) * kLd + 8 * (c0 + dn) + 2 * tq) =
                make_float2(dqa[dn][2 * i], dqa[dn][2 * i + 1]);
      }
    }
    if (n_kb == 1) {  // the block holds every key: its rows are dQ
      if (walk) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i0 + qr + g + 8 * i;
          if (row >= L) continue;
#pragma unroll
          for (int dn = 0; dn < kHalfOct; ++dn) {
            const int col = 8 * (c0 + dn) + 2 * tq;
            if (col < Dr)
              *reinterpret_cast<float2*>(dq + head + (size_t)row * row_stride + col) =
                  make_float2(dqa[dn][2 * i] * scale, dqa[dn][2 * i + 1] * scale);
          }
        }
      }
      // the warps' reads of dS^T are done before the next tile's Q lands
      // (dS^T lies over Q's hi and lo at D = 64)
      if (t + 1 < n_qt) __syncthreads();
      continue;
    }
    cluster.sync();  // every computing block's partial dQ tile is in its shared memory
    // this rank's rows of the tile: the blocks' partials summed in rank order
    for (int e = tid; e < (r_hi - r_lo) * kChunks; e += kThreads) {
      const int row = r_lo + e / kChunks;
      const int col = (e % kChunks) * 4;
      if (i0 + row >= L || col >= Dr) continue;
      float4 part[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < n_kb && ((walking >> r) & 1))
          part[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(dq_part + row * kLd + col, r));
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < n_kb && ((walking >> r) & 1)) acc = f4add(acc, part[r]);
      *reinterpret_cast<float4*>(dq + head + (size_t)(i0 + row) * row_stride + col) =
          make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
    }
    cluster.sync();  // every rank has read the partials: the space is free again
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const uint8_t* mask, const float* lse, float* dq, float* dk, float* dv, int B, int L, int H, int Dr,
           float scale, cudaStream_t stream) {
  constexpr int kBytes = Layout<D>::kBytes;
  static std::atomic<unsigned> done{0};
  int err = allow_smem(bwd_kernel<D>, done, kBytes);
  if (err) return err;
  const int n_kb = (L + kKeys - 1) / kKeys;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_kb, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_kb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, bwd_kernel<D>, q, k, v, o, dout, mask, lse, dq, dk, dv, L, H, Dr, scale);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace cl

}  // namespace

// q, k, v, o (K1's output), dout (its gradient), dq, dk, dv: [B, L, H, D]
// f32, contiguous; mask: [B, L] uint8 (1 = key present); lse: [B, H, L]
// f32 (K1's).  D a multiple of 8 up to 128; B, H <= 65,535.  form 1: the
// cluster form, one launch (L and D within its limits above; delta unused); form 0: the
// two-pass form, two launches, delta a [B, H, L] f32 scratch.  Returns a
// cudaError_t.
extern "C" int pw_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                const void* mask, const void* lse, void* dq, void* dk, void* dv, void* delta,
                                int B, int L, int H, int D, float scale, int form, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (D < 8 || D % 8 || D > 128 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (form == 1 ? L > cl::kMaxLen || D > cl::kMaxHeadDim : form != 0 || delta == nullptr)
    return (int)cudaErrorInvalidValue;
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
  if (form == 1) {
    if (D <= 16) return cl::launch<16>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, B, L, H, D, scale, s);
    if (D <= 32) return cl::launch<32>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, B, L, H, D, scale, s);
    return cl::launch<64>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, B, L, H, D, scale, s);
  }
  auto* de = static_cast<float*>(delta);
  if (D <= 16) return tp::launch<16>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
  if (D <= 32) return tp::launch<32>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
  if (D <= 64) return tp::launch<64>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
  return tp::launch<128>(qf, kf, vf, of, df, m, lf, dqf, dkf, dvf, de, B, L, H, D, scale, s);
}
