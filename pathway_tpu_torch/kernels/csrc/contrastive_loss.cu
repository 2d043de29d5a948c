// K18: the in-batch contrastive loss from the embeddings, its gradient with
// respect to them, and the backward of K7 (pooling + L2 normalise), f32.
//
// Replaces: loss_fn in __graft_entry__.py:117-124 with both of its dense
//   products, and the transpose XLA derives for it and for the encoder's
//   tail (pathway_tpu/models/encoder.py:196-202) under jax.value_and_grad:
//  - pw_contrastive_loss (forward): raw = emb . emb^T [B, B] from emb
//      [B, H]; x = raw * 20 - 1e9 on the diagonal (the JAX program's
//      order); lse_i = log sum_j exp(x_ij); loss = mean_i (lse_i -
//      x_{i, i^1}).  B is even: row i's positive is its pair partner i ^ 1.
//      raw and lse are kept for the backward.
//  - pw_contrastive_loss_bwd: d emb = g (G + G^T) . emb, with G = (softmax(x)
//      - onehot(i ^ 1)) * 20 / B = d loss / d raw rebuilt from raw and lse,
//      and g, the loss's incoming gradient, read from the card.
//  - pw_pool_normalize_bwd: from d emb [B, H] to d hidden [B, L, H]: the L2
//    normalise's backward (p / max(||p||, 1e-12): (g - e (e . g)) / ||p||,
//    or g / 1e-12 where the norm is below it), then CLS pooling's (row 0
//    gets it) or masked mean pooling's (each present token gets it over the
//    count).  The pooled row p is recomputed from the hidden rows.
//
// What bounds it on an H100: the loss, neither: at the train step's B = 64,
//   H = 768 each product is 6.3 MFLOP on 0.2 MB, far below a launch's time.
//   The pool backward, bytes: it writes d hidden whole ([64, 128, 768] f32,
//   25.2 MB, 7.5 us at 3.35 TB/s); the mean form also reads the hidden rows.
//
// What the design does about it: two launches for the loss, where the port
//   ran six (a cuBLAS product, the loss, a scale by g, and the product's
//   autograd: two more products and an add).  Each stages what it reads
//   into shared memory in one group of cp.async copies (16 bytes where the
//   rows are 16-byte aligned).  The forward is one cluster of
//   8 blocks for any even B: each block takes an eighth of H and computes
//   its partial 64 x 64 tiles of raw (FFMA, 4 x 4 outputs a thread, f32 as
//   the reference's product); the partial tiles are summed through
//   distributed shared memory in rank order, block q then owning rows
//   8 q .. 8 q + 7 of the tile, a warp a row, with a running max and sum of
//   exponentials over the tiles of the row; the rows' losses are summed by
//   each warp in order, the warps' in order and the blocks' in rank order,
//   so the loss is deterministic.  The backward tiles d emb in 64 x 64
//   blocks and forms G + G^T a chunk at a time from raw and lse, summing
//   over the batch in order.  The pool backward spreads d hidden over all
//   B L rows (CLS: 8 rows a block, the normalise backward computed only by
//   the block holding row 0; mean: a cluster of up to 8 blocks a sequence,
//   whose partial sums of the present rows are added in rank order), with
//   16-byte stores and no division per element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using pw_sm90::allow_smem;

constexpr int kSplit = 8;          // blocks of the forward's cluster, an eighth of H each
constexpr int kTile = 64;          // rows and columns of a tile of raw (rows and columns of d emb in the backward)
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFwdK = 96;          // depth of the forward's staged chunk (an eighth of H = 768)
constexpr int kFwdPitch = kFwdK + 4;  // 25 float4s: rows tx and tx + 1 on other banks
constexpr int kPp = kTile + 1;     // pitch of a partial tile's rows
constexpr int kBwdJ = 64;          // batch rows j of the backward's chunk
constexpr int kTp = kTile + 4;     // pitch of the backward's [j][i] and [j][h] tiles (float4 reads)
constexpr int kPoolThreads = 256;
constexpr int kClsRows = 8;        // rows of d hidden a CLS block writes
constexpr int kMaxCluster = 8;     // blocks a sequence in the mean form
constexpr int kMaxHidden = 2048;

// dynamic shared memory of the two loss kernels, in floats
constexpr int kFwdFloats = 2 * kTile * kFwdPitch + kTile * kPp;
constexpr int kBwdFloats = kTile * kTp + kBwdJ * kTile + 2 * kBwdJ * kTp + kTile + kBwdJ;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// V floats (1, or 4 where the rows are 16-byte aligned) copied async into
// shared memory; in = false writes zeros
template <int V>
__device__ __forceinline__ void cp_async_v(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// dst[r][kk] = emb[row0 + r][k0 + kk] for r < kTile, kk < kFwdK; zero past
// B rows or past k1 (V = 4: H, k0 and k1 multiples of 4)
template <int V>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ emb, int row0, int B, int H,
                                           int k0, int k1) {
  constexpr int kPerRow = kFwdK / V;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow, kk = (c - r * kPerRow) * V;
    const bool in = row0 + r < B && k0 + kk < k1;
    cp_async_v<V>(dst + r * kFwdPitch + kk, in ? emb + (size_t)(row0 + r) * H + k0 + kk : emb, in);
  }
}

__device__ __forceinline__ float logit(float raw, int i, int j, float scale, float diag) {
  const float x = __fmul_rn(raw, scale);
  return i == j ? __fsub_rn(x, diag) : x;
}

template <int V>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
loss_fwd_kernel(const float* __restrict__ emb, float* __restrict__ loss, float* __restrict__ lse,
                float* __restrict__ raw, int B, int H, float scale, float diag) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                           // [kTile][kFwdPitch]: the stripe's rows, a chunk of this block's H
  float* Bt = A + kTile * kFwdPitch;         // [kTile][kFwdPitch]: the tile's rows (off the diagonal)
  float* part = Bt + kTile * kFwdPitch;      // [kTile][kPp]: this block's partial tile
  __shared__ float red[kThreads / 32];
  __shared__ float block_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = ((H + kSplit - 1) / kSplit + 3) / 4 * 4;  // a multiple of 4, for 16-byte copies
  const int d0 = min(H, rank * per), d1 = min(H, d0 + per);
  const int row = 8 * rank + warp;  // of a tile: this warp's row after the cluster's sum
  float mine = 0.0f;                // this warp's rows' losses, stripe by stripe
  for (int i0 = 0; i0 < B; i0 += kTile) {
    const int i = i0 + row;
    float m = -INFINITY, s = 0.0f, pos = 0.0f;
    for (int j0 = 0; j0 < B; j0 += kTile) {
      // acc[a][b]: raw's partial at (ty + 16 a, tx + 16 b) of the tile
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
      const float* Bk = i0 == j0 ? A : Bt;
      for (int k0 = d0; k0 < d1; k0 += kFwdK) {
        __syncthreads();  // the last chunk is read
        stage_rows<V>(A, emb, i0, B, H, k0, d1);
        if (i0 != j0) stage_rows<V>(Bt, emb, j0, B, H, k0, d1);
        cp_async_wait_all();
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < kFwdK; kk += 4) {
          float4 av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * kFwdPitch + kk);
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = *reinterpret_cast<const float4*>(Bk + (tx + 16 * b) * kFwdPitch + kk);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              float c = acc[a][b];
              c = fmaf(av[a].x, bv[b].x, c);
              c = fmaf(av[a].y, bv[b].y, c);
              c = fmaf(av[a].z, bv[b].z, c);
              acc[a][b] = fmaf(av[a].w, bv[b].w, c);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) part[(ty + 16 * a) * kPp + tx + 16 * b] = acc[a][b];
      }
      cluster.sync();
      float xv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = lane + 32 * hh, j = j0 + col;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < kSplit; ++q) v += cluster.map_shared_rank(part, q)[row * kPp + col];
        xv[hh] = -INFINITY;
        if (i < B && j < B) {
          raw[(size_t)i * B + j] = v;
          xv[hh] = logit(v, i, j, scale, diag);
          if (j == (i ^ 1)) pos = xv[hh];
        }
      }
      const float mn = fmaxf(m, warp_max(fmaxf(xv[0], xv[1])));
      s = s * expf(m - mn) + warp_sum(expf(xv[0] - mn) + expf(xv[1] - mn));
      m = mn;
      cluster.sync();  // every block has read the partial tiles
    }
    pos = warp_sum(pos);  // one lane holds the partner's logit
    if (i < B) {
      const float l = m + logf(s);
      if (lane == 0) lse[i] = l;
      mine += l - pos;
    }
  }
  if (lane == 0) red[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    block_total = t;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float t = 0.0f;
    for (int q = 0; q < kSplit; ++q) t += *cluster.map_shared_rank(&block_total, q);
    *loss = t / (float)B;
  }
  cluster.sync();  // no block leaves while rank 0 still reads its sum
}

// G_ij = (exp(x_ij - lse_i) - [j == i ^ 1]) * 20 / B
__device__ __forceinline__ float grad_of(float raw, float lse_i, int i, int j, float scale, float diag,
                                         float g_scale) {
  return (expf(logit(raw, i, j, scale, diag) - lse_i) - (j == (i ^ 1) ? 1.0f : 0.0f)) * g_scale;
}

// RV: 4 where raw's rows are 16-byte aligned (B a multiple of 4); EV: 4
// where emb's are (H a multiple of 4)
template <int RV, int EV>
__global__ void __launch_bounds__(kThreads)
loss_bwd_kernel(const float* __restrict__ emb, const float* __restrict__ raw, const float* __restrict__ lse,
                const float* __restrict__ g, float* __restrict__ demb, int B, int H, float scale, float diag) {
  extern __shared__ __align__(16) float smem[];
  float* R1 = smem;                   // [kTile][kTp]: raw[i0 + r][j0 + jj]
  float* R2 = R1 + kTile * kTp;       // [kBwdJ][kTile]: raw[j0 + jj][i0 + r]
  float* Mt = R2 + kBwdJ * kTile;     // [kBwdJ][kTp]: (G + G^T)[i0 + r][j0 + jj] at [jj][r]
  float* Es = Mt + kBwdJ * kTp;       // [kBwdJ][kTp]: emb[j0 + jj][h0 + c]
  float* ls_i = Es + kBwdJ * kTp;     // [kTile]
  float* ls_j = ls_i + kTile;         // [kBwdJ]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * kTile, h0 = blockIdx.x * kTile;
  const float g_scale = scale / (float)B;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
  for (int j0 = 0; j0 < B; j0 += kBwdJ) {
    __syncthreads();  // the last chunk is read
    // everything the chunk needs, in one group of copies (zeros outside)
    for (int c = threadIdx.x; c < kTile * kBwdJ / RV; c += kThreads) {
      const int a = c / (kBwdJ / RV), b = (c - a * (kBwdJ / RV)) * RV;  // R1[a][b]: raw[i0 + a][j0 + b]
      const bool in1 = i0 + a < B && j0 + b < B;
      cp_async_v<RV>(R1 + a * kTp + b, in1 ? raw + (size_t)(i0 + a) * B + j0 + b : raw, in1);
      const int jr = c / (kTile / RV), ic = (c - jr * (kTile / RV)) * RV;  // R2[jr][ic]: raw[j0 + jr][i0 + ic]
      const bool in2 = j0 + jr < B && i0 + ic < B;
      cp_async_v<RV>(R2 + jr * kTile + ic, in2 ? raw + (size_t)(j0 + jr) * B + i0 + ic : raw, in2);
    }
    for (int c = threadIdx.x; c < kBwdJ * kTile / EV; c += kThreads) {
      const int jr = c / (kTile / EV), ic = (c - jr * (kTile / EV)) * EV;  // Es[jr][ic]: emb[j0 + jr][h0 + ic]
      const bool in3 = j0 + jr < B && h0 + ic < H;
      cp_async_v<EV>(Es + jr * kTp + ic, in3 ? emb + (size_t)(j0 + jr) * H + h0 + ic : emb, in3);
    }
    if (threadIdx.x < kTile) {
      const bool in = i0 + threadIdx.x < B;
      cp_async_v<1>(ls_i + threadIdx.x, in ? lse + i0 + threadIdx.x : lse, in);
    } else if (threadIdx.x < kTile + kBwdJ) {
      const int jj = threadIdx.x - kTile;
      const bool in = j0 + jj < B;
      cp_async_v<1>(ls_j + jj, in ? lse + j0 + jj : lse, in);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int c = threadIdx.x; c < kTile * kBwdJ; c += kThreads) {
      const int jj = c / kTile, r = c - jj * kTile;
      const int i = i0 + r, j = j0 + jj;
      Mt[jj * kTp + r] = i < B && j < B ? grad_of(R1[r * kTp + jj], ls_i[r], i, j, scale, diag, g_scale) +
                                              grad_of(R2[jj * kTile + r], ls_j[jj], j, i, scale, diag, g_scale)
                                        : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kBwdJ; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(Mt + jj * kTp + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Es + jj * kTp + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
      }
    }
  }
  const float gv = *g;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int h = h0 + 4 * tx + b;
      if (i < B && h < H) demb[(size_t)i * H + h] = acc[a][b] * gv;
    }
  }
}

// p (the pooled row) becomes d pooled in place, from gb, the gradient of
// K7's output: the normalise's backward, or gb itself without it.  Every
// thread of the block reads the same sums (warps added in order).
__device__ void normalise_bwd(float* p, const float* __restrict__ gb, int H, int normalize, float eps, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kPoolThreads / 32;
  if (!normalize) {
    for (int c = threadIdx.x; c < H; c += kPoolThreads) p[c] = gb[c];
    __syncthreads();
    return;
  }
  float ss = 0.0f;
  for (int c = threadIdx.x; c < H; c += kPoolThreads) ss += p[c] * p[c];
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float norm = 0.0f;
  for (int w = 0; w < kWarps; ++w) norm += red[w];
  norm = sqrtf(norm);
  const float den = fmaxf(norm, eps);
  __syncthreads();
  float eg = 0.0f;
  for (int c = threadIdx.x; c < H; c += kPoolThreads) eg += p[c] / den * gb[c];
  eg = warp_sum(eg);
  if (lane == 0) red[warp] = eg;
  __syncthreads();
  float dot = 0.0f;
  for (int w = 0; w < kWarps; ++w) dot += red[w];
  for (int c = threadIdx.x; c < H; c += kPoolThreads) {
    const float gc = gb[c];
    p[c] = norm > eps ? (gc - p[c] / den * dot) / den : gc / eps;
  }
  __syncthreads();
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<2> {
  using T = float2;
};

// Rows [l0, l1) of d hidden for batch row b: row l gets dq (a row of H
// floats in shared memory) where keep(l), else zeros; VEC floats a store,
// the row and vector indices stepped without a division.
template <int VEC, typename Keep>
__device__ __forceinline__ void write_rows(float* __restrict__ db, const float* dq, int l0, int l1, int H,
                                           Keep keep) {
  using V = typename Vec<VEC>::T;
  const int hv = H / VEC;
  const int total = (l1 - l0) * hv;
  const int dr = kPoolThreads / hv, dv = kPoolThreads % hv;
  int r = threadIdx.x / hv, v = threadIdx.x % hv;
  for (int i = threadIdx.x; i < total; i += kPoolThreads) {
    const int l = l0 + r;
    V out;
    if (keep(l)) {
      out = *reinterpret_cast<const V*>(dq + v * VEC);
    } else {
      float* o = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = 0.0f;
    }
    *reinterpret_cast<V*>(db + (size_t)l * H + v * VEC) = out;
    r += dr;
    v += dv;
    if (v >= hv) {
      v -= hv;
      ++r;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kPoolThreads)
pool_bwd_cls_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dh, int L, int H,
                    int normalize, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* p = sm;       // [H]: the CLS row, then d pooled
  float* red = p + H;  // [kPoolThreads / 32]
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * kClsRows, l1 = min(L, l0 + kClsRows);
  if (l0 == 0) {
    for (int c = threadIdx.x; c < H; c += kPoolThreads) p[c] = x[(size_t)b * L * H + c];
    __syncthreads();
    normalise_bwd(p, g + (size_t)b * H, H, normalize, eps, red);
  }
  write_rows<VEC>(dh + (size_t)b * L * H, p, l0, l1, H, [](int l) { return l == 0; });
}

template <int VEC>
__global__ void __launch_bounds__(kPoolThreads)
pool_bwd_mean_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask, const float* __restrict__ g,
                     float* __restrict__ dh, int L, int H, int rows, int normalize, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* psum = sm;        // [H]: this block's rows' sum
  float* p = psum + H;     // [H]: the pooled row, then d pooled over the count
  float* red = p + H;      // [kPoolThreads / 32]
  __shared__ float s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)gridDim.x;  // the cluster spans grid.x
  const int b = blockIdx.y;
  const int l0 = min(L, rank * rows), l1 = min(L, l0 + rows);
  const uint8_t* mb = mask + (size_t)b * L;
  const float* xb = x + (size_t)b * L * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int cnt = 0;
  for (int l = l0 + threadIdx.x; l < l1; l += kPoolThreads) cnt += mb[l] != 0;
  const float fc = warp_sum((float)cnt);
  if (lane == 0) red[warp] = fc;
  for (int c = threadIdx.x; c < H; c += kPoolThreads) {
    float s = 0.0f;
    for (int l = l0; l < l1; ++l)
      if (mb[l]) s += xb[(size_t)l * H + c];
    psum[c] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kPoolThreads / 32; ++w) t += red[w];
    s_count = t;
  }
  cluster.sync();
  float total = 0.0f;
  for (int q = 0; q < n_blocks; ++q) total += *cluster.map_shared_rank(&s_count, q);
  const float count = fmaxf(total, 1.0f);
  for (int c = threadIdx.x; c < H; c += kPoolThreads) {
    float s = 0.0f;
    for (int q = 0; q < n_blocks; ++q) s += cluster.map_shared_rank(psum, q)[c];
    p[c] = s / count;
  }
  cluster.sync();  // every block has read the partial sums
  normalise_bwd(p, g + (size_t)b * H, H, normalize, eps, red);
  for (int c = threadIdx.x; c < H; c += kPoolThreads) p[c] = p[c] / count;
  __syncthreads();
  write_rows<VEC>(dh + (size_t)b * L * H, p, l0, l1, H, [mb](int l) { return mb[l] != 0; });
}

template <int VEC>
int launch_pool_bwd(const float* x, const uint8_t* mask, const float* g, float* dh, int B, int L, int H, int cls,
                    int normalize, float eps, int sms, cudaStream_t stream) {
  if (cls) {
    const dim3 grid((L + kClsRows - 1) / kClsRows, B);
    pool_bwd_cls_kernel<VEC><<<grid, kPoolThreads, (H + kPoolThreads / 32) * 4, stream>>>(x, g, dh, L, H,
                                                                                         normalize, eps);
    return (int)cudaGetLastError();
  }
  // blocks a sequence: enough for two blocks an SM over the batch, at most
  // kMaxCluster and L
  const int want = (2 * sms + B - 1) / B;
  const int n = max(1, min(min(kMaxCluster, L), want));
  const int rows = (L + n - 1) / n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, B);
  cfg.blockDim = dim3(kPoolThreads);
  cfg.dynamicSmemBytes = (2 * H + kPoolThreads / 32) * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, pool_bwd_mean_kernel<VEC>, x, mask, g, dh, L, H, rows, normalize, eps);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// emb: [B, H] f32, contiguous; loss: [1] f32; lse: [B] f32; raw: [B, B]
// f32 (emb . emb^T, kept for the backward).  B even, >= 2; H >= 1.  One
// launch.  Returns a cudaError_t.
extern "C" int pw_contrastive_loss(const void* emb, void* loss, void* lse, void* raw, int B, int H, float scale,
                                   float diag, void* stream) {
  if (B < 2 || B % 2 || H < 1) return (int)cudaErrorInvalidValue;
  const bool v4 = H % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  static std::atomic<unsigned> done1{0}, done4{0};
  const int err = v4 ? allow_smem(loss_fwd_kernel<4>, done4, kFwdFloats * 4)
                     : allow_smem(loss_fwd_kernel<1>, done1, kFwdFloats * 4);
  if (err) return err;
  auto kernel = v4 ? loss_fwd_kernel<4> : loss_fwd_kernel<1>;
  kernel<<<kSplit, kThreads, kFwdFloats * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<float*>(loss), static_cast<float*>(lse), static_cast<float*>(raw),
      B, H, scale, diag);
  return (int)cudaGetLastError();
}

// emb: [B, H] f32; raw, lse: the forward's; g: [1] f32 on the card, the
// loss's incoming gradient; demb: [B, H] f32.  B even, >= 2, B / 64 <
// 65,536.  One launch.  Returns a cudaError_t.
extern "C" int pw_contrastive_loss_bwd(const void* emb, const void* raw, const void* lse, const void* g, void* demb,
                                       int B, int H, float scale, float diag, void* stream) {
  if (B < 2 || B % 2 || H < 1 || (B + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
  const bool rv = B % 4 == 0 && reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  const bool ev = H % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  static std::atomic<unsigned> done[4] = {};
  auto kernel = rv ? (ev ? loss_bwd_kernel<4, 4> : loss_bwd_kernel<4, 1>)
                   : (ev ? loss_bwd_kernel<1, 4> : loss_bwd_kernel<1, 1>);
  const int err = allow_smem(kernel, done[2 * rv + ev], kBwdFloats * 4);
  if (err) return err;
  const dim3 grid((H + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  kernel<<<grid, kThreads, kBwdFloats * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(raw), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(demb), B, H, scale, diag);
  return (int)cudaGetLastError();
}

// x: [B, L, H] f32, the hidden rows K7 pooled; mask: [B, L] uint8; g:
// [B, H] f32, the gradient of K7's output; dh: [B, L, H] f32, 16-byte
// aligned.  cls: CLS pooling (else masked mean); normalize: K7 normalised.
// H even, at most 2,048; B <= 65,535.  One launch.  Returns a cudaError_t.
extern "C" int pw_pool_normalize_bwd(const void* x, const void* mask, const void* g, void* dh, int B, int L, int H,
                                     int cls, int normalize, float eps, void* stream) {
  if (B == 0) return 0;
  if (L < 1 || H < 2 || H % 2 || H > kMaxHidden || B > 65535) return (int)cudaErrorInvalidValue;
  static int sms_of[64] = {};  // each device's SM count, asked once
  int dev = 0;
  const int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && sms_of[dev] == 0) cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
  const int sms = dev < 64 && sms_of[dev] > 0 ? sms_of[dev] : 132;
  const auto* xf = static_cast<const float*>(x);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* gf = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 4 == 0) return launch_pool_bwd<4>(xf, m, gf, out, B, L, H, cls, normalize, eps, sms, s);
  return launch_pool_bwd<2>(xf, m, gf, out, B, L, H, cls, normalize, eps, sms, s);
}
