// K9: the vision tower's tail: f32 mean over the patches, the f32
// projection plus its bias, and the L2 normalise (bf16 or f32 in, f32 out).
//
// Replaces: VisionEncoderModel.__call__ in pathway_tpu/models/vision.py:81-87:
//   pooled = jnp.mean(x.astype(f32), axis=1) over all P patch rows (no
//   mask, and kept in f32: unlike the text tail, K7, it is not rounded back
//   to bf16); out = pooled @ kernel + bias, an f32 nn.Dense; then
//   out / max(||out||, 1e-12) (the encoder's eps, not the 1e-30 of the
//   index ingest).
//
// What bounds it on an H100: bytes.  It must read x once (B * P * H * 2
// bytes in bf16, 4 in f32), the projection once ([E, H] f32) and write
// B * E * 4 bytes, for 2 * B * E * H operations of the product: at B = 256,
// P = 196, H = E = 768, 80 MB in 24 us at 3.35 TB/s against 0.3 GFLOP
// (4.5 us at the 67 TFLOP/s f32 rate); an f32 tower's x doubles the bytes.
//
// What the design does about it: a thread block cluster of 8 blocks takes
// 8 images.  Each block means one image (384 threads: 16-byte loads where
// the width and x's alignment allow, else 8, 4 or 2 bytes (bf16) or 8 or 4
// (f32); only this load differs between the two types; the rows split
// over up to 8 groups of threads, four loads in flight a thread, the
// groups' sums added in order), so 256 blocks stream x at B = 256, three
// an SM at most (56 registers a thread): every cluster is resident at
// once.  The cluster's 8 pooled rows are copied through distributed shared
// memory into each block, split once into TF32 high and low parts, and
// block r projects the r-th eighth of the E output columns for all 8
// images on the tensor cores in 3xTF32 (tf32x3.cuh's mma_3xtf32,
// f32-accurate): a warp takes an m16n8 tile of 8 columns by the 8 images
// (rows 8-15 zero), loads each weight value once (16-byte loads) and
// splits it by bit masks and a subtraction.  The weight crosses L2 once
// per cluster, B / 8 * 2.4 MB (77 MB at B = 256; the one-image-per-block
// kernel this replaces read it per image, 604 MB).  Each image's sum of
// squares is added over the cluster in rank order (the same order in
// every block), and each block writes its columns.  A cluster's blocks
// past the last image load no image and still project.
//
// Measured on an H100 (PERF.md): the mean runs near the bytes' time; the
// projection is bound by mma.sync's TF32 rate (3 products a step, half of
// each tile padding).  The FMA units did worse: a warp per column was
// bound by its 32-lane sums, a lane per column by uncoalesced weight
// reads, and a tile of 8 columns by the shared-memory reads of the pooled
// rows (each value feeds 8 FMAs).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;
using pw_tf32x3::mma_3xtf32;
using pw_tf32x3::split_tf32;

constexpr int kCluster = 8;    // blocks of a cluster, an image each
constexpr int kThreads = 384;  // 12 warps: a 768-wide tower's 96 columns a block are 12 tiles of 8
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // blocks an SM holds (56 registers a thread), so every cluster is resident
constexpr int kAcc = 4;        // independent accumulators a warp keeps in the projection
constexpr int kMaxGroups = kCluster;  // row groups of the mean (their sums live in the pooled rows)

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// VEC consecutive bf16 values at p (VEC * 2-byte aligned), added to s.
template <int VEC>
__device__ __forceinline__ void add_row(const __nv_bfloat16* p, float* s) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(q[i]);
      s[2 * i] += f.x;
      s[2 * i + 1] += f.y;
    }
  } else if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(q[i]);
      s[2 * i] += f.x;
      s[2 * i + 1] += f.y;
    }
  } else if constexpr (VEC == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    s[0] += f.x;
    s[1] += f.y;
  } else {
    s[0] += __bfloat162float(*p);
  }
}

// VEC consecutive f32 values at p (VEC * 4-byte aligned), added to s.
template <int VEC>
__device__ __forceinline__ void add_row(const float* p, float* s) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    s[0] += f.x;
    s[1] += f.y;
    s[2] += f.z;
    s[3] += f.w;
  } else if constexpr (VEC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    s[0] += f.x;
    s[1] += f.y;
  } else {
    s[0] += *p;
  }
}

// x as a TF32 high part (truncated) and the TF32 truncation of the rest,
// by bit masks and one subtraction (cvt.rna runs at a quarter of the FMA
// rate, and each weight value is split once): the dropped parts are
// ~2^-20 of x.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// Row pitch of the pooled rows in shared memory: rows g and g + 1 on
// other banks for the fragment loads.
__host__ __device__ constexpr int pitch(int h) { return h + 16; }

// Shared memory, in floats: the block's pooled row [h]; the cluster's
// pooled rows split into TF32 high and low parts, [kCluster][pitch] each
// (the high parts' rows first hold the mean's group sums); the projected
// columns [kCluster][ec]; the block's sums of squares [kCluster]; the
// images' norms [kCluster].
size_t smem_bytes(int h, int ec) {
  return ((size_t)h + 2 * kCluster * pitch(h) + (size_t)kCluster * ec + 2 * kCluster) * sizeof(float);
}

template <typename T, int VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
vision_head_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out, int b_total, int n_rows, int h,
                   int e_dim, int ec, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int rp = pitch(h);
  float* mine = smem;                      // [h]
  float* rows = mine + h;                  // [kCluster][rp]: high parts
  float* rows_lo = rows + kCluster * rp;   // [kCluster][rp]: low parts
  float* proj = rows_lo + kCluster * rp;   // [kCluster][ec]
  float* ssq = proj + kCluster * ec;       // [kCluster]
  float* denom = ssq + kCluster;           // [kCluster]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int first = (int)(blockIdx.x / kCluster) * kCluster;  // the cluster's first image
  const int img = first + rank;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h4 = h / 4;

  // 1. the f32 mean of this block's image: vectors of VEC columns, the
  // rows split over `groups` groups of threads, then the groups in order
  const int nv = h / VEC;
  const int groups = nv >= kThreads ? 1 : min(kMaxGroups, kThreads / nv);
  for (int idx = threadIdx.x; idx < groups * nv; idx += kThreads) {
    const int grp = idx / nv, vec = idx % nv;
    float s[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = 0.0f;
    if (img < b_total) {
      const T* xs = x + (size_t)img * n_rows * h + vec * VEC;
#pragma unroll 4
      for (int l = grp; l < n_rows; l += groups) add_row<VEC>(xs + (size_t)l * h, s);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) rows[grp * rp + vec * VEC + i] = s[i];
  }
  __syncthreads();
  // jnp.mean divides the sum by the count (past the last image: zeros)
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float t = 0.0f;
    for (int g = 0; g < groups; ++g) t += rows[g * rp + c];
    mine[c] = t / (float)n_rows;
  }
  // the cluster's pooled rows, into this block split into TF32 high and
  // low parts (cvt.rna, once a block; the group sums are spent)
  cluster.sync();
  for (int i = threadIdx.x; i < kCluster * h4; i += kThreads) {
    const int q = i / h4, c4 = i % h4;
    const float4 v = reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, q))[c4];
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(rows + q * rp)[c4] = hi;
    reinterpret_cast<uint4*>(rows_lo + q * rp)[c4] = lo;
  }
  __syncthreads();

  // 2. proj[q][e - e0] = pooled_q . weight[e] + bias[e] for this block's
  // columns e in [e0, e1), on the tensor cores in 3xTF32: a warp takes 8
  // columns, an m16n8 tile whose rows 0-7 are the cluster's images (rows
  // 8-15 zero).  Lane (g, t) loads float4 j = 4 i + t of weight row e + g
  // and of pooled row g, which fill two k8 steps: which k values share a
  // step does not change the sum, as long as A and B pair them alike.
  // Step i goes to accumulator i % kAcc: independent chains of products,
  // added in order at the end.
  const int e0 = rank * ec;
  const int e1 = min(e_dim, e0 + ec);
  const int g = lane / 4, tg = lane % 4;
  const uint4* a_hi4 = reinterpret_cast<const uint4*>(rows + g * rp);
  const uint4* a_lo4 = reinterpret_cast<const uint4*>(rows_lo + g * rp);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const uint4 zero_u4 = make_uint4(0u, 0u, 0u, 0u);
  for (int e = e0 + warp * 8; e < e1; e += kWarps * 8) {
    const bool row_ok = e + g < e1;
    const float4* w4 = reinterpret_cast<const float4*>(weight) + (size_t)(row_ok ? e + g : 0) * h4;
    float acc[kAcc][4];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.0f;
    for (int j0 = 0; j0 < h4; j0 += 4 * kAcc) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int j = j0 + 4 * a + tg;
        const float4 w = row_ok && j < h4 ? w4[j] : zero4;
        const uint4 ph = j < h4 ? a_hi4[j] : zero_u4;
        const uint4 pl = j < h4 ? a_lo4[j] : zero_u4;
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        const uint32_t s0_hi[4] = {ph.x, 0u, ph.y, 0u}, s0_lo[4] = {pl.x, 0u, pl.y, 0u};
        split_trunc(w.x, b0_hi, b0_lo);
        split_trunc(w.y, b1_hi, b1_lo);
        mma_3xtf32(acc[a], s0_hi, s0_lo, b0_hi, b0_lo, b1_hi, b1_lo);
        const uint32_t s1_hi[4] = {ph.z, 0u, ph.w, 0u}, s1_lo[4] = {pl.z, 0u, pl.w, 0u};
        split_trunc(w.z, b0_hi, b0_lo);
        split_trunc(w.w, b1_hi, b1_lo);
        mma_3xtf32(acc[a], s1_hi, s1_lo, b0_hi, b0_lo, b1_hi, b1_lo);
      }
    }
    // acc[.][0], acc[.][1]: image g at columns e + 2 t and e + 2 t + 1
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float c = acc[0][k];
#pragma unroll
      for (int a = 1; a < kAcc; ++a) c += acc[a][k];
      const int col = e + 2 * tg + k;
      if (col < e1) proj[g * ec + (col - e0)] = c + bias[col];
    }
  }
  __syncthreads();

  // 3. each image's sum of squares: this block's columns (warp q), then
  // the cluster's blocks in rank order
  if (warp < kCluster) {
    float ss = 0.0f;
    for (int c = lane; c < e1 - e0; c += 32) ss += proj[warp * ec + c] * proj[warp * ec + c];
    ss = warp_sum(ss);
    if (lane == 0) ssq[warp] = ss;
  }
  cluster.sync();
  if (threadIdx.x < kCluster) {
    float total = 0.0f;
    for (int r = 0; r < kCluster; ++r) total += cluster.map_shared_rank(ssq, r)[threadIdx.x];
    denom[threadIdx.x] = fmaxf(sqrtf(total), eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kCluster * ec; i += kThreads) {
    const int q = i / ec, c = i % ec;
    if (first + q < b_total && e0 + c < e1) out[(size_t)(first + q) * e_dim + e0 + c] = proj[i] / denom[q];
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <typename T, int VEC>
int launch(const void* x, const void* weight, const void* bias, void* out, int b, int n_rows, int h, int e_dim,
           float eps, cudaStream_t stream) {
  const int ec = (e_dim + kCluster - 1) / kCluster;
  const size_t smem = smem_bytes(h, ec);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(vision_head_kernel<T, VEC>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const int clusters = (b + kCluster - 1) / kCluster;
  vision_head_kernel<T, VEC><<<clusters * kCluster, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(out), b, n_rows, h, e_dim, ec, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, n_rows, h], bf16 (x_f32 0) or f32 (x_f32 1); weight: [e_dim, h]
// f32; bias: [e_dim] f32; out: [b, e_dim] f32.  h % 4 == 0, h <= 2048,
// h + e_dim <= 11,264; weight 16-byte aligned; x aligned to its element
// (its loads are as wide as h and its alignment allow).  One launch.
// Returns a cudaError_t (0 on success).
extern "C" int pw_vision_head(const void* x, int x_f32, const void* weight, const void* bias, void* out,
                              int b, int n_rows, int h, int e_dim, float eps, void* stream) {
  if (b == 0) return 0;
  if (h % 4 != 0 || h <= 0 || h > 2048 || e_dim <= 0 || n_rows <= 0 || h + e_dim > 11 * 1024)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    if (a % 16 == 0) return launch<float, 4>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
    if (a % 8 == 0) return launch<float, 2>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
    return launch<float, 1>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
  }
  if (h % 8 == 0 && a % 16 == 0) return launch<__nv_bfloat16, 8>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
  if (a % 8 == 0) return launch<__nv_bfloat16, 4>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
  if (a % 4 == 0) return launch<__nv_bfloat16, 2>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
  return launch<__nv_bfloat16, 1>(x, weight, bias, out, b, n_rows, h, e_dim, eps, s);
}
