// K11: nearest IVF centroid per row, argmax_j (x_i . c_j [- 0.5 ||c_j||^2]).
//
// Replaces: _assign_ip (pathway_tpu/parallel/ivf_knn.py:44-47),
//   argmax(x @ c^T, axis=1), and _kmeans.assign (:62-66),
//   argmax(x @ c^T - 0.5 * sum(c * c, axis=1), axis=1), both in f32.
//   Ties go to the lower centroid, and a NaN score wins as jnp.argmax
//   lets it (the first NaN).
//
// What bounds it on an H100: operations.  2 * n * nlist * d f32 FMAs
// (103 GFLOP for a 65,536-row ingest chunk against 1,024 centroids of 768:
// 1.54 ms at 67 TFLOP/s) against n * d * 4 + nlist * d * 4 bytes read
// (204 MB, 0.06 ms).  Tensor cores would change the f32 result (TF32),
// so the product runs on the FMA units.
//
// What the design does about it: the [n, nlist] score matrix never
// reaches device memory.  A block owns 128 rows of x and walks every
// centroid in tiles of 64; each tile is a register-blocked product (each
// thread an 8-row x 4-centroid block of scores, 32 dimensions staged in
// shared memory at a time, the next stage fetched into registers while
// this one is multiplied).  The tile's epilogue subtracts half of each
// centroid's squared norm (summed from the same staged values) and folds
// the scores into each row's running (max, argmax) in registers: a
// 16-lane butterfly over the threads that share the rows.  The centroids
// (3 MB) stay in L2 across blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows of x per block
constexpr int kBN = 64;   // centroids per tile
constexpr int kBK = 32;   // dimensions per stage
constexpr int kALd = kBM + 4;
constexpr int kBLd = kBN + 4;
constexpr int kALoads = kBM * kBK / 4 / kThreads;  // float4 loads of x per thread and stage
constexpr int kBLoads = kBN * kBK / 4 / kThreads;  // ... of the centroids
constexpr int kPadIdx = 0x7fffffff;

// (va, ia) ranks before (vb, ib): the larger score, the lower index on a
// tie; a NaN before any number, the first NaN before a later one.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
              int32_t* __restrict__ out, int n, int d, int nlist, int half_norm) {
  __shared__ __align__(16) float a_s[kBK * kALd];  // x tile, transposed: [k][row]
  __shared__ __align__(16) float b_s[kBK * kBLd];  // centroid tile, transposed: [k][centroid]

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows rg*8 .. rg*8+7 of the block
  const int cg = tid % 16;  // centroids cg*4 .. cg*4+3 of the tile
  const int64_t row0 = (int64_t)blockIdx.x * kBM;

  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = -INFINITY;
    arg[i] = kPadIdx;
  }

  float4 pa[kALoads], pb[kBLoads];
  auto fetch = [&](int n0, int k0) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int idx = tid + i * kThreads;
      const int64_t row = row0 + idx / (kBK / 4);
      const int k = k0 + (idx % (kBK / 4)) * 4;
      pa[i] = (row < n && k < d) ? *reinterpret_cast<const float4*>(x + row * d + k)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int cent = n0 + idx / (kBK / 4);
      const int k = k0 + (idx % (kBK / 4)) * 4;
      pb[i] = (cent < nlist && k < d)
                  ? *reinterpret_cast<const float4*>(c + (int64_t)cent * d + k)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };

  for (int n0 = 0; n0 < nlist; n0 += kBN) {
    float acc[8][4];
    float cc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = 0.0f;
    }
    fetch(n0, 0);
    for (int k0 = 0; k0 < d; k0 += kBK) {
      __syncthreads();  // every thread is done reading the previous stage
#pragma unroll
      for (int i = 0; i < kALoads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kBK / 4);
        const int k = (idx % (kBK / 4)) * 4;
        a_s[(k + 0) * kALd + r] = pa[i].x;
        a_s[(k + 1) * kALd + r] = pa[i].y;
        a_s[(k + 2) * kALd + r] = pa[i].z;
        a_s[(k + 3) * kALd + r] = pa[i].w;
      }
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kBK / 4);
        const int k = (idx % (kBK / 4)) * 4;
        b_s[(k + 0) * kBLd + r] = pb[i].x;
        b_s[(k + 1) * kBLd + r] = pb[i].y;
        b_s[(k + 2) * kBLd + r] = pb[i].z;
        b_s[(k + 3) * kBLd + r] = pb[i].w;
      }
      __syncthreads();
      if (k0 + kBK < d) fetch(n0, k0 + kBK);
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(a_s + k * kALd + rg * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(a_s + k * kALd + rg * 8 + 4);
        const float4 b = *reinterpret_cast<const float4*>(b_s + k * kBLd + cg * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (half_norm) {
#pragma unroll
          for (int j = 0; j < 4; ++j) cc[j] = fmaf(bv[j], bv[j], cc[j]);
        }
      }
    }

    // fold this tile's scores into each row's running (max, argmax)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float bv = -INFINITY;
      int bi = kPadIdx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cent = n0 + cg * 4 + j;
        const float s = half_norm ? acc[i][j] - 0.5f * cc[j] : acc[i][j];
        if (cent < nlist && better(s, cent, bv, bi)) {
          bv = s;
          bi = cent;
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {  // the 16 lanes that share these rows
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (better(bv, bi, best[i], arg[i])) {
        best[i] = bv;
        arg[i] = bi;
      }
    }
  }

  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = row0 + rg * 8 + i;
      if (row < n) out[row] = arg[i];
    }
  }
}

}  // namespace

// x: [n, d] f32; c: [nlist, d] f32; out: [n] int32, the centroid of the
// best score per row (x . c, minus 0.5 ||c||^2 when half_norm).  d must
// divide by 4 and both arrays be 16-byte aligned.  Returns a cudaError_t.
extern "C" int pw_ivf_assign(const void* x, const void* c, void* out, int n, int d, int nlist,
                             int half_norm, void* stream) {
  if (n == 0) return 0;
  if (d % 4 != 0 || nlist < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  assign_kernel<<<(n + kBM - 1) / kBM, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(c), static_cast<int32_t*>(out), n,
      d, nlist, half_norm);
  return (int)cudaGetLastError();
}
