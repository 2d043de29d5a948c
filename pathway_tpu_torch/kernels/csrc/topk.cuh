// Shared by K3 (knn_topk.cu), K12 (ivf_scan.cu) and K13 (topk_select.cu):
// the top-k order, the row loads of a slab of f32 or bf16 rows, the
// block-wide bitonic sort and the warp-wide selection of the best k
// (value, index) pairs.
//
// Order: higher score first, lower index first on ties, as jax.lax.top_k
// orders them.  Masked slots score NEG_INF (ops/topk.py); pads (past the
// end of a slab or of a list) are (-inf, kPadIdx) and rank after them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pw {

constexpr float kNegInf = -3.0e38f;  // ops/topk.py NEG_INF
constexpr int kPadIdx = 0x7fffffff;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Row<T>::load(row, c, dst): the c-th 16-byte chunk of a row of T, as
// kVec f32 values.
template <typename T>
struct Row;

template <>
struct Row<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* row, int c, float* dst) {
    float4 t = reinterpret_cast<const float4*>(row)[c];
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  }
};

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* row, int c, float* dst) {
    uint4 u = reinterpret_cast<const uint4*>(row)[c];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
  }
};

// Sort `count` arrays of n (a power of two) (value, index) pairs held
// back to back in shared (or, for one block, global) memory, best first.
// All threads of the block take part.
__device__ inline void bitonic_sort(float* vals, int* idx, int n, int count) {
  const int half = n / 2;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < count * half; t += blockDim.x) {
        const int a = t / half;
        const int p = t % half;
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        float* v = vals + a * n;
        int* x = idx + a * n;
        const float vi = v[i], vj = v[j];
        const int xi = x[i], xj = x[j];
        const bool swap = (i & size) == 0 ? better(vj, xj, vi, xi) : better(vi, xi, vj, xj);
        if (swap) {
          v[i] = vj; v[j] = vi;
          x[i] = xj; x[j] = xi;
        }
      }
      __syncthreads();
    }
  }
}

// k rounds of a warp-wide arg-max over the kPer (value, index) pairs each
// lane holds, which costs far less than a sort at the k of a search.
// After round j every lane holds its winner and calls emit(j, value,
// index); the winner's owner then drops it (pads share one index and go
// all at once, which leaves pads).  Every lane of the warp takes part.
template <int kPer, typename Emit>
__device__ __forceinline__ void warp_top_k(float (&v)[kPer], int (&id)[kPer], int k, Emit emit) {
  for (int j = 0; j < k; ++j) {
    float bv = v[0];
    int bi = id[0];
#pragma unroll
    for (int e = 1; e < kPer; ++e) {
      if (better(v[e], id[e], bv, bi)) {
        bv = v[e];
        bi = id[e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (id[e] == bi && v[e] == bv) {
        v[e] = -INFINITY;
        id[e] = kPadIdx;
      }
    }
    emit(j, bv, bi);
  }
}

}  // namespace pw
