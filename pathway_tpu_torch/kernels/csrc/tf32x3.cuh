// f32-accurate matrix products on the TF32 tensor cores ("3xTF32"), shared
// by K1's f32 form (attention.cu, mma.sync), K10 (dual_logits.cu) and K11
// (ivf_assign.cu), both on wgmma.
//
// An f32 value x is split into a TF32 high part hi = rna(x) (cvt.rna: 10
// mantissa bits, to nearest, ties away) and the TF32 rounding of the rest,
// lo = rna(x - hi).  a.b is then a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, taken
// in that order (the small parts first) into one f32 accumulator: each
// product of two TF32 values is exact in f32, and the dropped a_lo.b_lo is
// ~2^-22 of a.b.  One TF32 pass alone keeps ~3 decimal digits and misses
// the port's f32 gates (1e-5 on unit-row dots over 768 dims); three keep
// them.  An infinite input gives NaN (its low part is inf - inf).
//
// The wgmma mainloop (tf32x3_stage) multiplies one stage: a warpgroup's 64
// rows of A by N rows of B over 16 values of the reduction dimension, both
// operands K-major (the reduction dimension contiguous).  Every tile has
// rows of 16 floats (64 bytes) in the 64-byte swizzle (sm90.cuh): chunk c
// of row r at chunk c ^ (r / 2 % 4), as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_64B, at an address aligned to 512 bytes.  A is raw
// f32; each thread loads its fragment of it and splits it in registers
// (wgmma takes A from registers).  B comes already split, as two tiles of
// TF32 values (hi and lo), which wgmma reads from shared memory.  A stage is
// six wgmma (two k8 steps, three products each), waited for before it
// returns: the A registers of the next stage must not be written while a
// product still reads them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace pw_tf32x3 {

using pw_sm90::fence_regs;
using pw_sm90::wgmma_commit;
using pw_sm90::wgmma_desc;
using pw_sm90::wgmma_fence;
using pw_sm90::wgmma_wait;

constexpr int kRowFloats = 16;          // a stage's depth: one 64-byte row
constexpr int kRowBytes = kRowFloats * 4;
constexpr uint32_t kSbo = 8 * kRowBytes;  // 8-row groups of the descriptor
constexpr int kMode = pw_sm90::kSwizzle64;

// x as a TF32 high part and the TF32 rounding of the rest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c[0..3] += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the small parts first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           uint32_t b0_hi, uint32_t b0_lo, uint32_t b1_hi,
                                           uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// Float index of (row, col) in a tile of 16-float rows in the 64-byte swizzle.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kRowFloats + ((((col >> 2) ^ (row >> 1)) & 3) << 2) + (col & 3);
}

// Splits 4 consecutive values of B (row, columns 4 chunk .. 4 chunk + 3)
// into the hi and lo tiles.
__device__ __forceinline__ void store_split(float* hi, float* lo, int row, int chunk, float4 v) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  const int at = swz(row, 4 * chunk);
  *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
}

// d = (scale_d ? d : 0) + A . B^T, A (64 x 8 tf32) in registers, B (N x 8
// tf32) K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n8k8_tf32_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B^T, A (64 x 8 tf32) in registers, B (N x 8
// tf32) K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B^T, A (64 x 8 tf32) in registers, B (N x 8
// tf32) K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B^T, A (64 x 8 tf32) in registers, B (N x 8
// tf32) K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B^T, A (64 x 8 tf32) in registers, B (N x 8
// tf32) K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k8_tf32_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 256, "a wgmma TF32 width of the port");
  if constexpr (N == 256) wgmma_m64n256k8_tf32_rs(d, a, b, 1);
  else if constexpr (N == 64) wgmma_m64n64k8_tf32_rs(d, a, b, 1);
  else if constexpr (N == 32) wgmma_m64n32k8_tf32_rs(d, a, b, 1);
  else if constexpr (N == 16) wgmma_m64n16k8_tf32_rs(d, a, b, 1);
  else wgmma_m64n8k8_tf32_rs(d, a, b, 1);
}

// acc[m] (the wgmma accumulator layout) += A_m . B^T over one stage, for
// kM blocks of 64 rows of A (raw f32, one after another in the tile; a:
// the first) and N rows of B's parts: the splits of every block first,
// then the 6 kM products, waited for before it returns (the A registers of
// the next stage must not be written while a product still reads them).
// With kSquares, sq[m][i] also sums the squares of the raw A values this
// thread holds of row r + 8 i of block m (4 of the stage's 16 columns; the
// 4 lanes that share a row hold the other 12).  Every thread of the
// warpgroup calls it.
template <int N, int kM, bool kSquares>
__device__ __forceinline__ void tf32x3_stage_rows(float (&acc)[kM][N / 2], const float* a, const float* b_hi,
                                                  const float* b_lo, float (&sq)[kM][2]) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32 % 4) + lane / 4;  // this thread's rows r and r + 8
  const int t = lane % 4;
  uint32_t ah[kM][2][4], al[kM][2][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float* am = a + 64 * m * kRowFloats;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // A fragment of k8 step kk: (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4)
      const float x[4] = {am[swz(r, 8 * kk + t)], am[swz(r + 8, 8 * kk + t)], am[swz(r, 8 * kk + t + 4)],
                          am[swz(r + 8, 8 * kk + t + 4)]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(x[e], ah[m][kk][e], al[m][kk][e]);
        if constexpr (kSquares) sq[m][e & 1] = fmaf(x[e], x[e], sq[m][e & 1]);
      }
    }
  }
  const uint64_t dh = wgmma_desc(b_hi, 16, kSbo, kMode);
  const uint64_t dl = wgmma_desc(b_lo, 16, kSbo, kMode);
#pragma unroll
  for (int m = 0; m < kM; ++m) fence_regs(acc[m]);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // one k8 step is 32 bytes along the rows
      wgmma_tf32_rs<N>(acc[m], al[m][kk], dh + 2 * kk);
      wgmma_tf32_rs<N>(acc[m], ah[m][kk], dl + 2 * kk);
      wgmma_tf32_rs<N>(acc[m], ah[m][kk], dh + 2 * kk);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < kM; ++m) fence_regs(acc[m]);
}

// acc (64 x N, the wgmma accumulator layout) += A . B^T over one stage.
// a: this warpgroup's 64 rows of A (raw f32); b_hi, b_lo: N rows of B's
// parts.  Every thread of the warpgroup calls it.
template <int N>
__device__ __forceinline__ void tf32x3_stage(float (&acc)[N / 2], const float* a, const float* b_hi,
                                             const float* b_lo) {
  float sq[1][2];
  tf32x3_stage_rows<N, 1, false>(reinterpret_cast<float (&)[1][N / 2]>(acc), a, b_hi, b_lo, sq);
}

}  // namespace pw_tf32x3
