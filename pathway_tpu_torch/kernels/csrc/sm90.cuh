// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers,
// TMA tensor loads, wgmma shared-memory descriptors and the few wgmma
// shapes the port uses (bf16 in, f32 accumulate), and the host side of
// TMA (libcuda's tensor-map encoder, the dynamic shared memory limit).
// Used by K1 and K14 (attn_block.cuh) and, through tf32x3.cuh, K3, K10
// and K11.
//
// Layouts.  A tile is rows of R = 32, 64 or 128 bytes, loaded by TMA with
// the swizzle of the same width (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B), at an
// address aligned to 8 rows.  The 16-byte chunk c of row r then sits at
// chunk c ^ (r / (128 / R) % (R / 16)) of its row, and a descriptor with the
// same swizzle mode lets wgmma read it:
//  - K-major (rows along M or N, the k-dim contiguous: q and k for q.k^T):
//    8-row groups SBO = 8 R bytes apart; one k16 step is 32 bytes further
//    along the row (the hardware applies the swizzle to the address);
//  - MN-major (rows along k, the n-dim contiguous: v for p.v, read through
//    the transpose bit): k rows R bytes apart, 8-row groups SBO = 8 R bytes
//    apart; one k16 step is 16 rows further.  The tile's n extent is one
//    swizzle atom (R bytes), so the stride between atoms is never used; it
//    is set to SBO as well.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the library does not link libcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"

namespace pw_sm90 {

using pw_ptx::smem_u32;

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); then
// __syncthreads before any thread uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that has
// not ended after ~10 s of clock (a barrier that can never complete) traps,
// so a fault in the pipeline ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > 20000000000LL) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA

// Box of a 4-D tensor map at coordinates (c0 innermost .. c3) into shared
// memory; completes `bytes` of the barrier's transaction count (the whole
// box, zeros for the part outside the tensor included).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Box of a 2-D tensor map at (c0 innermost, c1), as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// cuTensorMapEncodeTiled from libcuda, found through the runtime so that a
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                        : nullptr;
  }();
  return fn;
}

// Raise the device's dynamic shared memory limit for `kernel` once per
// device (one bit each).  Returns a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, std::atomic<unsigned>& done, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// wgmma

// Descriptor layout modes (bits 62-63).
constexpr int kSwizzle128 = 1;
constexpr int kSwizzle64 = 2;
constexpr int kSwizzle32 = 3;

// The swizzle mode of rows of `row_bytes` (32, 64 or 128).
constexpr int swizzle_mode(int row_bytes) {
  return row_bytes == 128 ? kSwizzle128 : (row_bytes == 64 ? kSwizzle64 : kSwizzle32);
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout mode.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                               int mode) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(mode) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The accumulator of m64nNk16 (per thread, N / 2 floats): warp w of the
// warpgroup holds rows 16 w + lane / 4 (floats 4 j, 4 j + 1) and that + 8
// (4 j + 2, 4 j + 3), at columns 8 j + 2 (lane % 4) and + 1.  A register A
// operand (m64 x k16 bf16, four 32-bit registers) has the same layout over
// its 16 columns, as bf16 pairs: {c 0-1 row r, c 0-1 row r + 8, c 8-9 row r,
// c 8-9 row r + 8} (c relative to 2 (lane % 4)).

// d = (scale_d ? d : 0) + A . B^T, A (64 x 16) and B (N x 16) in shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = (scale_d ? d : 0) + A . B, A (64 x 16 bf16) in registers, B (16 x N)
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_m64n16k16_rs_tb(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d += A . B, A (64 x 16 bf16) in registers, B (16 x N) MN-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_m64n64k16_rs_tb(d, a, b, 1);
  else if constexpr (N == 32) wgmma_m64n32k16_rs_tb(d, a, b, 1);
  else wgmma_m64n16k16_rs_tb(d, a, b, 1);
}

}  // namespace pw_sm90
