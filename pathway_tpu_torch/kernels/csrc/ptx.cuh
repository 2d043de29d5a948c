// PTX wrappers shared by the attention block of K1 and K14
// (attn_block.cuh) and K10 (dual_logits.cu):
// the shared-memory address of a pointer, 16-byte cp.async copies into
// shared memory, the bf16 pair of two floats, and a loader of one head's
// 64-row tile of a [B, L, H, D] tensor.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pw_ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy into shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Async copy of rows [row0, row0 + 64) of one head of a [B, L, H, D]
// tensor of T (row_stride = H * D) into a shared tile of pitch kLd
// elements, by the block's kThreads threads; rows past L are zero.
template <typename T, int D, int kLd, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int L, int row_stride) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = D / kPer;     // chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kPer;
    const bool in = row0 + r < L;
    const T* s = in ? src + (size_t)(row0 + r) * row_stride + col : src;
    cp_async16(dst + r * kLd + col, s, in ? 16 : 0);
  }
}

}  // namespace pw_ptx
