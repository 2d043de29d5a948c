// K1: fused masked self-attention for the text encoder (bf16 in and out,
// or f32 in and out for the f32 configs).
//
// Replaces: the attention core of SelfAttention.__call__ in
//   pathway_tpu/models/encoder.py:113-117 (softmax(q.k^T / sqrt(d) + bias) . v,
//   bias = -1e30 on padded keys, non-causal), which XLA fuses on the TPU.
//
// What bounds it on an H100: the two products do 4*B*H*L*L*d operations
// against 8*B*L*H*d bytes of q/k/v/out, L/2 operations per byte: 256 at
// L = 512, near the 295 at which bf16 tensor cores stop waiting on memory,
// so at the long buckets the tensor-core rate bounds it and at the short
// ones the bytes do.  Unfused, the [B,H,L,L] f32 logits alone would move
// L/(1.5*d) times the bytes of q, k and v: 5x at L = 512, d = 64.
//
// What the design does about it: flash-style, with everything but the
// k/v tiles in registers (flash.cuh, shared with K14).  One block owns 64
// query rows of one (batch, head).  Keys are walked in tiles of 64,
// double-buffered in shared memory by cp.async so the next tile loads
// while this one is multiplied.  In bf16, 4 warps of 16 rows run q.k^T
// and p.v on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) with operands loaded by ldmatrix; the logits, the online
// softmax (running max and sum per row, f32) and the output accumulator
// stay in registers, and the logit accumulators are repacked in place as
// the bf16 p operand of the second product.  No logit reaches shared or
// device memory.  Logits stay f32 (the JAX program rounds them to bf16
// before the f32 softmax); p is rounded to bf16 for the second product as
// the JAX program rounds its probabilities.  In f32 the JAX program keeps
// everything in f32, so both products are f32 FMAs, four threads to a
// query row (2 * 64 = 128 FMAs per key and row at d = 64: at L = 512 the
// f32 rate of 67 TFLOP/s, not the bytes, bounds it).  Head dims 16, 32
// and 64.  wgmma/TMA are for a later version.

#include "flash.cuh"

// q, k, v, out: [B, L, H, D] bf16 (f32 = 0) or f32 (f32 = 1), contiguous;
// mask: [B, L] uint8 (1 = key present).  D is 16, 32 or 64.  Returns a
// cudaError_t (0 on success); shapes are checked by the Python wrapper.
extern "C" int pw_attention(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int B, int L, int H, int D, float scale, int f32,
                            void* stream) {
  if (B == 0) return 0;
  pw_flash::Args a{q, k, v, static_cast<const uint8_t*>(mask), out, nullptr, nullptr, nullptr,
                   L, H, scale, 0};
  return pw_flash::dispatch<false>(B, D, f32, a, static_cast<cudaStream_t>(stream));
}
