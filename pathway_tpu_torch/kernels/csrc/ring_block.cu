// K14: one step of ring attention, the flash state carried in and out
// (bf16 or f32 q/k/v; f32 state).
//
// Replaces: _ring_body in pathway_tpu/ops/ring_attention.py:47-77, the
//   step that each device of the sequence axis runs n times while the K/V
//   blocks rotate (ppermute i -> i + 1).  One step, for a query block q
//   [B, L, H, D] and the K/V/mask block k, v [B, L, H, D], mask [B, L]:
//     s = f32(q.k^T in q's type) / sqrt(D) + (mask ? 0 : -1e30)
//     m' = max(m, rowmax s);  a = exp(m - m');  p = exp(s - m') in f32
//     l' = l a + sum p;  o' = o a + p . f32(v)
//   with o [B, H, L, D], m, l [B, H, L] in f32 (m starts at -1e30, l and
//   o at 0).  The last step writes o / max(l, 1e-30) as [B, L, H, D] in
//   q's type instead of the state.
//
// What bounds it on an H100: the same as K1's.  The two products do
// 4*B*H*L*L*D operations against the bytes of q, k, v (and the state, 4 *
// B*H*L*(D+2) bytes each way, or the output): at the card phase's L =
// 2,048, D = 64 that is ~1,000 operations per byte, so the tensor-core
// rate bounds the bf16 step (4*8*12*2048^2*64 = 103 GFLOP, 0.104 ms at 989
// TFLOP/s) and the f32 rate (67 TFLOP/s) the f32 one.  In bf16 p.v runs
// twice (p's high and low parts), 1.5x the tensor-core work of K1.
//
// What the design does about it: the flash block (flash.cuh): 64 query
// rows a block, 64-key tiles double-buffered by cp.async, the
// running softmax in registers, the state read before the first tile and
// written after the last, so no logit or probability reaches device
// memory and the state crosses it once per step.  The logits are rounded
// to the input type before the f32 scale, as the JAX step does, so the
// kernel's logits equal its plain version's up to the products' summation
// order.  p stays f32 for p.v: in bf16 it is split into a bf16 high part
// and the bf16 rounding of the rest, two tensor-core products carrying
// ~16 bits of p (v is exact in bf16); in f32 both products are FMAs.
// Masked keys are added as -1e30 and computed, never skipped, so
// a row with no valid key anywhere comes out as the uniform average of v
// over all its keys, as in the reference.  L is not limited: the card
// runs blocks of 2,048 keys and one block of 8,192.

#include "flash.cuh"

// q, k, v: [B, L, H, D] bf16 (f32 = 0) or f32 (f32 = 1); mask: [B, L]
// uint8 (1 = key present); o: [B, H, L, D], m, l: [B, H, L] f32, updated
// in place unless finalize; out: [B, L, H, D] in q's type, written only
// with finalize (then the state is left as it was).  D is 16, 32 or 64;
// all contiguous.  Returns a cudaError_t (0 on success); shapes are
// checked by the Python wrapper.
extern "C" int pw_ring_block(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* m, void* l, void* out, int B, int L, int H, int D,
                             float scale, int f32, int finalize, void* stream) {
  if (B == 0 || L == 0) return 0;
  pw_flash::Args a{q, k, v, static_cast<const uint8_t*>(mask), out, static_cast<float*>(o),
                   static_cast<float*>(m), static_cast<float*>(l), L, H, scale, finalize};
  return pw_flash::dispatch(B, D, f32, a, static_cast<cudaStream_t>(stream));
}
