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
// What bounds it on an H100: the two products do 4*B*H*L*keys*D operations
// (keys: the present keys of the block's batch rows, the tiles it walks)
// against the bytes of q, k, v and the state (4*B*H*L*(D+2) bytes each way,
// or the output).  At the card phase's L = 2,048, D = 64 that is ~500
// operations per byte with half the keys present, so the tensor cores
// bound the bf16 step (0.055 ms at 989 TFLOP/s) and the f32 one (three
// TF32 passes, 0.41 ms at 495 TFLOP/s).  The exponentials, one a logit,
// run on the SFUs beside them.
//
// What the design does about it: K1's attention block (attn_block.cuh,
// kRing = true): a bf16 step is one wgmma consumer warpgroup fed by a TMA
// producer warp, four heads a block; an f32 step runs both products as
// 3xTF32 on the tensor cores.  The state is read into the accumulators
// before the first tile and written after the last, so no logit or
// probability reaches device memory and the state crosses it once a step.
// The logits are rounded to the input type before the f32 scale, as the
// JAX step does, and p stays f32 for p.v (in bf16 as a high and a low bf16
// part, two products).  The tile skip is the whole sequence's: any_key[b]
// says whether batch row b has a present key in some block of the
// sequence; where it does, the step walks only the tiles of this block
// that hold one, which leaves the state bit-equal to a walk of every tile
// once a present key is met (attn_block.cuh).  Where it does not, every
// tile is walked, so the row comes out as the uniform average of v over
// all its keys, as in the reference.  L up to 524,288: the card runs
// blocks of 2,048 keys and one block of 8,192.

#include "attn_block.cuh"

// q, k, v: [B, L, H, D] bf16 (f32 = 0) or f32 (f32 = 1); mask: [B, L]
// uint8 (1 = key present); any_key: [B] uint8 (1 = the batch row has a
// present key in some block of the sequence; 0 walks every tile); o:
// [B, H, L, D], m, l: [B, H, L] f32, updated in place unless finalize;
// out: [B, L, H, D] in q's type, written only with finalize (then the
// state is left as it was).  D is a multiple of 8 up to 128 (run in the
// instantiation of 16, 32, 64 or 128 at or above it); all contiguous.  Returns a
// cudaError_t (0 on success); shapes are checked by the Python wrapper.
extern "C" int pw_ring_block(const void* q, const void* k, const void* v, const void* mask,
                             const void* any_key, void* o, void* m, void* l, void* out, int B, int L,
                             int H, int D, float scale, int f32, int finalize, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (L > pw_attn::kMaxRingLen) return (int)cudaErrorInvalidValue;
  const pw_attn::Ring ring{static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
                           static_cast<const uint8_t*>(any_key), finalize, nullptr};
  return pw_attn::dispatch<true>(q, k, v, static_cast<const uint8_t*>(mask), out, B, L, H, D, scale, f32,
                                 ring, static_cast<cudaStream_t>(stream));
}
