// K1: fused masked self-attention for the text and image encoders (bf16 in
// and out, or f32 in and out for the f32 configs).
//
// Replaces: the attention core of SelfAttention.__call__ in
//   pathway_tpu/models/encoder.py:113-117 (softmax(q.k^T / sqrt(d) + bias) . v,
//   bias = -1e30 on padded keys, non-causal), which XLA fuses on the TPU.
//
// What bounds it on an H100: the two products do 4*B*H*L*keys*d operations
// (keys: the present keys of a batch row) against 4*B*L*H*d bytes of q and
// out and 4*keys*H*d of k and v.  At the rerank path's B=256 L=512 with
// 75-283 keys present that is ~0.16 ms either way (bytes and bf16 tensor
// cores about even); in f32 the 67 TFLOP/s of the FMA units would bound it,
// the tensor cores' 495 TFLOP/s of TF32 do not.
//
// What the design does about it: the attention block of attn_block.cuh
// (shared with K14, kRing = false).  One block owns 64 query rows of one
// (batch, head) and walks the key tiles (64 keys) of its batch row.
//  - Tile skip: the block first reads the row's mask (at most 512 bytes)
//    into one bit a key and lists the tiles that hold a present key; it
//    walks only those.  That is exact: a masked key's logit is -1e30 + x,
//    and exp(-1e30 - m) is 0 in f32 against the finite running max m a
//    present key gives; a masked tile met first is wiped by the rescale
//    exp(m_old - m_new) = 0.  A row with no present key walks every tile,
//    so it comes out as the uniform average of v over its L keys, as the
//    JAX program gives it.  Keys past L get -inf.  Query tiles are never
//    skipped: padded query rows are computed as the plain version computes
//    them.
//  - bf16: one consumer warpgroup (4 warps, 16 query rows each) runs both
//    products with wgmma (m64n64k16 for q.k^T from shared memory, m64nDk16
//    for p.v with p in registers and v read through the descriptor's
//    transpose bit), and a producer warp keeps a ring of 3 K/V stages in
//    flight with TMA and mbarriers.  A block walks 4 heads of its batch row
//    in turn: the mask, the walk and the bias are made once for them, q has
//    two buffers, and the ring runs on from one head into the next, so the
//    next head's tiles load while this one's are multiplied (one head a
//    block took 1.2-1.6x as long at the path shapes on an H100 80GB HBM3 at
//    700 W).  The tiles come through a 4-D tensor map over [B, L, H, D]
//    with a box of [1, 64, 1, D], so a partial last tile (L = 196) is
//    zero-filled inside its own batch row; rows of 128, 64 or 32 bytes
//    (D = 64, 32, 16) use the swizzle of that width, and the wgmma
//    descriptors the same mode (sm90.cuh).  The logits, the online softmax
//    (exp2 with log2(e) folded into the scale) and the output stay in
//    registers; the logits stay f32 (the JAX program rounds them to bf16
//    before its f32 softmax; K1 is held at a bf16 tolerance) and p is
//    rounded to bf16 for p.v as the JAX program rounds its probabilities.
//  - f32: the JAX program keeps everything in f32, which neither bf16 nor
//    one-pass TF32 (10 mantissa bits) holds.  Both products run on the
//    tensor cores as 3xTF32 (mma.sync m16n8k8: a.b ~ a_hi.b_hi + a_hi.b_lo
//    + a_lo.b_hi, each part rounded to TF32, ~21 bits of each operand;
//    helpers in tf32x3.cuh), 4
//    warps of 16 query rows; k and v tiles double-buffered in shared memory
//    by cp.async.  p.v takes p straight from the logit accumulators: its k
//    index t of a key octet stands for key 2t and t + 4 for key 2t + 1, and
//    v's rows are read in the same order.
// Head dims: any multiple of 8 up to 128, run in the instantiation of 16,
// 32, 64 or 128 at or above it with the padding columns zero in the tiles
// (attn_block.cuh).  Lengths up to 524,288 (kMaxRingLen): up to 512 keys
// the additive bias of every key sits in a shared array (4 bytes a key,
// the form that kept K1's time at the serving shapes); above, each tile's
// bias is made from its two mask words, as K14 makes it.  With lse, the
// row's log-sum-exp goes out too (the attention backward, K15, reads it).

#include "attn_block.cuh"

// q, k, v, out: [B, L, H, D] bf16 (f32 = 0) or f32 (f32 = 1), contiguous, 16-byte
// aligned; mask: [B, L] uint8 (1 = key present); lse: [B, H, L] f32 or null.
// D is a multiple of 8 up to 128, 1 <= L <= 524,288.  Returns a cudaError_t
// (0 on success); shapes are checked by the Python wrapper.
extern "C" int pw_attention(const void* q, const void* k, const void* v, const void* mask,
                            void* out, void* lse, int B, int L, int H, int D, float scale, int f32,
                            void* stream) {
  if (B == 0) return 0;
  pw_attn::Ring ring{};
  ring.lse = static_cast<float*>(lse);
  return pw_attn::dispatch<false>(q, k, v, static_cast<const uint8_t*>(mask), out, B, L, H, D, scale, f32,
                                  ring, static_cast<cudaStream_t>(stream));
}
