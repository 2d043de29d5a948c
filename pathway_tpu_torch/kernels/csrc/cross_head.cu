// B8: the cross-encoder's head in one launch: the pooler Dense of the CLS
// rows, its bias and tanh, and the f32 classifier Dense with its bias.
//
// Replaces: CrossEncoderModel.__call__'s head in
//   pathway_tpu/models/encoder.py:222-231: cls = x[:, 0];
//   h = tanh(Dense(hidden, dtype=act)(cls)); logits = Dense(labels,
//   dtype=f32)(h).  flax rounds as K4 does: the pooler weight cast to the
//   activation type, the product rounded to it, the f32 bias cast and
//   added (rounding), tanh taken in f32 on the rounded sum and rounded;
//   then the classifier in f32 on the widened h, its bias added after the
//   product.  In f32 every rounding is the identity.  The port ran it as
//   five launches a chunk (the weight's cast, a cuBLAS product of the
//   strided CLS view, K4 with tanh, h.float(), an f32 F.linear).
//
// What bounds it on an H100: bytes.  The pooler weight is f32 ([H, H]:
//   2.36 MB at H = 768) and must be read once; the CLS rows (B * H in the
//   activation type) and the classifier are small beside it: at B = 256,
//   ~2.8 MB, 0.8 us at 3.35 TB/s, against 0.3 GFLOP of product (0.3 us of
//   bf16 tensor-core time; 1.8 us as the three TF32 passes of the f32 form).
//
// What the design does about it: a cluster of 8 blocks splits the pooler's
//   columns in eighths (96 at H = 768), each block reading only its slice of
//   the weight (contiguous rows); clusters along grid.y take 32 CLS rows
//   each (f32: 16).  A block copies its rows straight from the strided view
//   into shared memory (cp.async, 16 bytes a copy; rows past B zero; f32:
//   split once into TF32 high and low parts).  Each warp takes 8 columns:
//   lane (g, t) streams row g of its columns' weight, 8 values a 32-deep
//   step (two 16-byte loads, kDepth steps ahead), rounds them to bf16 in
//   registers (the same bits as the weight's cast) and runs two m16n8k16
//   bf16 mma.sync per 16 rows (f32 form: the weight split by bit masks,
//   four 3xTF32 m16n8k8 steps).  Which k values
//   share a step does not change the sum as long as both operands pair them
//   alike.  The epilogue rounds, adds the bias, takes tanh and keeps h in
//   shared memory; each (row, label) pair's dot with the classifier over the
//   block's columns is a warp sum; the eight blocks' partial logits are
//   summed through distributed shared memory in rank order and the bias
//   added, so a call gives the same bits every time (no atomics).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ptx.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;
using pw_ptx::cp_async16;
using pw_ptx::cp_async_commit;
using pw_ptx::cp_async_wait;
using pw_ptx::pack_bf16;
using pw_tf32x3::mma_3xtf32;
using pw_tf32x3::split_tf32;

constexpr int kCluster = 8;       // blocks of a cluster, an eighth of the columns each
constexpr int kStepK = 32;        // depth of a weight step: 8 values a lane, two 16-byte loads
constexpr int kDepth = 4;         // weight steps a lane keeps in flight
constexpr int kMaxHidden = 1024;  // 16 warps of 8 columns a block
constexpr int kMaxLabels = 64;

// CLS rows a cluster takes (m16 tiles of the product), by activation type:
// bf16 32; f32 16, kept split into TF32 high and low parts (shared memory)
template <typename T>
struct Form {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kRows = kF32 ? 16 : 32;
  static constexpr int kMTiles = kRows / 16;
  // padding of a CLS row in shared memory, in elements: rows g and g + 1
  // on other banks for the fragment loads (bf16: 16 bytes a lane at 16 t;
  // f32: 16 bytes at 32 t and 32 t + 16)
  static constexpr int kRowPad = kF32 ? 4 : 32;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// x as a TF32 high part (truncated) and the TF32 truncation of the rest (as
// K9 splits its weight: bit masks and one subtraction)
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory, in bytes: the CLS rows (f32: their high parts, then the
// low parts), the tanh rows [kRows][nc + 1] f32, the partial logits
// [kRows * labels] f32, and the block's parameters beside the weight: the
// pooler bias [nc], the classifier's columns [labels][nc] and its bias
// [labels] (f32).
template <typename T>
__host__ __device__ constexpr size_t x_bytes(int h) {
  return (size_t)Form<T>::kRows * (h + Form<T>::kRowPad) * (Form<T>::kF32 ? 8 : 2);
}
template <typename T>
size_t smem_bytes(int h, int labels) {
  const int nc = h / kCluster;
  return x_bytes<T>(h) +
         ((size_t)Form<T>::kRows * (nc + 1) + (size_t)Form<T>::kRows * labels + nc + (size_t)labels * nc + labels) * 4;
}

// One 32-deep step of the pooler product at k: lane (g, t) holds weight
// row g's values k + 8 t .. k + 8 t + 7 in (wa, wb); the CLS rows come from
// shared memory at the same k.
template <int M>
__device__ __forceinline__ void step(float (&acc)[M][4], float4 wa, float4 wb, const __nv_bfloat16* xs,
                                     const __nv_bfloat16*, int pitch, int k, int g) {
  const uint32_t b0 = pack_bf16(wa.x, wa.y), b1 = pack_bf16(wa.z, wa.w);
  const uint32_t b2 = pack_bf16(wb.x, wb.y), b3 = pack_bf16(wb.z, wb.w);
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
    const uint4 lo = *reinterpret_cast<const uint4*>(xs + (16 * mt + g) * pitch + k);
    const uint4 hi = *reinterpret_cast<const uint4*>(xs + (16 * mt + g + 8) * pitch + k);
    const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
    mma_bf16(acc[mt], a0, b0, b1);
    const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
    mma_bf16(acc[mt], a1, b2, b3);
  }
}

// The f32 form: the CLS rows already split (x_hi, x_lo as TF32 bits), the
// weight split here; four 3xTF32 m16n8k8 steps, slots t and t + 4 taking
// k + 8 t + 2 j and k + 8 t + 2 j + 1.
template <int M>
__device__ __forceinline__ void step(float (&acc)[M][4], float4 wa, float4 wb, const float* x_hi,
                                     const float* x_lo, int pitch, int k, int g) {
  const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  uint32_t w_hi[8], w_lo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) split_trunc(w[i], w_hi[i], w_lo[i]);
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
    const int r0 = (16 * mt + g) * pitch + k, r1 = r0 + 8 * pitch;
    uint32_t ah[2][8], al[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int at = half ? r1 : r0;
      const uint4 h0 = *reinterpret_cast<const uint4*>(x_hi + at), h1 = *reinterpret_cast<const uint4*>(x_hi + at + 4);
      const uint4 l0 = *reinterpret_cast<const uint4*>(x_lo + at), l1 = *reinterpret_cast<const uint4*>(x_lo + at + 4);
      const uint32_t hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const uint32_t lv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ah[half][i] = hv[i];
        al[half][i] = lv[i];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a_hi[4] = {ah[0][2 * j], ah[1][2 * j], ah[0][2 * j + 1], ah[1][2 * j + 1]};
      const uint32_t a_lo[4] = {al[0][2 * j], al[1][2 * j], al[0][2 * j + 1], al[1][2 * j + 1]};
      mma_3xtf32(acc[mt], a_hi, a_lo, w_hi[2 * j], w_lo[2 * j], w_hi[2 * j + 1], w_lo[2 * j + 1]);
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxHidden / 2, 1)
cross_head_kernel(const T* __restrict__ x, long long row_stride, const float* __restrict__ wp,
                  const float* __restrict__ bp, const float* __restrict__ wc, const float* __restrict__ bc,
                  float* __restrict__ out, int b_total, int h, int labels) {
  using F = Form<T>;
  constexpr int kRows = F::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = h + F::kRowPad;
  const int nc = h / kCluster;   // this block's columns
  const int hp = nc + 1;         // pitch of the tanh rows
  T* xs = reinterpret_cast<T*>(smem);                        // [kRows][pitch] (f32: the high parts)
  float* x_lo = reinterpret_cast<float*>(smem) + (F::kF32 ? (size_t)kRows * pitch : 0);  // f32: [kRows][pitch]
  float* hs = reinterpret_cast<float*>(smem + x_bytes<T>(h));    // [kRows][hp]
  float* part = hs + kRows * hp;                                  // [kRows * labels]
  float* bps = part + kRows * labels;                             // [nc]
  float* wcs = bps + nc;                                          // [labels][nc]
  float* bcs = wcs + labels * nc;                                 // [labels]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b0 = blockIdx.y * kRows;
  const int e0 = rank * nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int steps = h / kStepK;

  // 1. the cluster's CLS rows, straight from the strided view (rows past
  // B zero), as the first group of copies
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = h / kPer;
  for (int c = threadIdx.x; c < kRows * chunks; c += blockDim.x) {
    const int r = c / chunks, ch = c - r * chunks;
    const bool in = b0 + r < b_total;
    cp_async16(xs + r * pitch + ch * kPer, in ? x + (size_t)(b0 + r) * row_stride + ch * kPer : x, in ? 16 : 0);
  }
  // ... with the parameters the epilogue reads, so that no load waits there
  for (int c = threadIdx.x; c < (labels + 1) * (nc / 4); c += blockDim.x) {
    const int l = c / (nc / 4), q = c - l * (nc / 4);  // row l - 1 of the classifier; l = 0: the pooler bias
    cp_async16(l ? wcs + (l - 1) * nc + 4 * q : bps + 4 * q,
               l ? wc + (size_t)(l - 1) * h + e0 + 4 * q : bp + e0 + 4 * q, 16);
  }
  if (threadIdx.x < labels) bcs[threadIdx.x] = bc[threadIdx.x];
  cp_async_commit();

  // 2. this warp's 8 columns e0 + 8 warp .. + 7: lane (g, t) streams
  // weight row e0 + 8 warp + g, float4s 8 s + 2 t and 8 s + 2 t + 1 at
  // step s, kDepth steps ahead of the products
  const float4* wrow = reinterpret_cast<const float4*>(wp + (size_t)(e0 + 8 * warp + g) * h) + 2 * t;
  float4 w[kDepth][2];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    if (j < steps) {
      w[j][0] = __ldg(wrow + 8 * j);
      w[j][1] = __ldg(wrow + 8 * j + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (F::kF32) {  // the rows, split once into TF32 high (in place) and low parts
    float* xf = reinterpret_cast<float*>(xs);
    for (int i = threadIdx.x; i < kRows * pitch; i += blockDim.x) {
      uint32_t hi, lo;
      split_tf32(xf[i], hi, lo);
      xf[i] = __uint_as_float(hi);
      x_lo[i] = __uint_as_float(lo);
    }
    __syncthreads();
  }
  float acc[F::kMTiles][4];
#pragma unroll
  for (int mt = 0; mt < F::kMTiles; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
  for (int s0 = 0; s0 < steps; s0 += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int s = s0 + j;
      if (s < steps) {
        const float4 wa = w[j][0], wb = w[j][1];
        if (s + kDepth < steps) {
          w[j][0] = __ldg(wrow + 8 * (s + kDepth));
          w[j][1] = __ldg(wrow + 8 * (s + kDepth) + 1);
        }
        step(acc, wa, wb, reinterpret_cast<const T*>(xs), reinterpret_cast<const T*>(x_lo), pitch,
             kStepK * s + 8 * t, g);
      }
    }
  }

  // 3. the epilogue: round (bf16), add the bias (rounded), tanh (rounded);
  // acc[mt][2 i + q] is row 16 mt + g + 8 i, column 8 warp + 2 t + q
#pragma unroll
  for (int mt = 0; mt < F::kMTiles; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * warp + 2 * t + q;
        const float v = acc[mt][2 * i + q];
        float th;
        if constexpr (F::kF32) {
          th = tanhf(v + bps[col]);
        } else {
          th = round_bf16(tanhf(round_bf16(round_bf16(v) + round_bf16(bps[col]))));
        }
        hs[(16 * mt + g + 8 * i) * hp + col] = th;
      }
    }
  }
  __syncthreads();

  // 4. each (row, label)'s dot with the classifier over this block's
  // columns, a warp sum
  for (int i = warp; i < kRows * labels; i += warps) {
    const int r = i / labels, l = i - r * labels;
    float s = 0.0f;
    for (int c = lane; c < nc; c += 32) s += hs[r * hp + c] * wcs[l * nc + c];
    s = warp_sum(s);
    if (lane == 0) part[i] = s;
  }
  cluster.sync();

  // 5. the eight blocks' partial logits in rank order, then the bias; block
  // rank r writes the pairs i = r, r + 8, ...
  for (int i = rank + kCluster * threadIdx.x; i < kRows * labels; i += kCluster * blockDim.x) {
    const int r = i / labels, l = i - r * labels;
    if (b0 + r < b_total) {
      float total = 0.0f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) total += cluster.map_shared_rank(part, q)[i];
      out[(size_t)(b0 + r) * labels + l] = total + bcs[l];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial logits
}

template <typename T>
int launch(const void* x, long long row_stride, const void* wp, const void* bp, const void* wc, const void* bc,
           void* out, int b, int h, int labels, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const int err = pw_sm90::allow_smem(cross_head_kernel<T>, done, (int)smem_bytes<T>(kMaxHidden, kMaxLabels));
  if (err) return err;
  const dim3 grid(kCluster, (b + Form<T>::kRows - 1) / Form<T>::kRows);
  cross_head_kernel<T><<<grid, 32 * (h / 64), smem_bytes<T>(h, labels), stream>>>(
      static_cast<const T*>(x), row_stride, static_cast<const float*>(wp), static_cast<const float*>(bp),
      static_cast<const float*>(wc), static_cast<const float*>(bc), static_cast<float*>(out), b, h, labels);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the CLS rows, [b, h] with rows row_stride elements apart (a view of
// the last hidden state [b, L, h]: row_stride = L * h), bf16 (x_f32 0) or
// f32 (x_f32 1), 16-byte aligned rows; wp: [h, h] f32 (the pooler's
// [out, in] weight), bp: [h] f32; wc: [labels, h] f32, bc: [labels] f32;
// out: [b, labels] f32.  h a multiple of 64 up to 1,024, labels 1 to 64,
// b < 2^21; wp, bp and wc 16-byte aligned.  One launch.  Returns a cudaError_t (0 on
// success).
extern "C" int pw_cross_head(const void* x, int x_f32, long long row_stride, const void* wp, const void* bp,
                             const void* wc, const void* bc, void* out, int b, int h, int labels, void* stream) {
  if (b == 0) return 0;
  if (b < 0 || b >= (1 << 21) || h < 64 || h > kMaxHidden || h % 64 || labels < 1 || labels > kMaxLabels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) return launch<float>(x, row_stride, wp, bp, wc, bc, out, b, h, labels, s);
  return launch<__nv_bfloat16>(x, row_stride, wp, bp, wc, bc, out, b, h, labels, s);
}
