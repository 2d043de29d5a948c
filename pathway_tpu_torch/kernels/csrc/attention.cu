// K1: fused masked self-attention for the text encoder (bf16 in, bf16 out).
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
// k/v tiles in registers.  One block of 4 warps owns 64 query rows of one
// (batch, head); each warp owns 16 of them.  Keys are walked in tiles of
// 64, double-buffered in shared memory by cp.async so the next tile loads
// while this one is multiplied.  q.k^T and p.v run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) with operands loaded by
// ldmatrix; the logits, the online softmax (running max and sum per row,
// f32) and the output accumulator stay in registers, and the logit
// accumulators are repacked in place as the bf16 p operand of the second
// product.  No logit reaches shared or device memory.  Logits stay f32
// (the JAX program rounds them to bf16 before the f32 softmax); p is
// rounded to bf16 for the second product as the JAX program rounds its
// probabilities.  wgmma/TMA are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 64;   // query rows per block and keys per tile
constexpr int kWarps = 4;   // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr float kMaskBias = -1e30f;

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;                    // bf16 pitch: conflict-free ldmatrix
  static constexpr int kTileBytes = kTile * kLd * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;            // two buffers
  static constexpr int kV = kK + 2 * kTileBytes;        // two buffers
  static constexpr int kBias = kV + 2 * kTileBytes;     // two buffers of kTile floats
  static constexpr int kBytes = kBias + 2 * kTile * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy into shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[0..3] += a[0..3] (16x16 bf16, row) * b[0..1] (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Async copy of rows [row0, row0+64) of one head of a [B, L, H, D] tensor
// into a shared tile; rows past L are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int L, int row_stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool in = row0 + r < L;
    const __nv_bfloat16* s = in ? src + (size_t)(row0 + r) * row_stride + col : src;
    cp_async16(dst + r * Smem<D>::kLd + col, s, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int L, int H, float scale) {
  using S = Smem<D>;
  constexpr int kLd = S::kLd;
  constexpr int kKSteps = D / 16;    // k-steps of q.k^T
  constexpr int kNTiles = kTile / 8; // 8-key column tiles of the logits
  constexpr int kDTiles = D / 8;     // 8-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  float* bias_s = reinterpret_cast<float*>(smem + S::kBias);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_stride = H * D;
  const size_t head_base = (size_t)b * L * row_stride + (size_t)h * D;
  const int n_tiles = (L + kTile - 1) / kTile;

  auto k_buf = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + S::kK + i * S::kTileBytes);
  };
  auto v_buf = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + S::kV + i * S::kTileBytes);
  };
  auto stage = [&](int t) {  // issue the loads of key tile t into buffer t & 1
    const int k0 = t * kTile;
    load_tile<D>(k_buf(t & 1), k + head_base, k0, L, row_stride);
    load_tile<D>(v_buf(t & 1), v + head_base, k0, L, row_stride);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int key = k0 + j;
      bias_s[(t & 1) * kTile + j] =
          key >= L ? -INFINITY : (mask[(size_t)b * L + key] ? 0.0f : kMaskBias);
    }
  };

  load_tile<D>(q_s, q + head_base, q0, L, row_stride);
  stage(0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: r0 = lane/4 and r0 + 8
  uint32_t qf[kKSteps][4];
  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  const int mi = lane / 8;  // which 8x8 matrix this lane addresses in ldmatrix.x4
  const int mr = lane % 8;  // which row of it

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int row = warp * 16 + mr + 8 * (mi % 2);
        ldmatrix_x4(qf[kk], q_s + row * kLd + kk * 16 + 8 * (mi / 2));
      }
    }
    const __nv_bfloat16* k_s = k_buf(t & 1);
    const __nv_bfloat16* v_s = v_buf(t & 1);
    const float* bias = bias_s + (t & 1) * kTile;

    // logits: 16 rows x 64 keys, as 8 column tiles of 8 keys
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int p = 0; p < kNTiles / 2; ++p) {  // pairs of key tiles: keys 16p .. 16p+15
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t kb[4];
        const int key = 16 * p + mr + 8 * (mi / 2);
        ldmatrix_x4(kb, k_s + key * kLd + kk * 16 + 8 * (mi % 2));
        mma_bf16(s[2 * p], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * p + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // online softmax over this tile, rows r0 (s[n][0..1]) and r0+8 (s[n][2..3])
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = s[n][e] * scale + bias[c + (e & 1)];
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);  // 0 on the first tile
      m_run[i] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_run[e / 2]);
        sum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p . v, p repacked from the logit accumulators as bf16 A operands
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {  // keys 16j .. 16j+15
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dq = 0; dq < kDTiles / 2; ++dq) {  // output dims 16dq .. 16dq+15
        uint32_t vb[4];
        const int key = 16 * j + mr + 8 * (mi % 2);
        ldmatrix_x4_trans(vb, v_s + key * kLd + 16 * dq + 8 * (mi / 2));
        mma_bf16(o[2 * dq], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dq + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // buffer t & 1 is free for tile t + 2
  }

  // out rows r0 and r0 + 8 of this warp, two dims per register pair
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * i;
    if (row < L) {
      const float inv = 1.0f / l_run[i];
      __nv_bfloat16* dst = out + head_base + (size_t)row * row_stride + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int L, int H, float scale, cudaStream_t stream) {
  auto kernel = attention_kernel<D>;
  // raise the dynamic shared memory limit once per device (one bit each)
  static std::atomic<unsigned> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::kBytes);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  dim3 grid((L + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, L, H, D] bf16, contiguous; mask: [B, L] uint8 (1 = key
// present).  Returns a cudaError_t (0 on success).  Shapes are checked by
// the Python wrapper; D other than 32 or 64 returns cudaErrorInvalidValue.
extern "C" int pw_attention(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int B, int L, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, mask, out, B, L, H, scale, s);
  if (D == 32) return launch<32>(q, k, v, mask, out, B, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
