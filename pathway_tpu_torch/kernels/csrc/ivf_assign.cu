// K11: nearest IVF centroid per row, argmax_j (x_i . c_j [- 0.5 ||c_j||^2]).
//
// Replaces: _assign_ip (pathway_tpu/parallel/ivf_knn.py:44-47),
//   argmax(x @ c^T, axis=1), and _kmeans.assign (:62-66),
//   argmax(x @ c^T - 0.5 * sum(c * c, axis=1), axis=1), both in f32.
//   Ties go to the lower centroid, and a NaN score wins as jnp.argmax
//   lets it (the first NaN).
//
// What bounds it on an H100: operations.  2 * n * nlist * d f32
// multiply-adds (103 GFLOP for a 65,536-row ingest chunk against 1,024
// centroids of 768) at f32 accuracy: three TF32 passes on the tensor cores
// (tf32x3.cuh), 0.62 ms at 495 TFLOP/s, against n * d * 4 + nlist * d * 4
// bytes read (204 MB, 0.06 ms).  On the FMA units (67 TFLOP/s) the same
// product needs 1.54 ms.
//
// What the design does about it.  The [n, nlist] score matrix never
// reaches device memory.
//  - A pre-pass splits the centroids once per call into TF32 hi and lo
//    parts (2 * nlist * d floats of scratch) and 0.5 ||c||^2 in f32, so no
//    block splits them again.
//  - A persistent grid (one block an SM) walks tiles of 128 rows; a tile
//    walks the centroids 256 at a time, each over d in stages of 16 values.
//    A producer warp keeps a ring of 5 stages in flight by TMA (x: 128 x 16,
//    hi and lo: 256 x 16, 40 KB a stage, 64-byte swizzle) and mbarriers,
//    and runs on into the next tile while the consumers finish this one.
//  - Two consumer warpgroups each own 64 of the rows: split x in registers
//    and run the three products as wgmma m64n256k8 (tf32x3_stage), 128 f32
//    sums a thread.  After each 256 centroids they subtract 0.5 ||c||^2
//    (Lloyd) and fold the scores into each row's running (max, argmax) in
//    registers: a scan of the thread's 64 columns, then a butterfly over the
//    4 lanes that share the row.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace pw_sm90;
using namespace pw_tf32x3;

constexpr int kBM = 128;  // rows of x a tile
constexpr int kBN = 256;  // centroids a pass over the row tile
constexpr int kStages = 5;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kABytes = kBM * kRowBytes;      // 8 KB
constexpr int kBBytes = kBN * kRowBytes;      // 16 KB, each of hi and lo
constexpr int kStageBytes = kABytes + 2 * kBBytes;
constexpr int kBars = kStages * kStageBytes;  // full[kStages], empty[kStages]
constexpr int kSmemBytes = kBars + 2 * kStages * 8 + 1024;  // + the alignment slack
constexpr int kPadIdx = 0x7fffffff;

// (va, ia) ranks before (vb, ib): the larger score, the lower index on a
// tie; a NaN before any number, the first NaN before a later one.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || ia < ib);
  return va > vb || (va == vb && ia < ib);
}

// One warp a centroid: hi and lo parts of its row, and 0.5 ||c||^2.
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ c, float* __restrict__ hi, float* __restrict__ lo,
             float* __restrict__ half_sq, int nlist, int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nlist) return;
  const size_t base = (size_t)row * d;
  float sq = 0.0f;
  for (int k = 4 * lane; k < d; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(c + base + k);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + base + k) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + base + k) = make_uint4(l[0], l[1], l[2], l[3]);
    sq = fmaf(v.x, v.x, sq);
    sq = fmaf(v.y, v.y, sq);
    sq = fmaf(v.z, v.z, sq);
    sq = fmaf(v.w, v.w, sq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) half_sq[row] = 0.5f * sq;
}

__global__ void __launch_bounds__(kThreads, 1)
assign_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap hi_map,
              const __grid_constant__ CUtensorMap lo_map, const float* __restrict__ half_sq,
              int32_t* __restrict__ out, int n, int d, int nlist) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;
  auto a_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * kStageBytes); };
  auto hi_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * kStageBytes + kABytes); };
  auto lo_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * kStageBytes + kABytes + kBBytes); };

  const int tiles = (n + kBM - 1) / kBM;
  const int n_passes = (nlist + kBN - 1) / kBN;
  const int k_steps = (d + kRowFloats - 1) / kRowFloats;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one lane issues every load
    if (threadIdx.x % 32 == 0) {
      int j = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int p = 0; p < n_passes; ++p) {
          for (int ks = 0; ks < k_steps; ++ks, ++j) {
            const int s = j % kStages;
            if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
            mbar_expect_tx(&full[s], kStageBytes);
            tma_load_2d(a_tile(s), &x_map, &full[s], ks * kRowFloats, tile * kBM);
            tma_load_2d(hi_tile(s), &hi_map, &full[s], ks * kRowFloats, p * kBN);
            tma_load_2d(lo_tile(s), &lo_map, &full[s], ks * kRowFloats, p * kBN);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile.  This
  // thread's rows are r and r + 8 of them; its sums for row r + 8 i and
  // column 8 q + 2 t + e are acc[4 q + 2 i + e].
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int t = lane % 4;
  float acc[kBN / 2];
  int j = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float best[2] = {-INFINITY, -INFINITY};
    int arg[2] = {kPadIdx, kPadIdx};
    for (int p = 0; p < n_passes; ++p) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
      for (int ks = 0; ks < k_steps; ++ks, ++j) {
        const int s = j % kStages;
        mbar_wait(&full[s], (j / kStages) & 1);
        tf32x3_stage<kBN>(acc, a_tile(s) + 64 * wg * kRowFloats, hi_tile(s), lo_tile(s));
        mbar_arrive(&empty[s]);  // stage s may be loaded again
      }

      // fold this pass's scores into each row's running (max, argmax)
      const int c0 = p * kBN;
      float bv[2] = {-INFINITY, -INFINITY};
      int bi[2] = {kPadIdx, kPadIdx};
#pragma unroll
      for (int q = 0; q < kBN / 8; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cent = c0 + 8 * q + 2 * t + e;
          if (cent >= nlist) continue;
          const float hs = half_sq ? __ldg(half_sq + cent) : 0.0f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float sc = acc[4 * q + 2 * i + e] - hs;
            if (better(sc, cent, bv[i], bi[i])) {
              bv[i] = sc;
              bi[i] = cent;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes that share the row
          const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
          if (better(ov, oi, bv[i], bi[i])) {
            bv[i] = ov;
            bi[i] = oi;
          }
        }
        if (better(bv[i], bi[i], best[i], arg[i])) {
          best[i] = bv[i];
          arg[i] = bi[i];
        }
      }
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t row = (int64_t)tile * kBM + r + 8 * i;
        if (row < n) out[row] = arg[i];
      }
    }
  }
}

// The tensor map of a [rows, d] f32 matrix, a box of [box_rows, 16] in the
// 64-byte swizzle; outside the matrix the box reads zeros.
int tensor_map(CUtensorMap* map, const void* base, int rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kRowFloats, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// x: [n, d] f32; c: [nlist, d] f32; scratch: 2 * nlist * d + nlist f32
// (the centroids' hi and lo parts and 0.5 ||c||^2); out: [n] int32, the
// centroid of the best score per row (x . c, minus 0.5 ||c||^2 when
// half_norm).  d must divide by 4 and every array be 16-byte aligned.
// Two launches: the split, then the assignment.  Returns a cudaError_t.
extern "C" int pw_ivf_assign(const void* x, const void* c, void* scratch, void* out, int n, int d, int nlist,
                             int half_norm, void* stream) {
  if (n == 0) return 0;
  if (d % 4 != 0 || nlist < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hi = static_cast<float*>(scratch);
  float* lo = hi + (size_t)nlist * d;
  float* half_sq = lo + (size_t)nlist * d;
  split_kernel<<<(nlist + 7) / 8, 256, 0, s>>>(static_cast<const float*>(c), hi, lo, half_sq, nlist, d);
  int err = (int)cudaGetLastError();
  if (err) return err;

  static std::atomic<unsigned> done{0};
  err = allow_smem(assign_kernel, done, kSmemBytes);
  CUtensorMap maps[3];
  if (!err) err = tensor_map(&maps[0], x, n, d, kBM);
  if (!err) err = tensor_map(&maps[1], hi, nlist, d, kBN);
  if (!err) err = tensor_map(&maps[2], lo, nlist, d, kBN);
  int dev = 0, sms = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int tiles = (n + kBM - 1) / kBM;
  assign_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmemBytes, s>>>(
      maps[0], maps[1], maps[2], half_norm ? half_sq : nullptr, static_cast<int32_t*>(out), n, d, nlist);
  return (int)cudaGetLastError();
}
