// K8: the vision tower's patchify: NHWC images -> one row of p * p * C
// values per patch, in the activation type (bf16 or f32), the A operand of
// the patch-embed product.
//
// Replaces: the input side of the stride-p, p x p nn.Conv of
//   VisionEncoderModel.__call__ in pathway_tpu/models/vision.py:60-69:
//   images.astype(cfg.dtype) (:68), the conv's "SAME" padding, and the
//   grid of patches in row-major (h_out, w_out) order, as the reshape at
//   :69 flattens it.  A row's columns follow the HWIO kernel's (kh, kw, c)
//   order, so [B * P, p * p * C] x the kernel reshaped to [p * p * C, hidden]
//   is the conv.  With sides that are multiples of p there is no padding;
//   otherwise "SAME" pads (gh * p - H) rows, the smaller half on top, and
//   likewise columns, with zeros.
//
// What bounds it on an H100: bytes.  It reads each image value once
// (4 bytes for f32, 1 for uint8) and writes it once (2 bytes as bf16, 4 as
// f32), with no arithmetic but the cast.  At B = 256, 224 x 224 x 3 f32
// into bf16 that is 154 MB read and 77 MB written, 69 us at 3.35 TB/s
// (uint8 images: 116 MB, 35 us; f32 into f32: 308 MB, 92 us).
//
// What the design does about it: one pass, one thread per 16 bytes of
// output, written as one 16-byte store: 8 consecutive outputs in bf16, 4
// in f32 (rows of p * p * C values, a multiple of 8 or 4).  Those columns
// of a row lie in one image row when they do not cross a kernel row (p * C
// = 48 values at p = 16, C = 3): then they are consecutive image values,
// read with 16-byte loads (f32: two for 8 values, one for 4) or one 8- or
// 4-byte load (uint8) when aligned, which every vector of an unpadded
// 16 x 16 x 3 grid is.  Any other vector (a padded edge, a kernel-row
// boundary) reads value by value.  Consecutive threads read and write
// consecutive addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Geometry {
  int h, w, c, p, gh, gw, pad_top, pad_left;
  int row_len;  // p * c: one kernel row of one patch
  int cols;     // p * p * c
};

template <typename T>
__device__ __forceinline__ float load_px(const T* img, size_t i) {
  return static_cast<float>(img[i]);
}

// Value of column col of patch row r (0 outside the image: padding).
template <typename T>
__device__ __forceinline__ float value_at(const T* __restrict__ img, const Geometry& g,
                                          uint32_t r, int col) {
  const int kh = col / g.row_len, rem = col % g.row_len;
  const int kw = rem / g.c, ch = rem % g.c;
  const int wo = (int)(r % g.gw), ho = (int)(r / g.gw % g.gh);
  const size_t b = r / g.gw / g.gh;
  const int y = ho * g.p + kh - g.pad_top, x = wo * g.p + kw - g.pad_left;
  if (y < 0 || y >= g.h || x < 0 || x >= g.w) return 0.0f;
  return load_px(img, ((b * g.h + y) * g.w + x) * g.c + ch);
}

// V consecutive image values at img + i, i aligned as the fast path needs.
template <int V>
__device__ __forceinline__ void load_vec(const float* img, size_t i, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(img + i));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  if constexpr (V == 8) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(img + i) + 1);
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const uint8_t* img, size_t i, float* f) {
  if constexpr (V == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(img + i));
    const uint8_t* u = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = (float)u[k];
  } else {
    const uint32_t raw = __ldg(reinterpret_cast<const unsigned int*>(img + i));
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = (float)((raw >> (8 * k)) & 0xffu);
  }
}
// alignment, in values, that load_vec<V> needs: 16 bytes (f32) or V (uint8)
template <typename T, int V>
constexpr int kLoadAlign = sizeof(T) == 4 ? 4 : V;

// The 16 bytes of output a thread writes: 8 bf16 or 4 f32 values.
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16*) {
  uint4 packed;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return packed;
}
__device__ __forceinline__ uint4 pack(const float* f, float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
patchify_kernel(const T* __restrict__ img, O* __restrict__ out, Geometry g, uint32_t nvec) {
  constexpr int V = 16 / sizeof(O);  // outputs a thread writes
  const uint32_t vec_per_row = g.cols / V;
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < nvec; v += gridDim.x * kThreads) {
    const uint32_t r = v / vec_per_row;
    const int col = (int)(v % vec_per_row) * V;
    const int kh = col / g.row_len, rem = col % g.row_len;
    const int wo = (int)(r % g.gw), ho = (int)(r / g.gw % g.gh);
    const size_t b = r / g.gw / g.gh;
    const int y = ho * g.p + kh - g.pad_top;
    const int x0 = (wo * g.p - g.pad_left) * g.c + rem;  // flat (x, c) index in the image row
    float f[V];
    const bool inside = rem + V <= g.row_len && y >= 0 && y < g.h && x0 >= 0 &&
                        x0 + V <= g.w * g.c;
    const size_t src = inside ? (b * g.h + y) * g.w * g.c + x0 : 0;
    if (inside && src % kLoadAlign<T, V> == 0) {
      load_vec<V>(img, src, f);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = value_at(img, g, r, col + k);
    }
    reinterpret_cast<uint4*>(out)[v] = pack(f, out);
  }
}

int grid_blocks(uint32_t work) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * kBlocksPerSm;
  }
  const uint32_t want = (work + kThreads - 1) / kThreads;
  return want < (uint32_t)max_blocks ? (int)want : max_blocks;
}

template <typename T, typename O>
int launch(const void* img, void* out, const Geometry& g, long long rows, cudaStream_t s) {
  const uint32_t nvec = (uint32_t)(rows * (g.cols / (16 / sizeof(O))));
  patchify_kernel<T, O><<<grid_blocks(nvec), kThreads, 0, s>>>(static_cast<const T*>(img),
                                                               static_cast<O*>(out), g, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// img: [b, h, w, c], f32 (kind 0) or uint8 (kind 1), 16-byte aligned;
// out: [b * gh * gw, p * p * c], bf16 (out_f32 0) or f32 (out_f32 1),
// 16-byte aligned.  The grid is gh x gw patches of p x p, the image offset
// by (pad_top, pad_left) in it.  p * p * c % 8 == 0 for bf16, % 4 == 0 for
// f32; b * gh * gw * p * p * c < 2^31.  Returns a cudaError_t (0 on
// success).
extern "C" int pw_patchify(const void* img, int kind, void* out, int out_f32, int b, int h, int w,
                           int c, int p, int gh, int gw, int pad_top, int pad_left, void* stream) {
  if (b == 0 || gh == 0 || gw == 0) return 0;
  const int vec = out_f32 ? 4 : 8;
  if (p <= 0 || c <= 0 || h <= 0 || w <= 0 || p * p * c % vec != 0) return (int)cudaErrorInvalidValue;
  const Geometry g{h, w, c, p, gh, gw, pad_top, pad_left, p * c, p * p * c};
  const long long rows = (long long)b * gh * gw;
  if (rows * g.cols >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0 && !out_f32) return launch<float, __nv_bfloat16>(img, out, g, rows, s);
  if (kind == 1 && !out_f32) return launch<uint8_t, __nv_bfloat16>(img, out, g, rows, s);
  if (kind == 0 && out_f32) return launch<float, float>(img, out, g, rows, s);
  if (kind == 1 && out_f32) return launch<uint8_t, float>(img, out, g, rows, s);
  return (int)cudaErrorInvalidValue;
}
