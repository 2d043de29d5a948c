// K4: the dense layer's epilogue, in place: bias add plus activation (bf16,
// or f32 for the f32 configs).
//
// Replaces: the bias add of every nn.Dense / nn.DenseGeneral(dtype=bf16)
//   of EncoderBlock.__call__ and SelfAttention.__call__ in
//   pathway_tpu/models/encoder.py:88-150, the nn.gelu after mlp_up, and
//   the pooler Dense + jnp.tanh of CrossEncoderModel (:222-224).  flax
//   rounds the product to bf16, casts the f32 bias to bf16 and adds it
//   (rounding again), then applies the activation to the rounded sum:
//     out = bf16(act(bf16(y + bf16(bias)))).
//   In f32 (Dense(dtype=f32)) every rounding is the identity.
//   XLA fuses all of it into the product's epilogue on the TPU; eager
//   torch runs a cast of the bias, a broadcast add and a separate GELU.
//   With a position table (pos [P, N] f32, row r reading pos[r % P]) it
//   is also the vision tower's patch-embed tail,
//   pathway_tpu/models/vision.py:60-76: the bf16 conv output plus its
//   bias, then x + pos.astype(bf16), each add rounded:
//     out = bf16(act(bf16(bf16(y + bf16(bias)) + bf16(pos[r % P])))).
//
// What bounds it on an H100: bytes.  It reads and writes each value of
// y once (4 bytes per value) plus the bias (4 * N bytes, cached) for at
// most ~10 f32 operations per value (tanh GELU): 2.5 operations per byte
// against the 20 at which the f32 rate would bound it.  At M = 65,536,
// N = 3,072 that is 805 MB, 240 us at 3.35 TB/s.  The position table
// adds P * N * 4 bytes, read once from memory and then from L2: at the
// vision tower's M = 50,176, N = 768, P = 196, 154 MB, 46 us.
//
// What the design does about it: one pass over y, in place.  Each thread
// handles vectors of 8 values (one 16-byte load and store in bf16, two in
// f32) in a grid-stride loop sized to fill every SM; the 8 bias values of
// a vector come from two 16-byte loads that hit L1/L2 after the first row.
// The element type and the activation are template parameters, so each
// variant is a straight line.

#include "vec8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM

enum Act { kNone = 0, kGeluTanh = 1, kGeluErf = 2, kTanh = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == kGeluTanh) {
    const float cube = x * x * x;
    const float inner = 0.7978845608028654f * (x + 0.044715f * cube);  // sqrt(2/pi)
    return 0.5f * x * (1.0f + tanhf(inner));
  } else if (ACT == kGeluErf) {
    return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));  // 1/sqrt(2)
  } else if (ACT == kTanh) {
    return tanhf(x);
  }
  return x;
}

template <typename T, int ACT, bool POS>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(T* __restrict__ y, const float* __restrict__ bias, const float* __restrict__ pos,
                uint32_t pos_rows, uint32_t nvec, uint32_t row_vecs) {
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < nvec; v += gridDim.x * kThreads) {
    const uint32_t col = v % row_vecs;  // 8 consecutive columns of one row
    float f[8], b[8], p[8];
    pw::load8(y + (size_t)v * 8, f);
    pw::load_f32x8(bias + col * 8, b);
    if (POS) {
      const size_t prow = (v / row_vecs) % pos_rows;
      pw::load_f32x8(pos + (prow * row_vecs + col) * 8, p);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = pw::round_to<T>(f[j] + pw::round_to<T>(b[j]));
      if (POS) s = pw::round_to<T>(s + pw::round_to<T>(p[j]));
      f[j] = activate<ACT>(s);
    }
    pw::store8(y + (size_t)v * 8, f);
  }
}

template <typename T, int ACT, bool POS>
int launch(void* y, const void* bias, const void* pos, uint32_t pos_rows, uint32_t nvec,
           uint32_t row_vecs, cudaStream_t stream) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * kBlocksPerSm;
  }
  const uint32_t want = (nvec + kThreads - 1) / kThreads;
  const int blocks = want < (uint32_t)max_blocks ? (int)want : max_blocks;
  bias_act_kernel<T, ACT, POS><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const float*>(bias), static_cast<const float*>(pos),
      pos_rows, nvec, row_vecs);
  return (int)cudaGetLastError();
}

template <typename T, bool POS>
int launch_act(void* y, const void* bias, const void* pos, uint32_t pos_rows, uint32_t nvec,
               uint32_t row_vecs, int act, cudaStream_t s) {
  switch (act) {
    case kNone: return launch<T, kNone, POS>(y, bias, pos, pos_rows, nvec, row_vecs, s);
    case kGeluTanh: return launch<T, kGeluTanh, POS>(y, bias, pos, pos_rows, nvec, row_vecs, s);
    case kGeluErf: return launch<T, kGeluErf, POS>(y, bias, pos, pos_rows, nvec, row_vecs, s);
    case kTanh: return launch<T, kTanh, POS>(y, bias, pos, pos_rows, nvec, row_vecs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_pos(void* y, const void* bias, const void* pos, int pos_rows, uint32_t nvec,
               uint32_t row_vecs, int act, cudaStream_t s) {
  if (pos != nullptr)
    return launch_act<T, true>(y, bias, pos, (uint32_t)pos_rows, nvec, row_vecs, act, s);
  return launch_act<T, false>(y, bias, nullptr, 1, nvec, row_vecs, act, s);
}

}  // namespace

// y: [m, n] bf16 (f32 = 0) or f32 (f32 = 1), updated in place; bias: [n]
// f32; pos: null, or [pos_rows, n] f32 added to row r as pos[r % pos_rows];
// n % 8 == 0, m * n / 8 < 2^31; all 16-byte aligned.  act: 0 none, 1 tanh
// GELU, 2 erf GELU, 3 tanh.  Returns a cudaError_t (0 on success).
extern "C" int pw_bias_act(void* y, const void* bias, const void* pos, int pos_rows,
                           long long m, int n, int act, int f32, void* stream) {
  if (m == 0) return 0;
  if (n % 8 != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (pos != nullptr && pos_rows <= 0) return (int)cudaErrorInvalidValue;
  const long long nvec = m * (n / 8);
  if (nvec >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t nv = (uint32_t)nvec, rv = (uint32_t)(n / 8);
  if (f32) return launch_pos<float>(y, bias, pos, pos_rows, nv, rv, act, s);
  return launch_pos<__nv_bfloat16>(y, bias, pos, pos_rows, nv, rv, act, s);
}
