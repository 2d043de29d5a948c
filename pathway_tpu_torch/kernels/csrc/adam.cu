// K19: one Adam step over every parameter, in one launch.
//
// Replaces: optax.adam(1e-4)'s update and optax.apply_updates in
//   __graft_entry__.py:126-131 (optax's scale_by_adam, then
//   scale_by_learning_rate), which XLA fuses over the parameter tree:
//     m = (1 - b1) g + b1 m;  v = (1 - b2) g^2 + b2 v;
//     u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps);  p = p + (-lr) u
//   in f32, in optax's order (each product and sum rounded on its own, no
//   fused multiply-add; torch.optim.Adam orders its denominator
//   differently), with t the step count after the increment.  The wrapper
//   passes 1 - b1 and 1 - b2 as optax rounds them (the double difference
//   cast to f32) and the bias corrections 1 - b^t taken in f32.
//
// What bounds it on an H100: bytes.  It reads p, g, m and v and writes p,
// m and v, 28 bytes a parameter: at BGE-base's 109.5M parameters 3.07 GB,
// 0.92 ms at 3.35 TB/s.
//
// What the design does about it: one launch for all ~200 tensors (a
// launch per tensor would cost a launch's time for each of the small
// ones).  The wrapper uploads a table of the tensors (four pointers and a
// length each) and a list of chunks (tensor, chunk index) of kChunk
// values; a block takes a chunk and its threads stride over it, each
// element read once and written once, coalesced.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Tensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
};

struct Step {
  float b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, neg_lr;
};

__global__ void __launch_bounds__(kThreads)
adam_kernel(const Tensor* __restrict__ tensors, const int2* __restrict__ chunks, int chunk, Step st) {
  const int2 c = chunks[blockIdx.x];
  const Tensor t = tensors[c.x];
  const long long start = (long long)c.y * chunk;
  const long long end = min(t.n, start + chunk);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float g = t.g[i];
    const float m = __fadd_rn(__fmul_rn(st.one_minus_b1, g), __fmul_rn(st.b1, t.m[i]));
    const float v = __fadd_rn(__fmul_rn(st.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(st.b2, t.v[i]));
    const float mh = __fdiv_rn(m, st.bc1);
    const float vh = __fdiv_rn(v, st.bc2);
    const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), st.eps));
    t.p[i] = __fadd_rn(t.p[i], __fmul_rn(st.neg_lr, u));
    t.m[i] = m;
    t.v[i] = v;
  }
}

}  // namespace

// tensors: [n_tensors] of {p, g, m, v: f32 pointers; n: long long} on the
// device; chunks: [n_chunks] int2 (tensor index, chunk index), each chunk
// `chunk` values of its tensor (the last one of a tensor shorter).  The
// step's constants as optax computes them in f32.  One launch.  Returns a
// cudaError_t.
extern "C" int pw_adam(const void* tensors, const void* chunks, int n_chunks, int chunk, float b1, float b2,
                       float one_minus_b1, float one_minus_b2, float bc1, float bc2, float eps, float neg_lr,
                       void* stream) {
  if (n_chunks == 0) return 0;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const Step st{b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, neg_lr};
  adam_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Tensor*>(tensors), static_cast<const int2*>(chunks), chunk, st);
  return (int)cudaGetLastError();
}
