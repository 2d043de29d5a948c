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
// m and v, 28 bytes a parameter: at BGE-base's 108.9M parameters 3.05 GB,
// 0.91 ms at 3.35 TB/s.  The three IEEE divisions and the square root of an
// element cost instructions, well under the memory time once enough loads
// are in flight.
//
// What the design does about it:
//  - Equal work units over the whole parameter set (the "spans" of the
//    wrapper's plan, kernels/adam.py): a span is up to 4,096 values (16 KB
//    of each stream) of one tensor, so ~200 tensors of very different
//    sizes leave no block idle.  One block a span; each thread of a vector
//    span loads 4 float4 of each stream before it computes (16 loads of 16
//    bytes in flight a thread).
//  - 16-byte vectors over each tensor's aligned body; the head (before p
//    is 16-byte aligned) and the tail of fewer than 4 values are scalar
//    spans of the same launch, and a tensor whose p, m and v are not
//    aligned alike is scalar spans only.  A gradient whose address is not
//    aligned like p's is read as four scalars inside a vector span.
//  - The table of p, m, v pointers and the span list are built once for a
//    parameter set and stay on the card; the gradients' pointers, which
//    change every step, ride in the launch's parameters (Grads, up to
//    kMaxTensors; CUDA 12.1 takes up to 32,764 bytes of kernel
//    parameters), so a step copies nothing from the host.
// The arithmetic is the parent's, element for element: the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;            // float4 of each stream a thread has in flight
constexpr int kMaxTensors = 1024;  // gradient pointers a launch carries (adam.py's MAX_TENSORS)

struct Tensor {
  float* p;
  float* m;
  float* v;
};

// count > 0: a vector span of count values (a multiple of 4, p + start
// 16-byte aligned, as m + start and v + start); count < 0: -count values
// taken one at a time.
struct Span {
  long long start;
  int tensor;
  int count;
};

struct Grads {
  const float* g[kMaxTensors];
};

struct Step {
  float b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, neg_lr;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Step& st) {
  m = __fadd_rn(__fmul_rn(st.one_minus_b1, g), __fmul_rn(st.b1, m));
  v = __fadd_rn(__fmul_rn(st.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(st.b2, v));
  const float mh = __fdiv_rn(m, st.bc1);
  const float vh = __fdiv_rn(v, st.bc2);
  const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), st.eps));
  p = __fadd_rn(p, __fmul_rn(st.neg_lr, u));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m, float4& v, const Step& st) {
  update(p.x, g.x, m.x, v.x, st);
  update(p.y, g.y, m.y, v.y, st);
  update(p.z, g.z, m.z, v.z, st);
  update(p.w, g.w, m.w, v.w, st);
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const Tensor* __restrict__ tensors, const Span* __restrict__ spans, const __grid_constant__ Grads grads,
            const Step st) {
  const Span sp = spans[blockIdx.x];
  const Tensor t = tensors[sp.tensor];
  const float* g = grads.g[sp.tensor] + sp.start;
  float* pp = t.p + sp.start;
  float* mp = t.m + sp.start;
  float* vp = t.v + sp.start;
  if (sp.count < 0) {
    for (int i = threadIdx.x; i < -sp.count; i += kThreads) {
      float p = pp[i], m = mp[i], v = vp[i];
      update(p, g[i], m, v, st);
      pp[i] = p;
      mp[i] = m;
      vp[i] = v;
    }
    return;
  }
  const int n4 = sp.count >> 2;
  const bool g_vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  float4* p4 = reinterpret_cast<float4*>(pp);
  float4* m4 = reinterpret_cast<float4*>(mp);
  float4* v4 = reinterpret_cast<float4*>(vp);
  for (int base = threadIdx.x; base < n4; base += kThreads * kVec) {
    float4 p[kVec], gr[kVec], m[kVec], v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = base + u * kThreads;
      if (i < n4) {
        p[u] = p4[i];
        m[u] = m4[i];
        v[u] = v4[i];
        gr[u] = g_vec ? __ldg(reinterpret_cast<const float4*>(g) + i)
                      : make_float4(g[4 * i], g[4 * i + 1], g[4 * i + 2], g[4 * i + 3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = base + u * kThreads;
      if (i < n4) {
        update4(p[u], gr[u], m[u], v[u], st);
        p4[i] = p[u];
        m4[i] = m[u];
        v4[i] = v[u];
      }
    }
  }
}

}  // namespace

// tensors: [n_tensors] of {p, m, v: f32 pointers} on the device; spans:
// [n_spans] of {start: long long, tensor: int, count: int} on the device
// (see Span); grads: a host array of n_tensors f32 device pointers, copied
// into the launch's parameters.  The step's constants as optax computes
// them in f32.  One launch.  Returns a cudaError_t.
extern "C" int pw_adam(const void* tensors, const void* spans, int n_spans, const void* const* grads,
                       int n_tensors, float b1, float b2, float one_minus_b1, float one_minus_b2, float bc1,
                       float bc2, float eps, float neg_lr, void* stream) {
  if (n_spans == 0) return 0;
  if (n_spans < 0 || n_tensors < 1 || n_tensors > kMaxTensors) return (int)cudaErrorInvalidValue;
  Grads gr;
  for (int i = 0; i < n_tensors; ++i) gr.g[i] = static_cast<const float*>(grads[i]);
  for (int i = n_tensors; i < kMaxTensors; ++i) gr.g[i] = nullptr;
  const Step st{b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, neg_lr};
  adam_kernel<<<n_spans, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Tensor*>(tensors), static_cast<const Span*>(spans), gr, st);
  return (int)cudaGetLastError();
}
