// Chain arithmetic shared by the slab kernels:
//   slab_edge_max.cu      (forward: exact radius search + edge MLP + max)
//   slab_edge_max_bwd.cu  (backward: recompute + route to the max winners)
//
// The backward finds each channel's winners by exact equality with the
// forward's output, so it must recompute every in-radius pair's chain bit
// for bit as the forward did.  Both kernels therefore take the distance
// test, the first activation, the dense products (operand order, fmaf
// grouping) and the layer epilogues from this one header.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace slab {

constexpr int kMaxLayers = 8;
constexpr float kNeg = -1e30f;

// Edge-MLP tail: per layer the offsets of its weight [din, dout] and bias
// [dout] in one flat float buffer.
struct Chain {
  int n_layers;
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int din[kMaxLayers];
  int dout[kMaxLayers];
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// |p - c|^2 <= r2 in exact f32, x, y, z order, with no FMA contraction,
// so boundary pairs agree with the plain PyTorch version bit for bit.
__device__ __forceinline__ bool in_radius(const float* __restrict__ p,
                                          const float* c, float r2) {
  const float dx = __fsub_rn(p[0], c[0]);
  const float dy = __fsub_rn(p[1], c[1]);
  const float dz = __fsub_rn(p[2], c[2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 <= r2;
}

// First activation relu(A[j] - B[k]); both inputs already rounded to the
// compute dtype, the difference rounded again.
template <bool kBf16>
__device__ __forceinline__ float first_act(float a, float b) {
  return fmaxf(rnd<kBf16>(a - b), 0.f);
}

// acc[p] = sum_i x[p * stride + i] * w[i * dout + o] for kPairs pairs:
// i ascending, one fmaf per term, x read four lanes at a time (stride and
// x 16-byte aligned).
template <int kPairs>
__device__ __forceinline__ void dense_column(const float* x, int stride,
                                             const float* __restrict__ w,
                                             int din, int dout, int o,
                                             float (&acc)[kPairs]) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
  int i = 0;
  for (; i + 4 <= din; i += 4) {
    const float w0 = __ldg(&w[(size_t)(i + 0) * dout + o]);
    const float w1 = __ldg(&w[(size_t)(i + 1) * dout + o]);
    const float w2 = __ldg(&w[(size_t)(i + 2) * dout + o]);
    const float w3 = __ldg(&w[(size_t)(i + 3) * dout + o]);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const float4 xv = *reinterpret_cast<const float4*>(&x[p * stride + i]);
      acc[p] = fmaf(xv.x, w0, acc[p]);
      acc[p] = fmaf(xv.y, w1, acc[p]);
      acc[p] = fmaf(xv.z, w2, acc[p]);
      acc[p] = fmaf(xv.w, w3, acc[p]);
    }
  }
  for (; i < din; ++i) {
    const float wi = __ldg(&w[(size_t)i * dout + o]);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      acc[p] = fmaf(x[p * stride + i], wi, acc[p]);
    }
  }
}

// Layer epilogues: bias in f32 and ReLU; hidden outputs are rounded to
// the compute dtype, the last layer's are not.
template <bool kBf16>
__device__ __forceinline__ float hidden_out(float acc, float bias) {
  return rnd<kBf16>(fmaxf(acc + bias, 0.f));
}

__device__ __forceinline__ float last_out(float acc, float bias) {
  return fmaxf(acc + bias, 0.f);
}

}  // namespace slab
