// Edge-list tail for Hopper (sm_90a), shared by two kernels:
//   edge_tail_max.cu   (K3: rows are the pre-gathered G = A[min(src, N-1)])
//   fused_edge_max.cu  (K4: rows are gathered from A inside the kernel)
//
// What it computes, for every center c over its S edge slots s:
//   x      = act(rnd(row(c, s) - B[c]))      act = ReLU or identity
//   x      = rnd(relu(x @ W_l + b_l))        for each chain layer l
//   out[c] = max over slots with valid[c, s] > 0 of x, 0 where none
// with row(c, s) = G[c * S + s] (K3) or A[clamp(src[c, s], 0, n_a - 1)]
// (K4).  Rounding points follow the TPU kernels (_tail_kernel and _kernel
// in pointgnn_tpu/nn/pallas_kernels.py): the rows, B, weights and biases
// are in the compute dtype, the difference is rounded to it, every layer
// accumulates in f32, adds the bias in f32, applies ReLU and is rounded
// to the compute dtype -- the last layer too, unlike slab_edge_max -- and
// the masked max is taken in f32.  With f32 rows nothing is rounded (no
// TF32).  The dense products and the hidden-layer epilogue are
// slab_chain.cuh's (dense_column, hidden_out), which the slab kernels use
// unchanged.
//
// Design (a simple kernel that is right first; speed is later work):
// - one CTA of 256 threads per block of bk centers owns their outputs, so
//   nothing is reduced across CTAs and no atomics touch the output;
// - the CTA reads the valid flags of its bk * S slots 256 at a time and
//   compacts the valid ones into a shared-memory (center, row) list, so
//   the chain runs only on valid slots (a masked slot never changes the
//   max); order does not matter under max;
// - pairs are processed kPairBatch at a time: the first activation is
//   built in shared memory from the row loads, then each layer is a
//   CUDA-core product in which a thread owns one output channel for all
//   pairs of the batch;
// - the last layer's output is max-accumulated in a shared [bk, H_out]
//   accumulator whose every channel has exactly one writing thread.
// Each pair's chain is computed alone in a fixed order, so K3 and K4 give
// bitwise-equal outputs on the same rows.

#pragma once

#include <cstddef>
#include <type_traits>

#include "slab_chain.cuh"

namespace edge_tail {

using namespace slab;

constexpr int kThreads = 256;
constexpr int kPairBatch = 32;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Shared-memory layout, in floats; every section starts 16-byte aligned.
struct Layout {
  int b, acc, x0, x1, pairs, total;
  __host__ __device__ Layout(int bk, int h, int h_out, int width) {
    b = 0;
    acc = align4(bk * h);
    x0 = acc + align4(bk * h_out);
    x1 = x0 + kPairBatch * width;
    pairs = x1 + kPairBatch * width;
    total = pairs + 2 * (kPairBatch + kThreads);
  }
};

// Runs the chain on pairs [p0, p0 + np) of the list and max-accumulates
// the last layer into s_acc.  Ends with all threads synchronised.
template <typename T>
__device__ void tail_batch(const T* __restrict__ rows,
                           const float* __restrict__ weights,
                           const Chain& chain, const float* s_b, float* s_acc,
                           float* s_x0, float* s_x1, const int* s_pk,
                           const int* s_pr, int p0, int np, int h, int h_out,
                           int width, bool act_first) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kPairBatch * h; idx += kThreads) {
    const int p = idx / h, i = idx - (idx / h) * h;
    float v = 0.f;
    if (p < np) {
      const int k = s_pk[p0 + p];
      const int r = s_pr[p0 + p];
      v = rnd<kBf16>(load_f32(&rows[(size_t)r * h + i]) - s_b[k * h + i]);
      if (act_first) v = fmaxf(v, 0.f);
    }
    s_x0[p * width + i] = v;
  }
  __syncthreads();

  if (chain.n_layers == 0) {
    for (int o = tid; o < h; o += kThreads) {
      for (int p = 0; p < np; ++p) {
        float* dst = &s_acc[s_pk[p0 + p] * h_out + o];
        *dst = fmaxf(*dst, s_x0[p * width + o]);
      }
    }
    __syncthreads();
    return;
  }

  const float* xin = s_x0;
  float* xout = s_x1;
  for (int l = 0; l < chain.n_layers; ++l) {
    const int din = chain.din[l], dout = chain.dout[l];
    const float* __restrict__ w = weights + chain.w_off[l];
    const float* __restrict__ bias = weights + chain.b_off[l];
    const bool last = (l + 1 == chain.n_layers);
    for (int o = tid; o < dout; o += kThreads) {
      float acc[kPairBatch];
      dense_column<kPairBatch>(xin, width, w, din, dout, o, acc);
      const float bo = __ldg(&bias[o]);
      if (!last) {
#pragma unroll
        for (int p = 0; p < kPairBatch; ++p) {
          xout[p * width + o] = hidden_out<kBf16>(acc[p], bo);
        }
      } else {
#pragma unroll
        for (int p = 0; p < kPairBatch; ++p) {
          if (p < np) {
            float* dst = &s_acc[s_pk[p0 + p] * h_out + o];
            *dst = fmaxf(*dst, hidden_out<kBf16>(acc[p], bo));
          }
        }
      }
    }
    __syncthreads();
    const float* t = xin;
    xin = xout;
    xout = const_cast<float*>(t);
  }
}

// kFused == false (K3): rows = G [K * S, H], row of slot t is t.
// kFused == true (K4): rows = A [n_rows_a, H], row of slot t is
// clamp(edges[t], 0, n_rows_a - 1) (the sentinel src == n_rows_a clamps;
// such slots are invalid and masked anyway).
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
    edge_tail_kernel(const T* __restrict__ rows,
                     const int* __restrict__ edges,
                     const T* __restrict__ table_b,
                     const float* __restrict__ valid,
                     const float* __restrict__ weights, Chain chain,
                     float* __restrict__ out, int num_centers, int num_slots,
                     int h, int h_out, int width, int bk, int n_rows_a,
                     bool act_first) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_n;
  const Layout lay(bk, h, h_out, width);
  float* s_b = smem + lay.b;
  float* s_acc = smem + lay.acc;
  float* s_x0 = smem + lay.x0;
  float* s_x1 = smem + lay.x1;
  int* s_pk = reinterpret_cast<int*>(smem + lay.pairs);
  int* s_pr = s_pk + kPairBatch + kThreads;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * bk;
  const int nk = min(bk, num_centers - k0);

  for (int idx = tid; idx < bk * h; idx += kThreads) {
    const int k = idx / h;
    s_b[idx] = k < nk ? load_f32(&table_b[(size_t)k0 * h + idx]) : 0.f;
  }
  for (int idx = tid; idx < bk * h_out; idx += kThreads) s_acc[idx] = kNeg;
  if (tid == 0) s_n = 0;
  __syncthreads();

  const size_t slot0 = (size_t)k0 * num_slots;
  const int nslots = nk * num_slots;
  for (int t0 = 0; t0 < nslots; t0 += kThreads) {
    const int t = t0 + tid;
    if (t < nslots && valid[slot0 + t] > 0.f) {
      int row;
      if constexpr (kFused) {
        row = min(max(edges[slot0 + t], 0), n_rows_a - 1);
      } else {
        row = static_cast<int>(slot0 + t);
      }
      const int slot = atomicAdd(&s_n, 1);
      s_pk[slot] = t / num_slots;
      s_pr[slot] = row;
    }
    __syncthreads();
    const int n = s_n;
    const int nfull = n - n % kPairBatch;
    for (int p0 = 0; p0 < nfull; p0 += kPairBatch) {
      tail_batch<T>(rows, weights, chain, s_b, s_acc, s_x0, s_x1, s_pk, s_pr,
                    p0, kPairBatch, h, h_out, width, act_first);
    }
    // carry the partial batch to the front (ranges cannot overlap: the
    // remainder is shorter than one batch)
    const int rem = n - nfull;
    if (nfull > 0 && tid < rem) {
      s_pk[tid] = s_pk[nfull + tid];
      s_pr[tid] = s_pr[nfull + tid];
    }
    __syncthreads();
    if (tid == 0) s_n = rem;
    __syncthreads();
  }
  const int n = s_n;
  if (n > 0) {
    tail_batch<T>(rows, weights, chain, s_b, s_acc, s_x0, s_x1, s_pk, s_pr, 0,
                  n, h, h_out, width, act_first);
  }
  for (int idx = tid; idx < nk * h_out; idx += kThreads) {
    const float v = s_acc[idx];
    out[(size_t)k0 * h_out + idx] = v > kNeg * 0.5f ? v : 0.f;
  }
}

template <typename T, bool kFused>
cudaError_t launch_typed(const void* rows, const int* edges,
                         const void* table_b, const float* valid,
                         const float* weights, const Chain& chain, float* out,
                         int num_centers, int num_slots, int h, int h_out,
                         int width, int bk, int n_rows_a, bool act_first,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(Layout(bk, h, h_out, width).total);
  cudaError_t err = cudaFuncSetAttribute(
      edge_tail_kernel<T, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (num_centers + bk - 1) / bk;
  edge_tail_kernel<T, kFused><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(rows), edges, static_cast<const T*>(table_b),
      valid, weights, chain, out, num_centers, num_slots, h, h_out, width, bk,
      n_rows_a, act_first);
  return cudaGetLastError();
}

// Checks the arguments, fills the chain from the host layer table (4 ints
// per layer: weight offset, bias offset, din, dout) and launches on
// `stream`.  Returns the CUDA error code (0 on success).
template <bool kFused>
int launch(const void* rows, const void* edges, const void* table_b,
           const void* valid, const void* weights, const void* layer_table,
           int n_layers, void* out, int num_centers, int num_slots, int h,
           int h_out, int bk, int n_rows_a, int bf16, int act_first,
           int device, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || bk <= 0 || h <= 0 ||
      h_out <= 0 || num_slots <= 0 || n_rows_a <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_centers <= 0) return 0;
  Chain chain;
  chain.n_layers = n_layers;
  int width = h;
  const int* tbl = static_cast<const int*>(layer_table);
  for (int l = 0; l < n_layers; ++l) {
    chain.w_off[l] = tbl[4 * l + 0];
    chain.b_off[l] = tbl[4 * l + 1];
    chain.din[l] = tbl[4 * l + 2];
    chain.dout[l] = tbl[4 * l + 3];
    width = chain.dout[l] > width ? chain.dout[l] : width;
  }
  width = align4(width);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const int*>(edges);
  const auto* v = static_cast<const float*>(valid);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  err = bf16 ? launch_typed<__nv_bfloat16, kFused>(
                   rows, e, table_b, v, w, chain, o, num_centers, num_slots,
                   h, h_out, width, bk, n_rows_a, act_first != 0, s)
             : launch_typed<float, kFused>(
                   rows, e, table_b, v, w, chain, o, num_centers, num_slots,
                   h, h_out, width, bk, n_rows_a, act_first != 0, s);
  return static_cast<int>(err);
}

}  // namespace edge_tail
