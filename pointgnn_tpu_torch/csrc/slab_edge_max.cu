// slab_edge_max for Hopper (sm_90a): fused exact radius search + folded
// edge MLP + per-center max over a cell-sorted slab graph.
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (slab_edge_max -> _slab_forward -> _slab_kernel).  Called from
// pointgnn_tpu_torch/nn/slab.py, which checks the inputs, computes the
// per-(block, column) candidate row windows [lo, hi) and launches this
// kernel on PyTorch's current stream through a plain C interface.
//
// What it computes, for every center k and candidate row j in the
// windows of k's block:
//   mask   = |p_j - c_k|^2 <= r^2, exact f32 in x, y, z order
//            (__fsub_rn/__fmul_rn/__fadd_rn: no FMA contraction, so
//            boundary pairs agree with the plain version bit for bit)
//   h      = relu(A[j] - B[k]) -> L x (dense, +bias, ReLU)
//   out[k] = max over masked j of h, 0 where no j passes
//
// Bound on this card.  Per in-radius pair the chain costs
// 2 * sum_l din_l * dout_l FLOPs (L0 car tail 32->64->128->300: 97,280;
// L1 tail 300->300: 180,000), while the unique bytes are the tables,
// coordinates, weights and the [K, H_out] output (a few MB).  With
// ~10^5..10^6 in-radius pairs per call, the work is bound by
// operations, not bytes: at 989 TFLOP/s (bf16 tensor cores) a call
// needs about pairs * chain FLOPs / 989e12 seconds.
//
// Design (a simple kernel that is right first; speed is later work):
// - one CTA of 256 threads per block of bk centers (the TPU's sequential
//   grid becomes independent CTAs: each owns its centers' outputs, so
//   nothing is reduced across CTAs);
// - the CTA walks exactly [lo, hi) of every grid column, in tiles of
//   kTileRows candidates; the distance mask of a tile is compacted into
//   a shared-memory pair list (order does not matter under max);
// - pairs are processed kPairBatch at a time: the first activation
//   relu(A[j] - B[k]) is built in shared memory, then each layer is a
//   CUDA-core product in which a thread owns one output channel for
//   all pairs of the batch (weights stream from L2, activations are
//   shared-memory broadcasts);
// - the last layer's ReLU output is max-accumulated in a shared [bk,
//   H_out] accumulator; the owning thread of a channel is the only
//   writer of that channel, so no atomics are needed.
// Rounding points follow the JAX kernel: weights, biases and tables
// are rounded to bf16 by the wrapper; relu(a - b) and every hidden
// layer's output are rounded to bf16 here; products accumulate in f32.
// With bf16 == 0 nothing is rounded (full f32, no TF32).  The distance
// test and the chain arithmetic come from slab_chain.cuh, which the
// backward kernel (slab_edge_max_bwd.cu) shares, so its recompute equals
// this forward bit for bit.

#include <cstddef>

#include "slab_chain.cuh"

namespace {

using namespace slab;

constexpr int kThreads = 256;
constexpr int kPairBatch = 32;
constexpr int kTileRows = 32;

// Shared-memory layout, in floats; every section starts 16-byte aligned.
struct Layout {
  int b, ctr, acc, x0, x1, pairs, total;
  __host__ __device__ Layout(int bk, int h, int h_out, int width) {
    b = 0;
    ctr = align4(bk * h);
    acc = ctr + bk * 4;
    x0 = acc + align4(bk * h_out);
    x1 = x0 + kPairBatch * width;
    pairs = x1 + kPairBatch * width;
    total = pairs + 2 * (kPairBatch + bk * kTileRows);
  }
};

// Runs the chain on pairs [p0, p0 + np) of the list and max-accumulates
// the last layer into s_acc.  Ends with all threads synchronised.
template <bool kBf16>
__device__ void run_batch(const float* __restrict__ table_a,
                          const float* __restrict__ weights,
                          const Chain& chain, const float* s_b, float* s_acc,
                          float* s_x0, float* s_x1, const int* s_pk,
                          const int* s_pj, int p0, int np, int h, int h_out,
                          int width) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kPairBatch * h; idx += kThreads) {
    const int p = idx / h, i = idx - (idx / h) * h;
    float v = 0.f;
    if (p < np) {
      const int k = s_pk[p0 + p];
      const int j = s_pj[p0 + p];
      v = first_act<kBf16>(rnd<kBf16>(table_a[(size_t)j * h + i]),
                           s_b[k * h + i]);
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
            *dst = fmaxf(*dst, last_out(acc[p], bo));
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

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    slab_edge_max_kernel(const float* __restrict__ table_a,
                         const float* __restrict__ src_xyz,
                         const float* __restrict__ table_b,
                         const float* __restrict__ ctr_xyz,
                         const int* __restrict__ win_lo,
                         const int* __restrict__ win_hi,
                         const float* __restrict__ weights, Chain chain,
                         float* __restrict__ out, int num_centers, int h,
                         int h_out, int width, int grid_g, int bk, float r2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_n;
  const Layout lay(bk, h, h_out, width);
  float* s_b = smem + lay.b;
  float* s_ctr = smem + lay.ctr;
  float* s_acc = smem + lay.acc;
  float* s_x0 = smem + lay.x0;
  float* s_x1 = smem + lay.x1;
  int* s_pk = reinterpret_cast<int*>(smem + lay.pairs);
  int* s_pj = s_pk + kPairBatch + bk * kTileRows;

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int k0 = blk * bk;
  const int nk = min(bk, num_centers - k0);

  for (int idx = tid; idx < bk * h; idx += kThreads) {
    const int k = idx / h;
    s_b[idx] = k < nk ? rnd<kBf16>(table_b[(size_t)k0 * h + idx]) : 0.f;
  }
  for (int idx = tid; idx < bk * 4; idx += kThreads) {
    s_ctr[idx] = idx / 4 < nk ? ctr_xyz[(size_t)k0 * 4 + idx] : -1e6f;
  }
  for (int idx = tid; idx < bk * h_out; idx += kThreads) s_acc[idx] = kNeg;
  if (tid == 0) s_n = 0;
  __syncthreads();

  const int* lo_row = win_lo + (size_t)blk * grid_g;
  const int* hi_row = win_hi + (size_t)blk * grid_g;
  for (int col = 0; col < grid_g; ++col) {
    const int lo = lo_row[col];
    const int hi = hi_row[col];
    for (int r0 = lo; r0 < hi; r0 += kTileRows) {
      const int nrows = min(kTileRows, hi - r0);
      for (int idx = tid; idx < bk * kTileRows; idx += kThreads) {
        const int k = idx / kTileRows;
        const int jj = idx - k * kTileRows;
        if (k < nk && jj < nrows) {
          const int j = r0 + jj;
          if (in_radius(&src_xyz[(size_t)j * 4], &s_ctr[k * 4], r2)) {
            const int slot = atomicAdd(&s_n, 1);
            s_pk[slot] = k;
            s_pj[slot] = j;
          }
        }
      }
      __syncthreads();
      const int n = s_n;
      const int nfull = n - n % kPairBatch;
      for (int p0 = 0; p0 < nfull; p0 += kPairBatch) {
        run_batch<kBf16>(table_a, weights, chain, s_b, s_acc, s_x0, s_x1,
                         s_pk, s_pj, p0, kPairBatch, h, h_out, width);
      }
      // carry the partial batch to the front (ranges cannot overlap:
      // the remainder is shorter than one batch)
      const int rem = n - nfull;
      if (nfull > 0 && tid < rem) {
        s_pk[tid] = s_pk[nfull + tid];
        s_pj[tid] = s_pj[nfull + tid];
      }
      __syncthreads();
      if (tid == 0) s_n = rem;
      __syncthreads();
    }
  }
  const int n = s_n;
  if (n > 0) {
    run_batch<kBf16>(table_a, weights, chain, s_b, s_acc, s_x0, s_x1, s_pk,
                     s_pj, 0, n, h, h_out, width);
  }
  for (int idx = tid; idx < nk * h_out; idx += kThreads) {
    const float v = s_acc[idx];
    out[(size_t)k0 * h_out + idx] = v > kNeg * 0.5f ? v : 0.f;
  }
}

template <bool kBf16>
cudaError_t launch(const float* table_a, const float* src_xyz,
                   const float* table_b, const float* ctr_xyz,
                   const int* win_lo, const int* win_hi,
                   const float* weights, const Chain& chain, float* out,
                   int num_centers, int h, int h_out, int width, int grid_g,
                   int bk, float r2, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(Layout(bk, h, h_out, width).total);
  cudaError_t err = cudaFuncSetAttribute(
      slab_edge_max_kernel<kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (num_centers + bk - 1) / bk;
  slab_edge_max_kernel<kBf16><<<blocks, kThreads, smem, stream>>>(
      table_a, src_xyz, table_b, ctr_xyz, win_lo, win_hi, weights, chain, out,
      num_centers, h, h_out, width, grid_g, bk, r2);
  return cudaGetLastError();
}

}  // namespace

// layer_table: host array of 4 ints per layer
// (weight offset, bias offset, din, dout) into `weights`.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int slab_edge_max_launch(
    const void* table_a, const void* src_xyz, const void* table_b,
    const void* ctr_xyz, const void* win_lo, const void* win_hi,
    const void* weights, const void* layer_table, int n_layers, void* out,
    int num_centers, int h, int h_out, int grid_g, int bk, float r2, int bf16,
    int device, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || bk <= 0 || h <= 0 ||
      h_out <= 0) {
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
  const auto* a = static_cast<const float*>(table_a);
  const auto* sx = static_cast<const float*>(src_xyz);
  const auto* b = static_cast<const float*>(table_b);
  const auto* cx = static_cast<const float*>(ctr_xyz);
  const auto* lo = static_cast<const int*>(win_lo);
  const auto* hi = static_cast<const int*>(win_hi);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  err = bf16 ? launch<true>(a, sx, b, cx, lo, hi, w, chain, o, num_centers, h,
                            h_out, width, grid_g, bk, r2, s)
             : launch<false>(a, sx, b, cx, lo, hi, w, chain, o, num_centers,
                             h, h_out, width, grid_g, bk, r2, s);
  return static_cast<int>(err);
}
