// slab_edge_max for Hopper (sm_90a): fused exact radius search + folded
// edge MLP + per-center max over a cell-sorted slab graph.
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (slab_edge_max -> _slab_forward -> _slab_kernel).  Called from
// pointgnn_tpu_torch/nn/slab.py, which checks the inputs, computes the
// per-(block, column) candidate row windows [lo, hi) and launches the
// kernels below on PyTorch's current stream through a plain C interface.
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
// operations: at 989 TFLOP/s (bf16 tensor cores) a call needs about
// pairs * chain FLOPs / 989e12 seconds.
//
// Design: the pairs of one center block are very skewed (one block of 32
// centers can hold a ninth of a frame's pairs), so the work is cut by
// pairs, not by centers:
// 1. pair_kernel<false>: one warp per center walks exactly the [lo, hi)
//    windows of its block and counts the in-radius rows (warp ballots);
//    the wrapper turns the counts into CSR offsets with torch.cumsum;
// 2. pair_kernel<true>: the same walk writes every in-radius (k, j) to
//    the list at its center's offset, rows ascending, so the list is the
//    same on every run;
// 3. slab_mma::chain_kernel (slab_chain.cuh): chunks of 64 pairs spread
//    statically over a grid sized to the SMs, the whole chain (bf16 on
//    tensor cores) with the weights staged once per CTA in shared memory, a
//    segmented max over each center's run in the chunk and one atomicMax
//    on the float bits per run and channel into a zeroed output.
// Rounding points follow the JAX kernel: weights, biases and tables are
// rounded to bf16; relu(a - b) and every hidden output are rounded to
// bf16; products accumulate in f32 (bf16 MMA); the last layer is not
// rounded.  With bf16 == 0 nothing is rounded and the products are
// register-tiled f32 fmaf (no TF32); the backward (slab_edge_max_bwd.cu)
// recomputes them through the same chain_kernel, bit for bit.

#include <cstddef>

#include "slab_chain.cuh"

namespace {

using namespace slab;

constexpr int kPairThreads = 256;
constexpr int kPairWarps = kPairThreads / 32;

// One warp per center: walks the windows of the center's block in
// column order, rows ascending.  kWrite == false counts the in-radius
// rows into counts[k]; kWrite == true writes them from row_ptr[k] on.
template <bool kWrite>
__global__ void __launch_bounds__(kPairThreads)
    pair_kernel(const float* __restrict__ src_xyz,
                const float* __restrict__ ctr_xyz,
                const int* __restrict__ win_lo, const int* __restrict__ win_hi,
                int* __restrict__ counts, const int* __restrict__ row_ptr,
                int* __restrict__ pair_k, int* __restrict__ pair_j,
                int num_centers, int grid_g, int bk, float r2) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (k >= num_centers) return;
  const float c[3] = {ctr_xyz[(size_t)k * 4 + 0], ctr_xyz[(size_t)k * 4 + 1],
                      ctr_xyz[(size_t)k * 4 + 2]};
  const unsigned lt_mask = (1u << lane) - 1u;
  const size_t w0 = (size_t)(k / bk) * grid_g;
  int n = kWrite ? row_ptr[k] : 0;
  for (int col = 0; col < grid_g; ++col) {
    const int lo = win_lo[w0 + col], hi = win_hi[w0 + col];
    for (int r0 = lo; r0 < hi; r0 += 32) {
      const int r = r0 + lane;
      const bool hit = r < hi && in_radius(&src_xyz[(size_t)r * 4], c, r2);
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (kWrite && hit) {
        const int slot = n + __popc(ballot & lt_mask);
        pair_k[slot] = k;
        pair_j[slot] = r;
      }
      n += __popc(ballot);
    }
  }
  if (!kWrite && lane == 0) counts[k] = n;
}

cudaError_t launch_pairs(bool write, const float* src_xyz,
                         const float* ctr_xyz, const int* win_lo,
                         const int* win_hi, int* counts, const int* row_ptr,
                         int* pair_k, int* pair_j, int num_centers,
                         int grid_g, int bk, float r2, cudaStream_t stream) {
  const int blocks = (num_centers + kPairWarps - 1) / kPairWarps;
  if (write) {
    pair_kernel<true><<<blocks, kPairThreads, 0, stream>>>(
        src_xyz, ctr_xyz, win_lo, win_hi, counts, row_ptr, pair_k, pair_j,
        num_centers, grid_g, bk, r2);
  } else {
    pair_kernel<false><<<blocks, kPairThreads, 0, stream>>>(
        src_xyz, ctr_xyz, win_lo, win_hi, counts, row_ptr, pair_k, pair_j,
        num_centers, grid_g, bk, r2);
  }
  return cudaGetLastError();
}

}  // namespace

// write == 0: counts [K] of in-radius rows per center; write == 1: the
// CSR pair list (pair_k, pair_j) at the offsets row_ptr [K + 1].
// Returns the CUDA error code of the launch (0 on success).
extern "C" int slab_pairs_launch(const void* src_xyz, const void* ctr_xyz,
                                 const void* win_lo, const void* win_hi,
                                 void* counts, const void* row_ptr,
                                 void* pair_k, void* pair_j, int num_centers,
                                 int grid_g, int bk, float r2, int write,
                                 int device, void* stream) {
  if (bk <= 0 || grid_g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_centers <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_pairs(write != 0, static_cast<const float*>(src_xyz),
                     static_cast<const float*>(ctr_xyz),
                     static_cast<const int*>(win_lo),
                     static_cast<const int*>(win_hi),
                     static_cast<int*>(counts),
                     static_cast<const int*>(row_ptr),
                     static_cast<int*>(pair_k), static_cast<int*>(pair_j),
                     num_centers, grid_g, bk, r2,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The chain and max over the pair list.  weights_t: the flat chain with
// every weight transposed to [dout, din]; layer_table: host array of 4
// ints per layer (weight offset, bias offset, din, dout); out [K, H_out]
// must be zero.  Returns the CUDA error code (0 on success).
extern "C" int slab_edge_max_launch(
    const void* table_a, const void* table_b, const void* weights_t,
    const void* layer_table, int n_layers, const void* pair_k,
    const void* pair_j, int n_pairs, void* out, int h, int h_out, int bf16,
    int device, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || h <= 0 || h_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pairs <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_mma::ChainArgs args = {};
  args.table_a = static_cast<const float*>(table_a);
  args.table_b = static_cast<const float*>(table_b);
  args.weights_t = static_cast<const float*>(weights_t);
  args.pair_k = static_cast<const int*>(pair_k);
  args.pair_j = static_cast<const int*>(pair_j);
  args.n_pairs = n_pairs;
  args.h = h;
  args.h_out = h_out;
  args.chain = slab_mma::read_chain(layer_table, n_layers);
  args.out = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  err = bf16 ? slab_mma::launch_chain<true, false>(args, device, s)
             : slab_mma::launch_chain<false, false>(args, device, s);
  return static_cast<int>(err);
}
