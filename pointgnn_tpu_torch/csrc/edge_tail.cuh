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
// TF32).
//
// Design (the slab kernels' work plan, slab_chain.cuh):
// 1. pair_kernel<false>: one warp per center counts its valid slots
//    (ballots over the flags, in any pattern: valid slots need not be
//    packed at the front) and sets the center's output row to the "no
//    value" key; the wrapper turns the counts into offsets with
//    torch.cumsum on the card;
// 2. pair_kernel<true>: the same walk writes every valid slot as a
//    (center, row) pair at its center's offset, slots ascending, so the
//    list is in center order and the same on every run.  Its capacity is
//    K * S, known on the host, and the chain reads the pair count from
//    the last offset on the card: no host sync between list and chain;
// 3. slab_mma::chain_kernel: chunks of 64 pairs spread over persistent
//    CTAs sized to the SMs (chunk c on CTA c mod grid), so a crowded
//    center costs no more than its pairs; every weight staged once per
//    CTA; the whole chain per chunk, then a segmented max over each
//    center's run and one atomicMax per run and channel on ordered_key
//    (exact, and right for negative values, which an empty chain without
//    the first ReLU gives);
// 4. finish_kernel: keys back to floats, "no value" (a center without a
//    valid slot) to 0.
// Each output element of the chain is computed from its own row and
// column alone, in a fixed k order, so a pair's values do not depend on
// its chunk: K4 equals K3 bit for bit on the same rows, and two runs are
// bitwise equal.

#pragma once

#include <climits>
#include <cstddef>

#include "slab_chain.cuh"

namespace edge_tail {

using namespace slab;

constexpr int kPairThreads = 256;
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kNoValue = INT_MIN;  // ordered_key of no float

// One warp per center, slots ascending.  kWrite == false: counts[c] =
// valid slots, out_keys[c, :] = kNoValue (where out_keys is set).
// kWrite == true: the center's pairs from row_ptr[c] on, with row
// c * S + s (K3) or clamp(edges[c, s], 0, n_rows_a - 1) (K4).
template <bool kWrite, bool kFused>
__global__ void __launch_bounds__(kPairThreads)
    pair_kernel(const float* __restrict__ valid, const int* __restrict__ edges,
                int* __restrict__ counts, const int* __restrict__ row_ptr,
                int* __restrict__ pair_k, int* __restrict__ pair_r,
                int* __restrict__ out_keys, int num_centers, int num_slots,
                int h_out, int n_rows_a) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kPairWarps + (threadIdx.x >> 5);
  if (c >= num_centers) return;
  const unsigned lt_mask = (1u << lane) - 1u;
  const size_t t0 = (size_t)c * num_slots;
  int n = kWrite ? row_ptr[c] : 0;
  for (int s0 = 0; s0 < num_slots; s0 += 32) {
    const int s = s0 + lane;
    const bool hit = s < num_slots && valid[t0 + s] > 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (kWrite && hit) {
      const int slot = n + __popc(ballot & lt_mask);
      pair_k[slot] = c;
      if constexpr (kFused) {
        pair_r[slot] = min(max(edges[t0 + s], 0), n_rows_a - 1);
      } else {
        pair_r[slot] = static_cast<int>(t0 + s);
      }
    }
    n += __popc(ballot);
  }
  if (!kWrite) {
    if (lane == 0) counts[c] = n;
    if (out_keys != nullptr) {
      for (int i = lane; i < h_out; i += 32) {
        out_keys[(size_t)c * h_out + i] = kNoValue;
      }
    }
  }
}

__global__ void finish_kernel(int* __restrict__ out, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int key = out[i];
    reinterpret_cast<float*>(out)[i] =
        key == kNoValue ? 0.f : from_ordered_key(key);
  }
}

// write == 0: counts [K] and, where out is set, out [K, H_out] to the
// "no value" key; write == 1: the pair list at the offsets row_ptr [K + 1].
// Returns the CUDA error code (0 on success).
template <bool kFused>
int launch_pairs(const void* valid, const void* edges, void* counts,
                 const void* row_ptr, void* pair_k, void* pair_r, void* out,
                 int num_centers, int num_slots, int h_out, int n_rows_a,
                 int write, int device, void* stream) {
  if (num_slots < 0 || h_out <= 0 || (kFused && n_rows_a <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_centers <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (num_centers + kPairWarps - 1) / kPairWarps;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(valid);
  const auto* e = static_cast<const int*>(edges);
  auto* cnt = static_cast<int*>(counts);
  const auto* rp = static_cast<const int*>(row_ptr);
  auto* pk = static_cast<int*>(pair_k);
  auto* pr = static_cast<int*>(pair_r);
  auto* o = static_cast<int*>(out);
  if (write) {
    pair_kernel<true, kFused><<<blocks, kPairThreads, 0, s>>>(
        v, e, cnt, rp, pk, pr, o, num_centers, num_slots, h_out, n_rows_a);
  } else {
    pair_kernel<false, kFused><<<blocks, kPairThreads, 0, s>>>(
        v, e, cnt, rp, pk, pr, o, num_centers, num_slots, h_out, n_rows_a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chain and max over the pair list, then the keys back to floats.
// rows: [*, h] in the compute dtype; table_b: [K, h] in the compute dtype;
// weights_t: the flat f32 chain with every weight as [dout, din] (rounded
// to the compute dtype by the caller); layer_table: host array of 4 ints
// per layer; n_pairs: device pointer to the pair count, at most capacity;
// out [K, H_out] as pair_kernel<false> left it.
inline int launch_tail(const void* rows, const void* table_b,
                       const void* weights_t, const void* layer_table,
                       int n_layers, const void* pair_k, const void* pair_r,
                       const void* n_pairs, int capacity, void* out,
                       int num_centers, int h, int h_out, int bf16,
                       int act_first, int device, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || h <= 0 || h_out <= 0 ||
      capacity < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_centers <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (capacity > 0) {
    slab_mma::ChainArgs args = {};
    args.table_a = rows;
    args.table_b = table_b;
    args.weights_t = static_cast<const float*>(weights_t);
    args.pair_k = static_cast<const int*>(pair_k);
    args.pair_j = static_cast<const int*>(pair_r);
    args.n_pairs = capacity;
    args.n_pairs_dev = static_cast<const int*>(n_pairs);
    args.h = h;
    args.h_out = h_out;
    args.identity_first = act_first ? 0 : 1;
    args.chain = slab_mma::read_chain(layer_table, n_layers);
    args.out = static_cast<float*>(out);
    err = bf16 ? slab_mma::launch_chain<true, false, true>(args, device, s)
               : slab_mma::launch_chain<false, false, true>(args, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n = (size_t)num_centers * h_out;
  const int threads = 256;
  const int blocks = static_cast<int>(
      (n + threads - 1) / threads < 4096 ? (n + threads - 1) / threads : 4096);
  finish_kernel<<<blocks, threads, 0, s>>>(static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace edge_tail
