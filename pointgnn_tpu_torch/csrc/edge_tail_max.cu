// edge_tail_max for Hopper (sm_90a): the edge-list inference tail over a
// pre-gathered row table (K3).
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (edge_tail_max, body _tail_kernel).  Called from
// pointgnn_tpu_torch/nn/edge_tail.py, which checks the inputs, does the
// one row gather G = A[min(src, N-1)] as a torch op (XLA did it outside
// the TPU kernel) and launches this kernel on PyTorch's current stream
// through a plain C interface.
//
// Function: out[c] = max over valid slots s of
// chain(act(G[c * S + s] - B[c])), 0 where no slot is valid; the rounding
// points and the design are in edge_tail.cuh, shared with fused_edge_max.
//
// Bound on this card.  Per valid slot the chain costs 2 * sum_l din_l *
// dout_l FLOPs (car L0 tail 32->64->128->300: 97,280; L1 tail 300->300:
// 180,000) and reads one G row (H values in the compute dtype).  At L1
// with bf16 rows that is ~300 FLOPs per byte of G, about the card's
// bf16 balance point (989 TFLOP/s over 3.35 TB/s), so bytes and
// operations bound it about equally; at L0 it is operations.  This first
// kernel runs the chain on CUDA cores and is far from either bound.

#include "edge_tail.cuh"

// gathered: [K * S, H] in the compute dtype (bf16 or f32); table_b: [K, H]
// in the same dtype; valid: [K, S] float32; weights: flat float32 chain
// (rounded to the compute dtype by the caller); out: [K, H_out] float32.
extern "C" int edge_tail_max_launch(const void* gathered, const void* table_b,
                                    const void* valid, const void* weights,
                                    const void* layer_table, int n_layers,
                                    void* out, int num_centers, int num_slots,
                                    int h, int h_out, int bk, int bf16,
                                    int act_first, int device, void* stream) {
  return edge_tail::launch<false>(
      gathered, nullptr, table_b, valid, weights, layer_table, n_layers, out,
      num_centers, num_slots, h, h_out, bk, /*n_rows_a=*/1, bf16, act_first,
      device, stream);
}
