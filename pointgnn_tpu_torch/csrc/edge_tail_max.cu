// edge_tail_max for Hopper (sm_90a): the edge-list inference tail over a
// pre-gathered row table (K3).
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (edge_tail_max, body _tail_kernel).  Called from
// pointgnn_tpu_torch/nn/edge_tail.py, which checks the inputs, does the
// one row gather G = A[min(src, N-1)] as a torch op (XLA did it outside
// the TPU kernel) and launches these kernels on PyTorch's current stream
// through a plain C interface.
//
// Function: out[c] = max over valid slots s of
// chain(act(G[c * S + s] - B[c])), 0 where no slot is valid; the rounding
// points and the design (valid-slot pair list built on the card, chunks
// of 64 pairs over persistent CTAs, slab_chain.cuh's chain) are in
// edge_tail.cuh, shared with fused_edge_max.
//
// Bound on this card.  Per valid slot the chain costs 2 * sum_l din_l *
// dout_l FLOPs (car L0 tail 32->64->128->300: 97,280; L1 tail 300->300:
// 180,000) and reads one G row (H values in the compute dtype).  At L1
// with bf16 rows that is ~300 FLOPs per byte of G, about the card's bf16
// balance point (989 TFLOP/s over 3.35 TB/s), so bytes and operations
// bound it about equally; at L0 it is operations.

#include "edge_tail.cuh"

// valid: [K, S] float32.  write == 0: counts [K], out [K, H_out] set to
// the "no value" key (out may be null); write == 1: pair_k, pair_r (the
// slot index c * S + s) at the offsets row_ptr [K + 1].
extern "C" int edge_tail_pairs_launch(const void* valid, const void* edges,
                                      void* counts, const void* row_ptr,
                                      void* pair_k, void* pair_r, void* out,
                                      int num_centers, int num_slots,
                                      int h_out, int n_rows_a, int write,
                                      int device, void* stream) {
  return edge_tail::launch_pairs<false>(valid, edges, counts, row_ptr,
                                        pair_k, pair_r, out, num_centers,
                                        num_slots, h_out, n_rows_a, write,
                                        device, stream);
}

// gathered: [K * S, H] in the compute dtype (bf16 or f32); table_b: [K, H]
// in the same dtype; n_pairs: device pointer (row_ptr + K); out: [K,
// H_out] float32 as edge_tail_pairs_launch (write == 0) left it.
extern "C" int edge_tail_max_launch(
    const void* gathered, const void* table_b, const void* weights_t,
    const void* layer_table, int n_layers, const void* pair_k,
    const void* pair_r, const void* n_pairs, int capacity, void* out,
    int num_centers, int h, int h_out, int bf16, int act_first, int device,
    void* stream) {
  return edge_tail::launch_tail(gathered, table_b, weights_t, layer_table,
                                n_layers, pair_k, pair_r, n_pairs, capacity,
                                out, num_centers, h, h_out, bf16, act_first,
                                device, stream);
}
