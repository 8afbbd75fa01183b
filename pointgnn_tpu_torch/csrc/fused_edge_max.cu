// fused_edge_max for Hopper (sm_90a): the edge-list tail with the row
// gather inside the kernel (K4).
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (fused_edge_max, body _kernel).  Called from
// pointgnn_tpu_torch/nn/edge_tail.py, which checks the inputs and
// launches these kernels on PyTorch's current stream through a plain C
// interface.
//
// Function: the same as edge_tail_max (K3), with the row of slot (c, s)
// read from A[clamp(src[c, s], 0, n_a - 1)] instead of a pre-gathered
// table; the sentinel src == n_a clamps, and its slot is masked.  The
// pair list holds that clamped A row, so the chain, the rounding points
// and the design are edge_tail.cuh's and K4 equals K3 bit for bit on
// the same inputs.
//
// Bound on this card.  The same chain FLOPs per valid slot as K3; the
// bytes are the A table once (rows are re-read from L2, not from device
// memory, when several centers share a source), B, the flags, the edges,
// the weights and the output: far fewer than K3's gathered table, so K4
// is bound by operations.

#include "edge_tail.cuh"

// valid, edges: [K, S] float32 and int32.  write == 0: counts [K], out
// [K, H_out] set to the "no value" key (out may be null); write == 1:
// pair_k, pair_r (the clamped source row) at the offsets row_ptr [K + 1].
extern "C" int fused_edge_pairs_launch(const void* valid, const void* edges,
                                       void* counts, const void* row_ptr,
                                       void* pair_k, void* pair_r, void* out,
                                       int num_centers, int num_slots,
                                       int h_out, int n_rows_a, int write,
                                       int device, void* stream) {
  return edge_tail::launch_pairs<true>(valid, edges, counts, row_ptr, pair_k,
                                       pair_r, out, num_centers, num_slots,
                                       h_out, n_rows_a, write, device,
                                       stream);
}

// table_a: [n_a, H] in the compute dtype (bf16 or f32); table_b: [K, H] in
// the same dtype; n_pairs: device pointer (row_ptr + K); out: [K, H_out]
// float32 as fused_edge_pairs_launch (write == 0) left it.
extern "C" int fused_edge_max_launch(
    const void* table_a, const void* table_b, const void* weights_t,
    const void* layer_table, int n_layers, const void* pair_k,
    const void* pair_r, const void* n_pairs, int capacity, void* out,
    int num_centers, int h, int h_out, int bf16, int act_first, int device,
    void* stream) {
  return edge_tail::launch_tail(table_a, table_b, weights_t, layer_table,
                                n_layers, pair_k, pair_r, n_pairs, capacity,
                                out, num_centers, h, h_out, bf16, act_first,
                                device, stream);
}
