// fused_edge_max for Hopper (sm_90a): the edge-list tail with the row
// gather inside the kernel (K4).
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (fused_edge_max, body _kernel).  Called from
// pointgnn_tpu_torch/nn/edge_tail.py, which checks the inputs and
// launches this kernel on PyTorch's current stream through a plain C
// interface.
//
// Function: the same as edge_tail_max (K3), with the row of slot (c, s)
// read from A[clamp(src[c, s], 0, n_a - 1)] instead of a pre-gathered
// table; the sentinel src == n_a clamps, and its slot is masked.  The
// chain, the rounding points and the design are edge_tail.cuh's, so K4
// and K3 give bitwise-equal outputs on the same inputs.
//
// Bound on this card.  The same chain FLOPs per valid slot as K3; the
// bytes are the A table once (rows are re-read from L2, not from device
// memory, when several centers share a source), B, the flags, the
// weights and the output: far fewer than K3's gathered table, so K4 is
// bound by operations.  The TPU kernel lost to XLA's gather because
// Mosaic gathered a row at a time; here each row is read by adjacent
// threads as one coalesced run, like any other load.

#include "edge_tail.cuh"

// table_a: [n_a, H] in the compute dtype (bf16 or f32); edges: [K, S]
// int32 source rows; table_b: [K, H] in the compute dtype; valid: [K, S]
// float32; weights: flat float32 chain (rounded to the compute dtype by
// the caller); out: [K, H_out] float32.
extern "C" int fused_edge_max_launch(const void* table_a, const void* edges,
                                     const void* table_b, const void* valid,
                                     const void* weights,
                                     const void* layer_table, int n_layers,
                                     void* out, int num_centers,
                                     int num_slots, int h, int h_out, int bk,
                                     int n_rows_a, int bf16, int act_first,
                                     int device, void* stream) {
  return edge_tail::launch<true>(table_a, edges, table_b, valid, weights,
                                 layer_table, n_layers, out, num_centers,
                                 num_slots, h, h_out, bk, n_rows_a, bf16,
                                 act_first, device, stream);
}
