// slab_edge_max_bwd for Hopper (sm_90a): backward of slab_edge_max.
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (slab_edge_max_train's custom VJP -> _slab_backward -> _slab_bwd_kernel).
// Called from pointgnn_tpu_torch/nn/slab.py (slab_edge_max_backward), which
// checks the inputs, computes the candidate row windows [lo, hi) of every
// (center block, grid column), their offsets into the per-block partial
// buffer and each row's column, and launches the three kernels below on
// PyTorch's current stream through a plain C interface.
//
// What it computes, given the forward's output y_max [K, H_out] and its
// cotangent g [K, H_out], for every in-radius pair (k, j) of the walk:
//   recompute x0 = relu(A[j] - B[k]) and the chain, bit for bit as the
//     forward did (slab_chain.cuh);
//   dz_last[c] = g[k, c] where y[c] == y_max[k, c] and y[c] > 0 (every tied
//     winner gets the full cotangent, as on the TPU), else 0;
//   back through each layer: dW += x_prev^T dz, db += sum dz,
//     dy = dz W^T, dz_prev = dy * (x_prev > 0);
//   d_table_a[j] += dz_0, d_table_b[k] -= dz_0.
// Coordinates and cell metadata get no gradient (graph structure).
// Training runs the chain in f32 (every shipped config), so this kernel
// does f32 only: no rounding point, no TF32.
//
// Bound on this card.  Per in-radius pair the work is three chain-sized
// products (recompute, dW, dy): 3 * 2 * sum_l din_l * dout_l FLOPs; the
// unique bytes are the tables, coordinates, weights, g, y_max and the
// gradients (a few MB).  At 1e5..1e6 pairs a call is bound by operations.
// Training runs in f32 without TF32, so the peak is the 67 TFLOP/s of f32
// outside the tensor cores.
//
// Design (a simple kernel that is right first; speed is later work):
// - main kernel: one CTA of 256 threads per block of bk centers walks
//   exactly [lo, hi) of every column in tiles of kTileRows rows, as the
//   forward does.  A tile's in-radius pairs are compacted in (center,
//   row) order with warp ballots (no atomics: the order, and with it every
//   floating-point sum, is the same on every run);
// - pairs run kPairBatch at a time: the chain is recomputed keeping every
//   layer's activation in shared memory, the cotangent replaces the last
//   activation in place, and each layer's backward overwrites its input
//   activation with the cotangent of the layer below;
// - cross-CTA sums never use atomics.  d_table_b rows belong to the CTA
//   (shared-memory accumulator, written once).  dW/db go to a per-CTA
//   partial slice in device memory (the owning thread of a column is its
//   only writer), summed over CTAs in block order by dw_reduce_kernel.
//   A tile's d_table_a rows are summed in shared memory and written to the
//   CTA's window slot of a partial buffer; da_reduce_kernel sums each
//   row's slots over the center blocks in block order.  So two runs on
//   the same inputs give bitwise-equal gradients.

#include <cstddef>

#include "slab_chain.cuh"

namespace {

using namespace slab;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairBatch = 32;
constexpr int kTileRows = 32;
constexpr size_t kMaxSmem = 232448;  // Hopper: 227 KB per block

// Shared-memory layout, in floats; every section starts 16-byte aligned.
struct BwdLayout {
  int act[kMaxLayers + 1];  // [kPairBatch, align4(dim_l)] per activation
  int stride[kMaxLayers + 1];
  int scratch, scratch_stride, da, db, ctr, pairs, total;
  __host__ __device__ BwdLayout(const Chain& c, int bk, int h) {
    int off = 0;
    int width = h;
    for (int l = 0; l <= c.n_layers; ++l) {
      const int dim = l == 0 ? h : c.dout[l - 1];
      width = dim > width ? dim : width;
      act[l] = off;
      stride[l] = align4(dim);
      off += kPairBatch * stride[l];
    }
    scratch = off;
    scratch_stride = align4(width);
    off += kPairBatch * scratch_stride;
    da = off;
    off += align4(kTileRows * h);
    db = off;
    off += align4(bk * h);
    ctr = off;
    off += bk * 4;
    pairs = off;
    total = pairs + 2 * bk * kTileRows;
  }
};

// Compacts the tile's in-radius (center, row) candidates into s_pk/s_pj
// in candidate order (center-major), with warp ballots and a scan over
// the warps.  Returns the pair count (the same value in every thread).
__device__ int compact_pairs(const float* __restrict__ src_xyz,
                             const float* s_ctr, int* s_pk, int* s_pj,
                             int* s_warp, int r0, int nrows, int nk, int bk,
                             float r2) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  int base = 0;
  for (int c0 = 0; c0 < bk * kTileRows; c0 += kThreads) {
    const int c = c0 + tid;
    const int k = c / kTileRows;
    const int jj = c - k * kTileRows;
    bool hit = false;
    if (k < nk && jj < nrows) {
      hit = in_radius(&src_xyz[(size_t)(r0 + jj) * 4], &s_ctr[k * 4], r2);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_warp[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (hit) {
      const int slot = before + __popc(ballot & lt_mask);
      s_pk[slot] = k;
      s_pj[slot] = jj;
    }
    base += total;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  return base;
}

// Backward of pairs [0, np) of the lists (np <= kPairBatch).  Ends with
// all threads synchronised.
__device__ void backward_batch(
    const float* __restrict__ table_a, const float* __restrict__ table_b,
    const float* __restrict__ weights, const float* __restrict__ weights_t,
    const Chain& chain, const BwdLayout& lay, float* smem,
    const float* __restrict__ y_max, const float* __restrict__ g,
    float* my_dw, const int* pk, const int* pj, int np, int k0, int r0,
    int h, int h_out) {
  const int tid = threadIdx.x;
  const int n_layers = chain.n_layers;
  float* x0 = smem + lay.act[0];
  const int st0 = lay.stride[0];
  for (int idx = tid; idx < kPairBatch * h; idx += kThreads) {
    const int p = idx / h, i = idx - (idx / h) * h;
    float v = 0.f;
    if (p < np) {
      const size_t j = r0 + pj[p];
      const size_t k = k0 + pk[p];
      v = first_act<false>(table_a[j * h + i], table_b[k * h + i]);
    }
    x0[p * st0 + i] = v;
  }
  __syncthreads();

  // forward recompute, keeping every activation
  for (int l = 0; l < n_layers; ++l) {
    const int din = chain.din[l], dout = chain.dout[l];
    const float* __restrict__ w = weights + chain.w_off[l];
    const float* __restrict__ bias = weights + chain.b_off[l];
    const float* xin = smem + lay.act[l];
    float* xout = smem + lay.act[l + 1];
    const int sin = lay.stride[l], sout = lay.stride[l + 1];
    const bool last = (l + 1 == n_layers);
    for (int o = tid; o < dout; o += kThreads) {
      float acc[kPairBatch];
      dense_column<kPairBatch>(xin, sin, w, din, dout, o, acc);
      const float bo = __ldg(&bias[o]);
#pragma unroll
      for (int p = 0; p < kPairBatch; ++p) {
        xout[p * sout + o] =
            last ? last_out(acc[p], bo) : hidden_out<false>(acc[p], bo);
      }
    }
    __syncthreads();
  }

  // winners: the cotangent goes to every pair whose output equals the
  // forward's max; the last ReLU masks zero outputs
  {
    float* y = smem + lay.act[n_layers];
    const int sy = lay.stride[n_layers];
    for (int idx = tid; idx < kPairBatch * h_out; idx += kThreads) {
      const int p = idx / h_out, c = idx - (idx / h_out) * h_out;
      float v = 0.f;
      if (p < np) {
        const size_t kc = (size_t)(k0 + pk[p]) * h_out + c;
        const float yv = y[p * sy + c];
        if (yv > 0.f && yv == y_max[kc]) v = g[kc];
      }
      y[p * sy + c] = v;
    }
    __syncthreads();
  }

  // back through the chain: act[l + 1] holds dz of layer l
  for (int l = n_layers - 1; l >= 0; --l) {
    const int din = chain.din[l], dout = chain.dout[l];
    float* xp = smem + lay.act[l];
    const float* dz = smem + lay.act[l + 1];
    const int sp = lay.stride[l], sz = lay.stride[l + 1];
    float* scratch = smem + lay.scratch;
    const int ss = lay.scratch_stride;
    float* dw = my_dw + chain.w_off[l];
    float* db = my_dw + chain.b_off[l];
    // dW[:, o] += x_prev^T dz[:, o] and db[o] += sum_p dz[p, o]
    for (int o = tid; o < dout; o += kThreads) {
      float dzr[kPairBatch];
      float sb = 0.f;
#pragma unroll
      for (int p = 0; p < kPairBatch; ++p) {
        dzr[p] = dz[p * sz + o];
        sb += dzr[p];
      }
      db[o] += sb;
      int i = 0;
      for (; i + 4 <= din; i += 4) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int p = 0; p < kPairBatch; ++p) {
          const float4 xv = *reinterpret_cast<const float4*>(&xp[p * sp + i]);
          s0 = fmaf(xv.x, dzr[p], s0);
          s1 = fmaf(xv.y, dzr[p], s1);
          s2 = fmaf(xv.z, dzr[p], s2);
          s3 = fmaf(xv.w, dzr[p], s3);
        }
        dw[(size_t)(i + 0) * dout + o] += s0;
        dw[(size_t)(i + 1) * dout + o] += s1;
        dw[(size_t)(i + 2) * dout + o] += s2;
        dw[(size_t)(i + 3) * dout + o] += s3;
      }
      for (; i < din; ++i) {
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < kPairBatch; ++p) s = fmaf(xp[p * sp + i], dzr[p], s);
        dw[(size_t)i * dout + o] += s;
      }
    }
    // dy[:, i] = dz W^T, from the transposed weights wt[o, i] = w[i, o]
    const float* __restrict__ wt = weights_t + chain.w_off[l];
    for (int i = tid; i < din; i += kThreads) {
      float acc[kPairBatch];
#pragma unroll
      for (int p = 0; p < kPairBatch; ++p) acc[p] = 0.f;
      int o = 0;
      for (; o + 4 <= dout; o += 4) {
        const float w0 = __ldg(&wt[(size_t)(o + 0) * din + i]);
        const float w1 = __ldg(&wt[(size_t)(o + 1) * din + i]);
        const float w2 = __ldg(&wt[(size_t)(o + 2) * din + i]);
        const float w3 = __ldg(&wt[(size_t)(o + 3) * din + i]);
#pragma unroll
        for (int p = 0; p < kPairBatch; ++p) {
          const float4 dv = *reinterpret_cast<const float4*>(&dz[p * sz + o]);
          acc[p] = fmaf(dv.x, w0, acc[p]);
          acc[p] = fmaf(dv.y, w1, acc[p]);
          acc[p] = fmaf(dv.z, w2, acc[p]);
          acc[p] = fmaf(dv.w, w3, acc[p]);
        }
      }
      for (; o < dout; ++o) {
        const float wo = __ldg(&wt[(size_t)o * din + i]);
#pragma unroll
        for (int p = 0; p < kPairBatch; ++p) {
          acc[p] = fmaf(dz[p * sz + o], wo, acc[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPairBatch; ++p) scratch[p * ss + i] = acc[p];
    }
    __syncthreads();
    // dz of the layer below (or, at l == 0, the table cotangent):
    // dy * relu'(x_prev), written over x_prev
    for (int idx = tid; idx < kPairBatch * din; idx += kThreads) {
      const int p = idx / din, i = idx - (idx / din) * din;
      const float xv = xp[p * sp + i];
      xp[p * sp + i] = xv > 0.f ? scratch[p * ss + i] : 0.f;
    }
    __syncthreads();
  }
  // With no layers the cotangent sits on x0 itself, whose mask the winner
  // step already applied.

  // table cotangents: the thread of channel i is its only writer
  float* s_da = smem + lay.da;
  float* s_db = smem + lay.db;
  for (int i = tid; i < h; i += kThreads) {
    for (int p = 0; p < np; ++p) {
      const float v = x0[p * st0 + i];
      s_da[pj[p] * h + i] += v;
      s_db[pk[p] * h + i] -= v;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    slab_bwd_kernel(const float* __restrict__ table_a,
                    const float* __restrict__ src_xyz,
                    const float* __restrict__ table_b,
                    const float* __restrict__ ctr_xyz,
                    const int* __restrict__ win_lo,
                    const int* __restrict__ win_hi,
                    const int* __restrict__ win_base,
                    const float* __restrict__ weights,
                    const float* __restrict__ weights_t, Chain chain,
                    const float* __restrict__ y_max,
                    const float* __restrict__ g, float* __restrict__ da_part,
                    float* __restrict__ d_table_b, float* __restrict__ dw_part,
                    int n_weights, int num_centers, int h, int h_out,
                    int grid_g, int bk, float r2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_warp[kWarps];
  const BwdLayout lay(chain, bk, h);
  float* s_da = smem + lay.da;
  float* s_db = smem + lay.db;
  float* s_ctr = smem + lay.ctr;
  int* s_pk = reinterpret_cast<int*>(smem + lay.pairs);
  int* s_pj = s_pk + bk * kTileRows;

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int k0 = blk * bk;
  const int nk = min(bk, num_centers - k0);
  float* my_dw = dw_part + (size_t)blk * n_weights;

  for (int idx = tid; idx < n_weights; idx += kThreads) my_dw[idx] = 0.f;
  for (int idx = tid; idx < bk * 4; idx += kThreads) {
    s_ctr[idx] = idx / 4 < nk ? ctr_xyz[(size_t)k0 * 4 + idx] : -1e6f;
  }
  for (int idx = tid; idx < kTileRows * h; idx += kThreads) s_da[idx] = 0.f;
  for (int idx = tid; idx < bk * h; idx += kThreads) s_db[idx] = 0.f;
  __syncthreads();

  for (int col = 0; col < grid_g; ++col) {
    const int lo = win_lo[(size_t)blk * grid_g + col];
    const int hi = win_hi[(size_t)blk * grid_g + col];
    const size_t slot = win_base[(size_t)blk * grid_g + col];
    for (int r0 = lo; r0 < hi; r0 += kTileRows) {
      const int nrows = min(kTileRows, hi - r0);
      const int n = compact_pairs(src_xyz, s_ctr, s_pk, s_pj, s_warp, r0,
                                  nrows, nk, bk, r2);
      for (int p0 = 0; p0 < n; p0 += kPairBatch) {
        backward_batch(table_a, table_b, weights, weights_t, chain,
                              lay, smem, y_max, g, my_dw, s_pk + p0,
                              s_pj + p0, min(kPairBatch, n - p0), k0, r0, h,
                              h_out);
      }
      float* dst = da_part + (slot + (size_t)(r0 - lo)) * h;
      for (int idx = tid; idx < nrows * h; idx += kThreads) {
        dst[idx] = s_da[idx];
        s_da[idx] = 0.f;
      }
      __syncthreads();
    }
  }
  for (int idx = tid; idx < nk * h; idx += kThreads) {
    d_table_b[(size_t)k0 * h + idx] = s_db[idx];
  }
}

// d_table_a[j, i] = sum over center blocks b, ascending, whose window of
// row j's column holds j, of that window slot's partial row.
__global__ void __launch_bounds__(kThreads)
    da_reduce_kernel(const float* __restrict__ da_part,
                     const int* __restrict__ win_lo,
                     const int* __restrict__ win_hi,
                     const int* __restrict__ win_base,
                     const int* __restrict__ row_col,
                     float* __restrict__ d_table_a, int p_rows, int nb,
                     int grid_g, int h) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)p_rows * h) return;
  const int j = static_cast<int>(idx / h);
  const int i = static_cast<int>(idx - (size_t)j * h);
  const int col = row_col[j];
  float s = 0.f;
  if (col >= 0) {
    for (int b = 0; b < nb; ++b) {
      const size_t w = (size_t)b * grid_g + col;
      const int lo = win_lo[w];
      if (j >= lo && j < win_hi[w]) {
        s += da_part[((size_t)win_base[w] + (j - lo)) * h + i];
      }
    }
  }
  d_table_a[idx] = s;
}

// d_w[e] = sum over center blocks b, ascending, of dw_part[b, e].
__global__ void __launch_bounds__(kThreads)
    dw_reduce_kernel(const float* __restrict__ dw_part,
                     float* __restrict__ d_w, int n_weights, int nb) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_weights) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += dw_part[(size_t)b * n_weights + e];
  d_w[e] = s;
}

cudaError_t launch(const float* table_a, const float* src_xyz,
                   const float* table_b, const float* ctr_xyz,
                   const int* win_lo, const int* win_hi, const int* win_base,
                   const int* row_col, const float* weights,
                   const float* weights_t, const Chain& chain, int n_weights,
                   const float* y_max, const float* g, float* da_part,
                   float* d_table_a, float* d_table_b, float* dw_part,
                   float* d_w, int num_centers, int p_rows, int h, int h_out,
                   int grid_g, int bk, float r2, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(BwdLayout(chain, bk, h).total);
  if (smem > kMaxSmem - sizeof(int) * kWarps) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      slab_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nb = (num_centers + bk - 1) / bk;
  slab_bwd_kernel<<<nb, kThreads, smem, stream>>>(
      table_a, src_xyz, table_b, ctr_xyz, win_lo, win_hi, win_base, weights,
      weights_t, chain, y_max, g, da_part, d_table_b, dw_part, n_weights,
      num_centers, h, h_out, grid_g, bk, r2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n_da = (size_t)p_rows * h;
  if (n_da > 0) {
    da_reduce_kernel<<<(unsigned)((n_da + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(da_part, win_lo, win_hi, win_base, row_col,
                                    d_table_a, p_rows, nb, grid_g, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_weights > 0) {
    dw_reduce_kernel<<<(n_weights + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(dw_part, d_w, n_weights, nb);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// layer_table: host array of 4 ints per layer (weight offset, bias offset,
// din, dout) into `weights`; `weights_t` has the same layout with every
// weight transposed to [dout, din].  win_base [nb, grid_g]: offset, in
// rows, of each window's slot in da_part; row_col [P]: grid column of
// each candidate row (-1 for pad rows).  dw_part holds nb * n_weights
// floats.  Returns the CUDA error code of the launches (0 on success).
extern "C" int slab_edge_max_bwd_launch(
    const void* table_a, const void* src_xyz, const void* table_b,
    const void* ctr_xyz, const void* win_lo, const void* win_hi,
    const void* win_base, const void* row_col, const void* weights,
    const void* weights_t, const void* layer_table, int n_layers,
    int n_weights, const void* y_max, const void* g, void* da_part,
    void* d_table_a, void* d_table_b, void* dw_part, void* d_w,
    int num_centers, int p_rows, int h, int h_out, int grid_g, int bk,
    float r2, int device, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || bk <= 0 || h <= 0 ||
      h_out <= 0 || n_weights < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_centers <= 0) return 0;
  Chain chain;
  chain.n_layers = n_layers;
  const int* tbl = static_cast<const int*>(layer_table);
  for (int l = 0; l < n_layers; ++l) {
    chain.w_off[l] = tbl[4 * l + 0];
    chain.b_off[l] = tbl[4 * l + 1];
    chain.din[l] = tbl[4 * l + 2];
    chain.dout[l] = tbl[4 * l + 3];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(table_a);
  const auto* sx = static_cast<const float*>(src_xyz);
  const auto* b = static_cast<const float*>(table_b);
  const auto* cx = static_cast<const float*>(ctr_xyz);
  const auto* lo = static_cast<const int*>(win_lo);
  const auto* hi = static_cast<const int*>(win_hi);
  const auto* base = static_cast<const int*>(win_base);
  const auto* rc = static_cast<const int*>(row_col);
  const auto* w = static_cast<const float*>(weights);
  const auto* wt = static_cast<const float*>(weights_t);
  const auto* ym = static_cast<const float*>(y_max);
  const auto* gg = static_cast<const float*>(g);
  auto* dap = static_cast<float*>(da_part);
  auto* da = static_cast<float*>(d_table_a);
  auto* dbt = static_cast<float*>(d_table_b);
  auto* dwp = static_cast<float*>(dw_part);
  auto* dw = static_cast<float*>(d_w);
  err = launch(a, sx, b, cx, lo, hi, base, rc, w, wt, chain, n_weights, ym,
               gg, dap, da, dbt, dwp, dw, num_centers, p_rows, h, h_out,
               grid_g, bk, r2, s);
  return static_cast<int>(err);
}
