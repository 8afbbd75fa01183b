// slab_edge_max_bwd for Hopper (sm_90a): backward of slab_edge_max.
//
// Replaces the TPU Pallas kernel pointgnn_tpu/nn/pallas_kernels.py
// (slab_edge_max_train's custom VJP -> _slab_backward -> _slab_bwd_kernel).
// Called from pointgnn_tpu_torch/nn/slab.py (slab_edge_max_backward), which
// checks the inputs, builds the CSR pair list with the forward's pair
// kernels (slab_edge_max.cu), a source-sorted view of it (stable argsort
// of the rows) and the scratch buffers, and launches the kernels below on
// PyTorch's current stream through a plain C interface.
//
// What it computes, given the forward's output y_max [K, H_out] and its
// cotangent g [K, H_out], for every in-radius pair (k, j):
//   recompute x0 = relu(A[j] - B[k]) and the chain, bit for bit as the
//     forward did (slab_mma::chain_kernel in slab_chain.cuh, shared with K1);
//   dz_last[c] = g[k, c] where y[c] == y_max[k, c] and y[c] > 0 (every tied
//     winner gets the full cotangent, as on the TPU), else 0;
//   back through each layer: dW += x_prev^T dz, db += sum dz,
//     dy = dz W^T, dz_prev = dy * (x_prev > 0);
//   d_table_a[j] += dz_0, d_table_b[k] -= dz_0.
// Coordinates and cell metadata get no gradient (graph structure).
// Training runs the chain in f32 (every shipped config), so this kernel
// does f32 only: the recompute is f32 fmaf (K1's f32 route), the
// lower layers' backward split TF32 (3xTF32) on tensor cores.
//
// Bound on this card.  The recompute costs the forward's chain on every
// pair; only the winner (pair, channel) entries carry a cotangent (about
// 4 of 300 channels per pair at level 1), so the last layer's backward
// costs 4 * din FLOPs per winner entry and the layers below a dense
// backward on the pairs.  At 1e5..1e6 pairs a call is bound by
// operations.
//
// Design, six stages over the pair list (CSR by center, chunks of 64
// pairs spread statically over CTAs sized to the SMs, as in K1):
// 1. chain_kernel<f32, train>: recompute as K1 did; writes each
//    layer's input rows per pair (acts) and the winner cotangent dz_last;
// 2. sparse_dy_kernel: one warp per pair compacts its nonzero dz_last
//    entries and sums g * W_last[:, c] over them (c ascending), masked by
//    the last layer's input > 0;
// 3. sparse_dw_kernel: dW_last[:, c] += x_prev[p] * dz[p, c] and db over
//    the nonzero entries only, a CTA per (block of rows, fixed pair
//    range), each range into its own partial slot;
// 4. lower_bwd_kernel, per hidden layer from the top: dz W^T and
//    x_prev^T dz on tensor cores over chunks, dW/db into the CTA's partial
//    slot in shared memory (one owning thread per element);
// 5. table_grad_kernel: d_table_b[k] = -sum of dz_0 over k's run of pairs,
//    d_table_a[j] = sum of dz_0 over j's pairs in the source-sorted order;
// 6. reduce_kernel: dW/db summed over the partial slots in slot order.
// No float atomics: every sum runs in a fixed order, so two runs on the
// same inputs give bitwise-equal gradients.

#include <cstddef>

#include "slab_chain.cuh"

namespace {

using namespace slab;
using slab_mma::kChunk;
using slab_mma::kThreads;
using slab_mma::kWarps;
using slab_mma::round_up;
using slab_mma::row_stride;

// dz_prev[p, i] = (x_prev[p, i] > 0) * sum_c dz[p, c] * W[i, c] over the
// nonzero dz[p, c], c ascending; wt is W as [dout, din].  One warp per
// pair; the nonzero entries are compacted into the warp's shared list.
__global__ void __launch_bounds__(kThreads)
    sparse_dy_kernel(const float* __restrict__ dz,
                     const float* __restrict__ wt,
                     const float* __restrict__ x_prev,
                     float* __restrict__ dz_prev, int n_pairs, int din,
                     int dout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* list_c = reinterpret_cast<int*>(smem) + warp * 2 * dout;
  float* list_g = reinterpret_cast<float*>(list_c + dout);
  const int p = blockIdx.x * kWarps + warp;
  if (p >= n_pairs) return;
  const unsigned lt_mask = (1u << lane) - 1u;
  int cnt = 0;
  for (int c0 = 0; c0 < dout; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < dout ? dz[(size_t)p * dout + c] : 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, v != 0.f);
    if (v != 0.f) {
      const int slot = cnt + __popc(ballot & lt_mask);
      list_c[slot] = c;
      list_g[slot] = v;
    }
    cnt += __popc(ballot);
  }
  __syncwarp();
  for (int i = lane; i < din; i += 32) {
    float acc = 0.f;
    for (int e = 0; e < cnt; ++e) {
      acc = fmaf(list_g[e], __ldg(&wt[(size_t)list_c[e] * din + i]), acc);
    }
    const size_t pi = (size_t)p * din + i;
    dz_prev[pi] = x_prev[pi] > 0.f ? acc : 0.f;
  }
}

// Partial slot b (blockIdx.y) of the last layer, for the rows
// [i0, i0 + rows) of block row blockIdx.x: dW[i, c] = sum over the pairs
// p of range b, ascending, with dz[p, c] != 0 of x_prev[p, i] * dz[p, c],
// and db[c] = sum of those dz[p, c].  Warp w owns the columns c = w
// (mod 8): it finds their nonzero entries pair by pair (warp ballots) and
// adds each one's x_prev row slice into its shared-memory columns, lanes
// over i.  So each dW element has one writer that takes the entries in
// pair order, and each x_prev row is read once per block row.
constexpr int kDwRowsMax = 32 * 6;  // rows a block owns at most
constexpr int kDzBatch = 8;         // pairs whose dz a warp loads at once

__global__ void __launch_bounds__(kThreads)
    sparse_dw_kernel(const float* __restrict__ dz,
                     const float* __restrict__ x_prev,
                     float* __restrict__ dw_part, int n_weights, int w_off,
                     int b_off, int n_pairs, int din, int dout, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [rows, dout + 1]
  const int sa = dout + 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * rows;
  const int ni = min(rows, din - i0);
  const int per = (n_pairs + gridDim.y - 1) / gridDim.y;
  const int pa = min(n_pairs, blockIdx.y * per);
  const int pb = min(n_pairs, pa + per);
  for (int e = tid; e < rows * sa; e += kThreads) acc[e] = 0.f;
  __syncthreads();
  // the warp's columns: c = warp + 8 * (lane + 32 m)
  const int n_cols = (dout - warp + kWarps - 1) / kWarps;
  float db[2] = {0.f, 0.f};
  for (int p0 = pa; p0 < pb; p0 += kDzBatch) {
    float v[kDzBatch][2];
#pragma unroll
    for (int q = 0; q < kDzBatch; ++q)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int cc = lane + 32 * m;
        v[q][m] = (p0 + q < pb && cc < n_cols)
                      ? dz[(size_t)(p0 + q) * dout + warp + kWarps * cc]
                      : 0.f;
      }
    for (int q = 0; q < kDzBatch && p0 + q < pb; ++q) {
      const float* x = x_prev + (size_t)(p0 + q) * din + i0;
      float xv[kDwRowsMax / 32];
      bool loaded = false;
      for (int m = 0; m < 2 && 32 * m < n_cols; ++m) {
        unsigned ballot = __ballot_sync(0xffffffffu, v[q][m] != 0.f);
        db[m] += v[q][m];
        while (ballot != 0) {
          const int src = __ffs(ballot) - 1;
          ballot &= ballot - 1;
          const float g = __shfl_sync(0xffffffffu, v[q][m], src);
          const int c = warp + kWarps * (src + 32 * m);
          if (!loaded) {
#pragma unroll
            for (int u = 0; u < kDwRowsMax / 32; ++u) {
              const int i = lane + 32 * u;
              xv[u] = i < ni ? __ldg(&x[i]) : 0.f;
            }
            loaded = true;
          }
#pragma unroll
          for (int u = 0; u < kDwRowsMax / 32; ++u) {
            const int i = lane + 32 * u;
            if (i < ni) acc[i * sa + c] = fmaf(xv[u], g, acc[i * sa + c]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* part = dw_part + (size_t)blockIdx.y * n_weights;
  for (int e = tid; e < ni * dout; e += kThreads) {
    const int i = e / dout, c = e - i * dout;
    part[w_off + (size_t)(i0 + i) * dout + c] = acc[i * sa + c];
  }
  if (blockIdx.x == 0) {
    for (int m = 0; m < 2; ++m) {
      const int cc = lane + 32 * m;
      if (cc < n_cols) part[b_off + warp + kWarps * cc] = db[m];
    }
  }
}

// Shared-memory layout of lower_bwd_kernel, in floats.
struct LowerLayout {
  int w, sw, dz, sdz, dzt, sdzt, xt, sxt, xt_rows, dw, db, total;
  __host__ __device__ LowerLayout(int din, int dout) {
    sw = row_stride(dout, false);
    sdz = row_stride(dout, false);
    sdzt = row_stride(kChunk, false);
    sxt = row_stride(kChunk, false);
    xt_rows = round_up(din, 32);
    w = 0;
    dz = w + round_up(round_up(din, 32) * sw, 4);
    dzt = dz + kChunk * sdz;
    xt = dzt + round_up(dout, 32) * sdzt;
    dw = xt + xt_rows * sxt;
    db = dw + round_up(din * dout, 4);
    total = db + round_up(dout, 4);
  }
};

// Backward of one hidden layer (din -> dout) over the chunks: given
// dz [n, dout] (the cotangent of its ReLU output, already masked) and its
// input x [n, din], writes dz_prev [n, din] = (dz W^T) * (x > 0) and adds
// x^T dz and sum(dz) into the CTA's partial slot, on tensor cores (3xTF32).
__global__ void __launch_bounds__(kThreads)
    lower_bwd_kernel(const float* __restrict__ dz_in,
                     const float* __restrict__ x_in,
                     const float* __restrict__ weights,
                     float* __restrict__ dz_prev, float* __restrict__ dw_part,
                     int n_weights, int w_off, int b_off, int n_pairs, int din,
                     int dout) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  const LowerLayout lay(din, dout);
  float* w = s + lay.w;
  float* dz = s + lay.dz;
  float* dzt = s + lay.dzt;
  float* xt = s + lay.xt;
  float* dw = s + lay.dw;
  float* db = s + lay.db;
  const int tid = threadIdx.x;
  for (int i = tid; i < lay.total; i += kThreads) s[i] = 0.f;
  __syncthreads();
  // B of dz W^T as [n = i][k = o]: W itself, row-major [din, dout]
  for (int idx = tid; idx < din * dout; idx += kThreads) {
    const int i = idx / dout, o = idx - i * dout;
    w[i * lay.sw + o] = weights[w_off + idx];
  }
  const int n_chunks = (n_pairs + kChunk - 1) / kChunk;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int p0 = chunk * kChunk;
    const int np = min(kChunk, n_pairs - p0);
    __syncthreads();
    for (int idx = tid; idx < kChunk * dout; idx += kThreads) {
      const int p = idx / dout, o = idx - p * dout;
      const float v = p < np ? dz_in[(size_t)(p0 + p) * dout + o] : 0.f;
      dz[p * lay.sdz + o] = v;
      dzt[o * lay.sdzt + p] = v;
    }
    for (int idx = tid; idx < kChunk * din; idx += kThreads) {
      const int p = idx / din, i = idx - p * din;
      xt[i * lay.sxt + p] = p < np ? x_in[(size_t)(p0 + p) * din + i] : 0.f;
    }
    __syncthreads();
    slab_mma::gemm<false, true>(dz, lay.sdz, kChunk, w, lay.sw, din,
                          slab_mma::k_pad(dout, false),
                          [&](int r, int c, float v) {
                            if (r < np) {
                              dz_prev[(size_t)(p0 + r) * din + c] =
                                  xt[c * lay.sxt + r] > 0.f ? v : 0.f;
                            }
                          });
    slab_mma::gemm<false, true>(xt, lay.sxt, lay.xt_rows, dzt, lay.sdzt, dout,
                          kChunk, [&](int r, int c, float v) {
                            if (r < din) dw[r * dout + c] += v;
                          });
    for (int o = tid; o < dout; o += kThreads) {
      float sb = db[o];
      for (int p = 0; p < np; ++p) sb += dz[p * lay.sdz + o];
      db[o] = sb;
    }
  }
  __syncthreads();
  float* part = dw_part + (size_t)blockIdx.x * n_weights;
  for (int idx = tid; idx < din * dout; idx += kThreads) {
    part[w_off + idx] = dw[idx];
  }
  for (int o = tid; o < dout; o += kThreads) part[b_off + o] = db[o];
}

// d_table_b[k, i] = -sum over k's run of pairs, ascending, of dz0[p, i];
// d_table_a[j, i] = sum over j's pairs in the source-sorted order.
__global__ void __launch_bounds__(kThreads)
    table_grad_kernel(const float* __restrict__ dz0,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ src_perm,
                      const int* __restrict__ src_ptr,
                      float* __restrict__ d_table_a,
                      float* __restrict__ d_table_b, int num_centers,
                      int p_rows, int h) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n_b = (size_t)num_centers * h;
  if (idx < n_b) {
    const int k = static_cast<int>(idx / h), i = static_cast<int>(idx % h);
    float s = 0.f;
    for (int p = row_ptr[k]; p < row_ptr[k + 1]; ++p) {
      s += dz0[(size_t)p * h + i];
    }
    d_table_b[idx] = -s;
  } else if (idx < n_b + (size_t)p_rows * h) {
    const size_t ia = idx - n_b;
    const int j = static_cast<int>(ia / h), i = static_cast<int>(ia % h);
    float s = 0.f;
    for (int q = src_ptr[j]; q < src_ptr[j + 1]; ++q) {
      s += dz0[(size_t)src_perm[q] * h + i];
    }
    d_table_a[ia] = s;
  }
}

// d_w[e] = sum over partial slots b, ascending, of dw_part[b, e].
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ dw_part, float* __restrict__ d_w,
                  int n_weights, int n_parts) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_weights) return;
  float s = 0.f;
  for (int b = 0; b < n_parts; ++b) s += dw_part[(size_t)b * n_weights + e];
  d_w[e] = s;
}

}  // namespace

// weights / weights_t: the flat f32 chain, as given and with every weight
// transposed to [dout, din]; layer_table: host array of 4 ints per layer
// (weight offset, bias offset, din, dout).  The pair list: pair_k, pair_j
// [n_pairs] grouped by center at row_ptr [K + 1]; src_perm [n_pairs] the
// pair indices in stable row order, src_ptr [P + 1] its offsets per row.
// Scratch: acts (sum over layers of n_pairs * din_l floats, at act_offsets
// [n_layers]), dz_last [n_pairs * H_out], dz_a and dz_b [n_pairs * max
// layer input width] each, dw_part [n_parts * n_weights].  Returns the
// CUDA error code of the launches (0 on success).
extern "C" int slab_edge_max_bwd_launch(
    const void* table_a, const void* table_b, const void* weights,
    const void* weights_t, const void* layer_table, int n_layers,
    int n_weights, const void* pair_k, const void* pair_j,
    const void* row_ptr, const void* src_perm, const void* src_ptr,
    int n_pairs, const void* y_max, const void* g, void* acts,
    const void* act_offsets, void* dz_last, void* dz_a, void* dz_b,
    void* dw_part, int n_parts, void* d_table_a, void* d_table_b, void* d_w,
    int num_centers, int p_rows, int h, int h_out, int device, void* stream) {
  if (n_layers < 0 || n_layers > kMaxLayers || h <= 0 || h_out <= 0 ||
      n_weights < 0 || n_parts <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const Chain chain = slab_mma::read_chain(layer_table, n_layers);
  const auto* w = static_cast<const float*>(weights);
  const auto* wt = static_cast<const float*>(weights_t);
  auto* act = static_cast<float*>(acts);
  const auto* act_off = static_cast<const long long*>(act_offsets);
  auto* dzl = static_cast<float*>(dz_last);
  auto* part = static_cast<float*>(dw_part);
  float* dz0 = dzl;
  if (n_pairs > 0) {
    slab_mma::ChainArgs args = {};
    args.table_a = static_cast<const float*>(table_a);
    args.table_b = static_cast<const float*>(table_b);
    args.weights_t = wt;
    args.pair_k = static_cast<const int*>(pair_k);
    args.pair_j = static_cast<const int*>(pair_j);
    args.n_pairs = n_pairs;
    args.h = h;
    args.h_out = h_out;
    args.chain = chain;
    args.y_max = static_cast<const float*>(y_max);
    args.g = static_cast<const float*>(g);
    args.dz_last = dzl;
    args.acts = act;
    for (int l = 0; l < n_layers; ++l) args.act_off[l] = act_off[l];
    err = slab_mma::launch_chain<false, true>(args, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_layers > 0) {
    const int last = n_layers - 1;
    const int din = chain.din[last], dout = chain.dout[last];
    const float* x_prev = act + act_off[last];
    float* dz_cur = static_cast<float*>(dz_a);
    float* dz_next = static_cast<float*>(dz_b);
    if (n_pairs > 0) {
      const size_t smem = sizeof(int) * 2 * kWarps * dout;
      err = cudaFuncSetAttribute(sparse_dy_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      sparse_dy_kernel<<<(n_pairs + kWarps - 1) / kWarps, kThreads, smem,
                         s>>>(dzl, wt + chain.w_off[last], x_prev, dz_cur,
                              n_pairs, din, dout);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    {
      // rows per block: at most kDwRowsMax, and [rows, dout + 1] floats
      // must fit in shared memory
      int rows = (int)(slab_mma::kMaxSmem / sizeof(float)) / (dout + 1);
      rows = rows < kDwRowsMax ? rows : kDwRowsMax;
      if (dout > 2 * 32 * kWarps || rows <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int blocks_i = (din + rows - 1) / rows;
      rows = (din + blocks_i - 1) / blocks_i;
      const size_t smem = sizeof(float) * rows * (dout + 1);
      err = cudaFuncSetAttribute(sparse_dw_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      sparse_dw_kernel<<<dim3(blocks_i, n_parts), kThreads, smem, s>>>(
          dzl, x_prev, part, n_weights, chain.w_off[last], chain.b_off[last],
          n_pairs, din, dout, rows);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int l = last - 1; l >= 0; --l) {
      const LowerLayout lay(chain.din[l], chain.dout[l]);
      const size_t smem = sizeof(float) * lay.total;
      if (smem > slab_mma::kMaxSmem) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = cudaFuncSetAttribute(lower_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      lower_bwd_kernel<<<n_parts, kThreads, smem, s>>>(
          dz_cur, act + act_off[l], w, dz_next, part, n_weights,
          chain.w_off[l], chain.b_off[l], n_pairs, chain.din[l],
          chain.dout[l]);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      float* t = dz_cur;
      dz_cur = dz_next;
      dz_next = t;
    }
    dz0 = dz_cur;
  }
  const size_t n_tab = (size_t)(num_centers + p_rows) * h;
  if (n_tab > 0) {
    table_grad_kernel<<<(unsigned)((n_tab + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(
        dz0, static_cast<const int*>(row_ptr),
        static_cast<const int*>(src_perm), static_cast<const int*>(src_ptr),
        static_cast<float*>(d_table_a), static_cast<float*>(d_table_b),
        num_centers, p_rows, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_weights > 0) {
    reduce_kernel<<<(n_weights + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        part, static_cast<float*>(d_w), n_weights, n_parts);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
