// Chain arithmetic of the hand-written kernels:
//   slab_edge_max.cu      (K1 forward: exact radius search + edge MLP + max)
//   slab_edge_max_bwd.cu  (K2 backward: recompute + route to the max winners)
//   edge_tail.cuh         (K3/K4: dense_column and the layer epilogues)
//
// The backward finds each channel's winners by exact equality with the
// forward's output, so it must recompute every in-radius pair's chain bit
// for bit as the forward did.  Both slab kernels therefore take the
// distance test, the first activation, the layer epilogues and the
// tensor-core chain (slab_mma::chain_kernel, below) from this one header.
// dense_column is the CUDA-core product of the edge-list tail.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace slab {

constexpr int kMaxLayers = 8;
constexpr float kNeg = -1e30f;

// Edge-MLP tail: per layer the offsets of its weight [din, dout] and bias
// [dout] in one flat float buffer.
struct Chain {
  int n_layers;
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int din[kMaxLayers];
  int dout[kMaxLayers];
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// |p - c|^2 <= r2 in exact f32, x, y, z order, with no FMA contraction,
// so boundary pairs agree with the plain PyTorch version bit for bit.
__device__ __forceinline__ bool in_radius(const float* __restrict__ p,
                                          const float* c, float r2) {
  const float dx = __fsub_rn(p[0], c[0]);
  const float dy = __fsub_rn(p[1], c[1]);
  const float dz = __fsub_rn(p[2], c[2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 <= r2;
}

// First activation relu(A[j] - B[k]); both inputs already rounded to the
// compute dtype, the difference rounded again.
template <bool kBf16>
__device__ __forceinline__ float first_act(float a, float b) {
  return fmaxf(rnd<kBf16>(a - b), 0.f);
}

// acc[p] = sum_i x[p * stride + i] * w[i * dout + o] for kPairs pairs
// (edge_tail.cuh):
// i ascending, one fmaf per term, x read four lanes at a time (stride and
// x 16-byte aligned).
template <int kPairs>
__device__ __forceinline__ void dense_column(const float* x, int stride,
                                             const float* __restrict__ w,
                                             int din, int dout, int o,
                                             float (&acc)[kPairs]) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
  int i = 0;
  for (; i + 4 <= din; i += 4) {
    const float w0 = __ldg(&w[(size_t)(i + 0) * dout + o]);
    const float w1 = __ldg(&w[(size_t)(i + 1) * dout + o]);
    const float w2 = __ldg(&w[(size_t)(i + 2) * dout + o]);
    const float w3 = __ldg(&w[(size_t)(i + 3) * dout + o]);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const float4 xv = *reinterpret_cast<const float4*>(&x[p * stride + i]);
      acc[p] = fmaf(xv.x, w0, acc[p]);
      acc[p] = fmaf(xv.y, w1, acc[p]);
      acc[p] = fmaf(xv.z, w2, acc[p]);
      acc[p] = fmaf(xv.w, w3, acc[p]);
    }
  }
  for (; i < din; ++i) {
    const float wi = __ldg(&w[(size_t)i * dout + o]);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      acc[p] = fmaf(x[p * stride + i], wi, acc[p]);
    }
  }
}

// Layer epilogues: bias in f32 and ReLU; hidden outputs are rounded to
// the compute dtype, the last layer's are not.
template <bool kBf16>
__device__ __forceinline__ float hidden_out(float acc, float bias) {
  return rnd<kBf16>(fmaxf(acc + bias, 0.f));
}

__device__ __forceinline__ float last_out(float acc, float bias) {
  return fmaxf(acc + bias, 0.f);
}

}  // namespace slab

// ---------------------------------------------------------------------------
// The chunked chain of the slab kernels, shared by
//   slab_edge_max.cu      (K1 forward: chain + per-center max)
//   slab_edge_max_bwd.cu  (K2 backward: recompute + winners + backward)
//
// Both kernels run over the same pair list: every in-radius (center k,
// source row j) pair, grouped by center (CSR by k), cut into chunks of
// kChunk pairs.  A persistent CTA walks the chunks blockIdx.x, +gridDim.x,
// ... so every CTA gets the same number of pairs whatever the skew of the
// centers; the grid is sized to the SMs.  The last layer's output columns
// are split into gridDim.y slices when its weights do not fit in shared
// memory beside the activations (max is independent per channel).
//
// chain_kernel runs the whole chain of one chunk:
//   x0 = relu(A[j] - B[k])                  (rounded to the compute dtype)
//   x_{l+1} = rnd(relu(x_l W_l + b_l))      hidden layers, bias in f32
//   y = relu(x_{L-1} W_{L-1} + b_{L-1})     last layer, not rounded
// with every weight staged once per CTA in shared memory:
//   bf16 (serving): tensor cores, mma.sync m16n8k16 with bf16 operands
//         (exactly the rounded activations and weights), f32 accumulation;
//   f32 (training): register-tiled fmaf on the CUDA cores, k ascending.
//         Split TF32 (3xTF32) on tensor cores was tried first: its
//         products carry ~1e-6 relative error against ~1e-7 for fmaf, and
//         near-tied max winners then flipped against the plain version
//         (gemm keeps that route for K2's lower-layer backward, where no
//         winner is decided).
// Each output element is computed from its own row and column alone, in
// a fixed k order, so a pair's values do not depend on its chunk, its
// tile row or the column slice: K2's recompute equals K1's forward bit
// for bit, and K2 finds the max winners by exact equality.

namespace slab_mma {

using namespace slab;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // pairs per chunk: four m16 tiles
constexpr int kGather = 16;  // table loads in flight per thread (x0 build)
constexpr size_t kMaxSmem = 232448;  // Hopper: 227 KB per block

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// k step of one MMA and the padded depth of a product over d inputs
__host__ __device__ inline int k_step(bool bf16) { return bf16 ? 16 : 8; }
__host__ __device__ inline int k_pad(int d, bool bf16) {
  return round_up(d, k_step(bf16));
}
// Row stride (elements) of a shared-memory operand of depth d: the
// fragment loads of a warp (8 rows x 4 words) hit 32 distinct banks when
// the stride in 32-bit words is 4 mod 32.
__host__ __device__ inline int row_stride(int d, bool bf16) {
  return bf16 ? round_up(k_pad(d, true), 64) + 8
              : round_up(k_pad(d, false), 32) + 4;
}

template <bool kBf16>
struct Elem;
template <>
struct Elem<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T from(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float to(T v) {
    return __bfloat162float(v);
  }
};
template <>
struct Elem<false> {
  using T = float;
  static __device__ __forceinline__ T from(float v) { return v; }
  static __device__ __forceinline__ float to(T v) { return v; }
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[m_rows, n] = A[m_rows, kpad] * B[kpad, n], with A row-major (stride
// sa) and B given as its transpose Bt[n, kpad] (stride sb), both in
// shared memory; depth padding is zero in both.  m_rows is a multiple of
// 32 and Bt has round_up(n, 32) rows.  Work items of 32 x 16 go to the
// warps round robin, so every output element has one fixed owning
// thread; epi(row, col, value) is called once per element with col < n
// (every row of the item, padding rows included).  Three routes:
//   kBf16:            mma.sync m16n8k16 bf16, f32 accumulation;
//   f32, kTf32:       mma.sync m16n8k8 split TF32 (3xTF32); each k step's
//                     three products go to a zeroed fragment that is then
//                     added to the sum in f32 (round to nearest);
//   f32, not kTf32:   CUDA-core fmaf, k ascending, one fmaf per term (4 x
//                     4 outputs a thread, operands read as float4).
// Every route computes an element from its own row and column alone, in
// a fixed k order.
template <bool kBf16, bool kTf32, class Epi>
__device__ __forceinline__ void gemm(const typename Elem<kBf16>::T* A, int sa,
                                     int m_rows,
                                     const typename Elem<kBf16>::T* Bt, int sb,
                                     int n, int kpad, Epi&& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // items of 32 rows x 16 columns: enough of them that a narrow output
  // still busies every warp
  constexpr int kItemCols = 16;
  constexpr int kNt = kItemCols / 8;  // n8 tiles of an item (MMA routes)
  const int mb_n = m_rows / 32, nb_n = (n + kItemCols - 1) / kItemCols;
  const int n8 = round_up(n, 8);
  for (int item = warp; item < mb_n * nb_n; item += kWarps) {
    const int r0 = (item % mb_n) * 32, c0 = (item / mb_n) * kItemCols;
    if constexpr (!kBf16 && !kTf32) {
      // rows r0 + g + 8 i, columns c0 + t + 4 j
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < kpad; k0 += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = *reinterpret_cast<const float4*>(
              A + (size_t)(r0 + g + 8 * i) * sa + k0);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[j] = *reinterpret_cast<const float4*>(
              Bt + (size_t)(c0 + t + 4 * j) * sb + k0);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + t + 4 * j;
          if (col < n) epi(r0 + g + 8 * i, col, acc[i][j]);
        }
      continue;
    } else {
      float acc[2][kNt][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      if constexpr (kBf16) {
        for (int k0 = 0; k0 < kpad; k0 += 16) {
          uint32_t a[2][4], b[kNt][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const __nv_bfloat16* p =
                A + (size_t)(r0 + mt * 16 + g) * sa + k0 + 2 * t;
            a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
            a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * sa);
            a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
            a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * sa + 8);
          }
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            const __nv_bfloat16* p =
                Bt + (size_t)(c0 + nt * 8 + g) * sb + k0 + 2 * t;
            b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
            b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt)
              if (c0 + nt * 8 < n8) mma_bf16(acc[mt][nt], a[mt], b[nt]);
        }
      } else {
        for (int k0 = 0; k0 < kpad; k0 += 8) {
          uint32_t ah[2][4], al[2][4], bh[kNt][2], bl[kNt][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* p = A + (size_t)(r0 + mt * 16 + g) * sa + k0 + t;
            const float v[4] = {p[0], p[8 * sa], p[4], p[8 * sa + 4]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[mt][e] = tf32(v[e]);
              al[mt][e] = tf32(v[e] - __uint_as_float(ah[mt][e]));
            }
          }
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            const float* p = Bt + (size_t)(c0 + nt * 8 + g) * sb + k0 + t;
            const float v[2] = {p[0], p[4]};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              bh[nt][e] = tf32(v[e]);
              bl[nt][e] = tf32(v[e] - __uint_as_float(bh[nt][e]));
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt)
              if (c0 + nt * 8 < n8) {
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma_tf32(part, al[mt], bh[nt]);
                mma_tf32(part, ah[mt], bl[nt]);
                mma_tf32(part, ah[mt], bh[nt]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
              }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + nt * 8 + 2 * t + (e & 1);
            if (col < n) {
              epi(r0 + mt * 16 + g + (e >> 1) * 8, col, acc[mt][nt][e]);
            }
          }
    }
  }
}

// Shared-memory layout of chain_kernel, in bytes; every section starts
// 16-byte aligned.  act[l] (l < max(L, 1)): the input of layer l for the
// chunk's rows; wt[l] (l < L - 1): hidden layer l's weight as [dout, din];
// wt[L - 1]: the last layer's slice of ns output columns; y: the last
// layer's output slice (forward only); pk, pj: the chunk's pairs.
struct ChainLayout {
  int act[kMaxLayers], act_stride[kMaxLayers];
  int wt[kMaxLayers], wt_stride[kMaxLayers];
  int y, y_stride, pk, pj, total;
  __host__ __device__ ChainLayout(const Chain& c, int h, int ns, bool bf16,
                                  bool with_y) {
    const int esz = bf16 ? 2 : 4;
    int off = 0;
    const int n_act = c.n_layers > 0 ? c.n_layers : 1;
    for (int l = 0; l < n_act; ++l) {
      const int dim = l == 0 ? h : c.dout[l - 1];
      act[l] = off;
      act_stride[l] = row_stride(dim, bf16);
      off += round_up(kChunk * act_stride[l] * esz, 16);
    }
    for (int l = 0; l < c.n_layers; ++l) {
      const int rows = round_up(l + 1 < c.n_layers ? c.dout[l] : ns, 32);
      wt[l] = off;
      wt_stride[l] = row_stride(c.din[l], bf16);
      off += round_up(rows * wt_stride[l] * esz, 16);
    }
    y = off;
    y_stride = round_up(ns, 8);
    if (with_y) off += kChunk * y_stride * 4;
    pk = off;
    pj = pk + kChunk * 4;
    total = pj + kChunk * 4;
  }
};

struct ChainArgs {
  const float* table_a;   // [P, h] source table A (rounded here)
  const float* table_b;   // [K, h] center table B (rounded here)
  const float* weights_t; // flat chain, each weight as [dout, din]
  const int* pair_k;      // [n_pairs] center of each pair (CSR by center)
  const int* pair_j;      // [n_pairs] source row of each pair
  int n_pairs, h, h_out, ns;
  Chain chain;
  float* out;             // forward: [K, h_out], zeroed before the launch
  const float* y_max;     // backward: the forward's output [K, h_out]
  const float* g;         // backward: its cotangent [K, h_out]
  float* dz_last;         // backward: [n_pairs, h_out] winner cotangent
  float* acts;            // backward: layer inputs, per pair, f32
  long long act_off[kMaxLayers];  // offset of act[l] in acts ([n, dim_l])
};

// kTrain == false: K1 forward, max-reduced into out with atomicMax on the
// float bits (every value is >= 0, so the bits order like ints; the sign
// of a -0.0 is cleared).  Max is exact, so out is the same on every run.
// kTrain == true: K2's recompute; writes every layer's input rows to acts
// (slice 0) and dz_last[p, c] = g[k, c] where the pair's y equals the
// forward's max and y > 0, else 0.
template <bool kBf16, bool kTrain>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const ChainArgs args) {
  using E = Elem<kBf16>;
  using T = typename E::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chain& ch = args.chain;
  const int L = ch.n_layers;
  const int h = args.h, h_out = args.h_out;
  const ChainLayout lay(ch, h, args.ns, kBf16, !kTrain);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * args.ns;  // first output column of the slice
  const int ns = min(args.ns, h_out - c0);
  int* pk = reinterpret_cast<int*>(smem + lay.pk);
  int* pj = reinterpret_cast<int*>(smem + lay.pj);
  float* y = reinterpret_cast<float*>(smem + lay.y);
  auto act = [&](int l) { return reinterpret_cast<T*>(smem + lay.act[l]); };
  auto wt = [&](int l) { return reinterpret_cast<T*>(smem + lay.wt[l]); };

  // zero every section (padding stays zero), then stage the weights once
  for (int i = tid; i < lay.pk / 4; i += kThreads) {
    reinterpret_cast<float*>(smem)[i] = 0.f;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const int din = ch.din[l], dout = ch.dout[l];
    const bool last = l + 1 == L;
    const int rows = last ? ns : dout, first = last ? c0 : 0;
    const float* src = args.weights_t + ch.w_off[l];
    T* dst = wt(l);
    const int st = lay.wt_stride[l];
    for (int idx = tid; idx < rows * din; idx += kThreads) {
      const int n = idx / din, k = idx - n * din;
      dst[n * st + k] = E::from(src[(size_t)(first + n) * din + k]);
    }
  }
  __syncthreads();

  const int n_chunks = (args.n_pairs + kChunk - 1) / kChunk;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int p0 = chunk * kChunk;
    const int np = min(kChunk, args.n_pairs - p0);
    if (tid < kChunk) {
      pk[tid] = tid < np ? args.pair_k[p0 + tid] : 0;
      pj[tid] = tid < np ? args.pair_j[p0 + tid] : 0;
    }
    __syncthreads();
    {  // x0 = relu(A[j] - B[k]); rows past the list are zero.  Each
       // thread issues kGather row loads before it uses them.
      T* x0 = act(0);
      const int s0 = lay.act_stride[0];
      for (int base = tid; base < kChunk * h; base += kThreads * kGather) {
        float a[kGather], b[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int idx = base + u * kThreads;
          const int p = idx / h, i = idx - p * h;
          a[u] = b[u] = 0.f;
          if (idx < kChunk * h && p < np) {
            a[u] = __ldg(&args.table_a[(size_t)pj[p] * h + i]);
            b[u] = __ldg(&args.table_b[(size_t)pk[p] * h + i]);
          }
        }
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int idx = base + u * kThreads;
          const int p = idx / h, i = idx - p * h;
          if (idx < kChunk * h) {
            x0[p * s0 + i] = E::from(
                p < np ? first_act<kBf16>(rnd<kBf16>(a[u]), rnd<kBf16>(b[u]))
                       : 0.f);
          }
        }
      }
    }
    __syncthreads();
    for (int l = 0; l + 1 < L; ++l) {
      const float* bias = args.weights_t + ch.b_off[l];
      T* xo = act(l + 1);
      const int so = lay.act_stride[l + 1];
      gemm<kBf16, false>(act(l), lay.act_stride[l], kChunk, wt(l), lay.wt_stride[l],
                  ch.dout[l], k_pad(ch.din[l], kBf16),
                  [&](int r, int c, float v) {
                    xo[r * so + c] = E::from(hidden_out<kBf16>(v, bias[c]));
                  });
      __syncthreads();
    }

    if constexpr (!kTrain) {
      if (L > 0) {
        const float* bias = args.weights_t + ch.b_off[L - 1] + c0;
        const int ys = lay.y_stride;
        gemm<kBf16, false>(act(L - 1), lay.act_stride[L - 1], kChunk, wt(L - 1),
                    lay.wt_stride[L - 1], ns, k_pad(ch.din[L - 1], kBf16),
                    [&](int r, int c, float v) {
                      y[r * ys + c] = last_out(v, bias[c]);
                    });
      } else {
        const T* x0 = act(0);
        for (int idx = tid; idx < kChunk * ns; idx += kThreads) {
          const int p = idx / ns, c = idx - p * ns;
          y[p * lay.y_stride + c] = E::to(x0[p * lay.act_stride[0] + c]);
        }
      }
      __syncthreads();
      // segmented max over each center's run of rows, one atomic per run
      int* out_bits = reinterpret_cast<int*>(args.out);
      for (int c = tid; c < ns; c += kThreads) {
        int k = pk[0];
        float m = y[c];
        for (int p = 1; p <= np; ++p) {
          const int kp = p < np ? pk[p] : -1;
          if (kp != k) {
            atomicMax(&out_bits[(size_t)k * h_out + c0 + c],
                      __float_as_int(m) & 0x7fffffff);
            if (p < np) {
              k = kp;
              m = y[p * lay.y_stride + c];
            }
          } else {
            m = fmaxf(m, y[p * lay.y_stride + c]);
          }
        }
      }
    } else {
      auto winner = [&](int r, int c, float v) {
        if (r < np) {
          const size_t kc = (size_t)pk[r] * h_out + c0 + c;
          args.dz_last[(size_t)(p0 + r) * h_out + c0 + c] =
              (v > 0.f && v == args.y_max[kc]) ? args.g[kc] : 0.f;
        }
      };
      if (L > 0) {
        const float* bias = args.weights_t + ch.b_off[L - 1] + c0;
        gemm<kBf16, false>(act(L - 1), lay.act_stride[L - 1], kChunk, wt(L - 1),
                    lay.wt_stride[L - 1], ns, k_pad(ch.din[L - 1], kBf16),
                    [&](int r, int c, float v) {
                      winner(r, c, last_out(v, bias[c]));
                    });
        if (blockIdx.y == 0) {
          for (int l = 0; l < L; ++l) {
            const int dim = l == 0 ? h : ch.dout[l - 1];
            const T* x = act(l);
            const int sx = lay.act_stride[l];
            float* dst = args.acts + args.act_off[l] + (size_t)p0 * dim;
            for (int idx = tid; idx < np * dim; idx += kThreads) {
              const int p = idx / dim, i = idx - p * dim;
              dst[idx] = E::to(x[p * sx + i]);
            }
          }
        }
      } else {
        const T* x0 = act(0);
        for (int idx = tid; idx < kChunk * ns; idx += kThreads) {
          const int p = idx / ns, c = idx - p * ns;
          winner(p, c, E::to(x0[p * lay.act_stride[0] + c]));
        }
      }
    }
    __syncthreads();
  }
}

// Picks the fewest output-column slices of the last layer whose layout
// fits in shared memory; returns the slice width (0 if none fits).
inline int slice_width(const Chain& c, int h, int h_out, bool bf16,
                       bool with_y, size_t* smem) {
  for (int s = 1; s <= h_out; ++s) {
    const int ns = round_up((h_out + s - 1) / s, 8);
    const ChainLayout lay(c, h, ns, bf16, with_y);
    if ((size_t)lay.total <= kMaxSmem) {
      *smem = lay.total;
      return ns;
    }
  }
  return 0;
}

// Launches chain_kernel over every chunk: gridDim.y = output slices,
// gridDim.x = persistent CTAs per slice, so that all slices together
// fill the SMs once.
template <bool kBf16, bool kTrain>
cudaError_t launch_chain(const ChainArgs& base, int device,
                         cudaStream_t stream) {
  ChainArgs args = base;
  size_t smem = 0;
  args.ns = slice_width(args.chain, args.h, args.h_out, kBf16, !kTrain,
                        &smem);
  if (args.ns == 0) return cudaErrorInvalidValue;
  const int n_chunks = (args.n_pairs + kChunk - 1) / kChunk;
  if (n_chunks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<kBf16, kTrain>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chain_kernel<kBf16, kTrain>, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int slices = (args.h_out + args.ns - 1) / args.ns;
  const int ctas = (sms * (per_sm > 0 ? per_sm : 1) + slices - 1) / slices;
  const dim3 grid(ctas < n_chunks ? ctas : n_chunks, slices);
  chain_kernel<kBf16, kTrain><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

inline Chain read_chain(const void* layer_table, int n_layers) {
  Chain chain;
  chain.n_layers = n_layers;
  const int* tbl = static_cast<const int*>(layer_table);
  for (int l = 0; l < n_layers; ++l) {
    chain.w_off[l] = tbl[4 * l + 0];
    chain.b_off[l] = tbl[4 * l + 1];
    chain.din[l] = tbl[4 * l + 2];
    chain.dout[l] = tbl[4 * l + 3];
  }
  return chain;
}

}  // namespace slab_mma
