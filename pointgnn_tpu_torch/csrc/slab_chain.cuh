// Chain arithmetic of the hand-written kernels:
//   slab_edge_max.cu      (K1 forward: exact radius search + edge MLP + max)
//   slab_edge_max_bwd.cu  (K2 backward: recompute + route to the max winners)
//   edge_tail.cuh         (K3/K4: the edge-list tail over its valid slots)
//
// The backward finds each channel's winners by exact equality with the
// forward's output, so it must recompute every in-radius pair's chain bit
// for bit as the forward did.  Both slab kernels therefore take the
// distance test, the first activation, the layer epilogues and the
// chunked chain (slab_mma::chain_kernel, below) from this one header; the
// edge-list tail runs the same chain_kernel over its own pair list.

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

// Layer epilogues: bias in f32 and ReLU; hidden outputs are rounded to
// the compute dtype.  The slab kernels leave the last layer's unrounded,
// the edge-list tail rounds it too (the TPU kernels' rules).
template <bool kBf16>
__device__ __forceinline__ float hidden_out(float acc, float bias) {
  return rnd<kBf16>(fmaxf(acc + bias, 0.f));
}

__device__ __forceinline__ float last_out(float acc, float bias) {
  return fmaxf(acc + bias, 0.f);
}

// Float <-> int keys that order like the floats (negative values too), so
// an integer atomicMax takes an exact float max.  -0.0 orders below +0.0;
// INT_MIN is the key of no float (a negative NaN) and marks "no value".
__device__ __forceinline__ int ordered_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_ordered_key(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

}  // namespace slab

// ---------------------------------------------------------------------------
// The chunked chain, shared by
//   slab_edge_max.cu      (K1 forward: chain + per-center max)
//   slab_edge_max_bwd.cu  (K2 backward: recompute + winners + backward)
//   edge_tail.cuh         (K3/K4 forward: chain + per-center max)
//
// The slab kernels run over the same pair list: every in-radius (center
// k, source row j) pair, grouped by center (CSR by k); the edge-list tail
// over its valid slots as (center, row) pairs in center order.  Either
// list is cut into chunks of kChunk pairs.  A persistent CTA walks the
// chunks blockIdx.x, +gridDim.x, ... so every CTA gets the same number of
// pairs whatever the skew of the centers; the grid is sized to the SMs.
// Each chunk's pairs are loaded while the chunk before runs, and its
// table rows 4 values a load where the rows allow.  The last layer's
// output columns are split into gridDim.y slices when its weights do not
// fit in shared memory beside the activations (max is independent per
// channel).
//
// chain_kernel runs the whole chain of one chunk:
//   x0 = act(rnd(A[j] - B[k]))              act = ReLU (slab) or, for the
//                                           edge tail, ReLU or identity
//   x_{l+1} = rnd(relu(x_l W_l + b_l))      hidden layers, bias in f32
//   y = relu(x_{L-1} W_{L-1} + b_{L-1})     last layer: not rounded (slab),
//                                           rounded (edge tail)
// with every weight staged once per CTA in shared memory, on one of three
// product routes:
//   bf16, tensor cores (K1 serving): mma.sync m16n8k16 with bf16 operands
//         (exactly the rounded activations and weights), f32 accumulation;
//   bf16, CUDA cores (K3/K4): the same operands, bf16 weights in shared
//         memory widened to f32 in registers, register-tiled fmaf, k
//         ascending -- each sum is then the plain version's f32 product
//         bit for bit, so no bf16 rounding of a hidden or last-layer
//         output can flip against it (tensor-core sums moved tiny maxima
//         by more than the edge tail's 2-ulp gate on chip_smoke.py phase
//         8's inputs);
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
constexpr int kGather4 = 10;  // the same, 4 values a load
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

// The bf16 rule on the CUDA cores: C[kChunk, n] = A[kChunk, kpad] *
// B[kpad, n] with A f32 holding bf16 values (row-major, stride sa) and B
// given as its transpose Bt[n, kpad] in bf16 (stride sb); depth padding
// is zero in both.  Every element is one fmaf chain from 0, k ascending:
// the plain version's f32 product bit for bit.  Thread items of 8 rows
// (g, g + 8, ..., g + 56, so a warp's A loads read 8 consecutive rows, one
// wavefront) x kTn columns go to the threads round robin; a column past n
// reads a clamped row of Bt and is dropped.  Per 4 k a thread issues 8
// float4 loads, kTn 8-byte loads and 4 kTn widenings for 32 kTn fmaf.
template <class Epi>
__device__ __forceinline__ void gemm_bf16w(const float* A, int sa,
                                           const __nv_bfloat16* Bt, int sb,
                                           int n, int kpad, Epi&& epi) {
  constexpr int kTm = kChunk / 8;
  constexpr int kTn = 5;  // 4 and 6 measured slower (chip_smoke.py inputs)
  const int n_items = 8 * ((n + kTn - 1) / kTn);
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    const int g = item & 7, c0 = (item >> 3) * kTn;
    const float* a = A + (size_t)g * sa;
    const __nv_bfloat16* b[kTn];
#pragma unroll
    for (int j = 0; j < kTn; ++j) b[j] = Bt + (size_t)min(c0 + j, n - 1) * sb;
    float acc[kTm][kTn];
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < kpad; k0 += 4) {
      float w[kTn][4];
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        // bf16 k at the low half of each word: f32 bits = bf16 bits << 16
        const uint2 v = *reinterpret_cast<const uint2*>(b[j] + k0);
        w[j][0] = __uint_as_float(v.x << 16);
        w[j][1] = __uint_as_float(v.x & 0xffff0000u);
        w[j][2] = __uint_as_float(v.y << 16);
        w[j][3] = __uint_as_float(v.y & 0xffff0000u);
      }
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(a + (size_t)(8 * i) * sa + k0);
#pragma unroll
        for (int j = 0; j < kTn; ++j) {
          acc[i][j] = fmaf(x.x, w[j][0], acc[i][j]);
          acc[i][j] = fmaf(x.y, w[j][1], acc[i][j]);
          acc[i][j] = fmaf(x.z, w[j][2], acc[i][j]);
          acc[i][j] = fmaf(x.w, w[j][3], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        if (c0 + j < n) epi(g + 8 * i, c0 + j, acc[i][j]);
      }
  }
}

// The product of one layer on the route of <kBf16, kMma> (see above).
template <bool kBf16, bool kMma, class TA, class TW, class Epi>
__device__ __forceinline__ void layer_product(const TA* A, int sa,
                                              const TW* Bt, int sb, int n,
                                              int kpad, Epi&& epi) {
  if constexpr (kMma) {
    gemm<true, false>(A, sa, kChunk, Bt, sb, n, kpad, epi);
  } else if constexpr (kBf16) {
    gemm_bf16w(A, sa, Bt, sb, n, kpad, epi);
  } else {
    gemm<false, false>(A, sa, kChunk, Bt, sb, n, kpad, epi);
  }
}

// Shared-memory layout of chain_kernel, in bytes; every section starts
// 16-byte aligned.  act[l] (l < max(L, 1)): the input of layer l for the
// chunk's rows; wt[l] (l < L - 1): hidden layer l's weight as [dout, din];
// wt[L - 1]: the last layer's slice of ns output columns; y: the last
// layer's output slice (forward only); pk, pj: the chunk's pairs; runs:
// the first pair of each center's run in the chunk, then np, then the run
// count (forward only).
// Activations are bf16 on the tensor-core route (act_bf16), weights bf16
// on both bf16 routes (w_bf16); depth is padded for the route's k step.
// y holds y_bytes per value: 4 (f32), 2 (the edge tail's bf16 outputs,
// exact) or 0 (no y: the backward).
struct ChainLayout {
  int act[kMaxLayers], act_stride[kMaxLayers];
  int wt[kMaxLayers], wt_stride[kMaxLayers];
  int y, y_stride, pk, pj, runs, total;
  __host__ __device__ ChainLayout(const Chain& c, int h, int ns,
                                  bool act_bf16, bool w_bf16, int y_bytes) {
    int off = 0;
    const int n_act = c.n_layers > 0 ? c.n_layers : 1;
    for (int l = 0; l < n_act; ++l) {
      const int dim = l == 0 ? h : c.dout[l - 1];
      act[l] = off;
      act_stride[l] = row_stride(dim, act_bf16);
      off += round_up(kChunk * act_stride[l] * (act_bf16 ? 2 : 4), 16);
    }
    for (int l = 0; l < c.n_layers; ++l) {
      const int rows = round_up(l + 1 < c.n_layers ? c.dout[l] : ns, 32);
      wt[l] = off;
      wt_stride[l] = row_stride(c.din[l], act_bf16);
      off += round_up(rows * wt_stride[l] * (w_bf16 ? 2 : 4), 16);
    }
    y = off;
    y_stride = round_up(ns, 8);
    off += round_up(kChunk * y_stride * y_bytes, 16);
    pk = off;
    pj = pk + kChunk * 4;
    runs = pj + kChunk * 4;
    total = runs + (kChunk + 2) * 4;
  }
};

struct ChainArgs {
  const void* table_a;    // [P, h] source table A (f32, rounded here;
                          // the edge tail's in the compute dtype)
  const void* table_b;    // [K, h] center table B, the same type
  const float* weights_t; // flat chain, each weight as [dout, din]
  const int* pair_k;      // [n_pairs] center of each pair (CSR by center)
  const int* pair_j;      // [n_pairs] source row of each pair
  int n_pairs, h, h_out, ns;
  // where set: the pair count, read on the card (n_pairs is then the
  // list's capacity), so no host sync sits between list and chain
  const int* n_pairs_dev;
  int identity_first;     // edge tail: no ReLU on x0 (apply_act_first off)
  int vec4;               // tables read 4 values a load (set by launch)
  Chain chain;
  float* out;             // forward: [K, h_out], set to the ordered_key of
                          // its start value (K1: zeros) before the launch
  const float* y_max;     // backward: the forward's output [K, h_out]
  const float* g;         // backward: its cotangent [K, h_out]
  float* dz_last;         // backward: [n_pairs, h_out] winner cotangent
  float* acts;            // backward: layer inputs, per pair, f32
  long long act_off[kMaxLayers];  // offset of act[l] in acts ([n, dim_l])
};

__device__ __forceinline__ float load_in(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_in(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// 4 table values a load, kept raw (bf16: 2 registers) until widened
template <class TIn>
struct Raw4 {
  using T = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using T = uint2;
};
__device__ __forceinline__ float4 load_raw4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load_raw4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// kBf16: the compute dtype's rounding points (bf16 or none).  kTail: the
// edge tail's rules (K3/K4): the tables are read in the compute dtype, the
// first ReLU is optional (identity_first), the last layer is rounded like
// the hidden ones and the products run on the CUDA cores; otherwise (K1,
// K2) the tables are f32 rounded here, the first ReLU always applies, the
// last layer is not rounded and bf16 products run on the tensor cores.
// kTrain == false: forward, max-reduced into out with atomicMax on
// ordered_key (an exact max, so out is the same on every run); out holds
// the keys of its initial values (K1: zeros, which are also their keys
// since every K1 value is >= 0).
// kTrain == true: K2's recompute; writes every layer's input rows to acts
// (slice 0) and dz_last[p, c] = g[k, c] where the pair's y equals the
// forward's max and y > 0, else 0.
template <bool kBf16, bool kTrain, bool kTail = false>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const ChainArgs args) {
  static_assert(!(kTrain && kTail), "the edge tail has no backward");
  constexpr bool kMma = kBf16 && !kTail;
  using TIn = typename Elem<kBf16 && kTail>::T;
  using E = Elem<kMma>;            // activations
  using T = typename E::T;
  using EW = Elem<kBf16>;          // weights
  using TW = typename EW::T;
  using EY = Elem<kBf16 && kTail>;  // the last layer's outputs
  using TY = typename EY::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chain& ch = args.chain;
  const int L = ch.n_layers;
  const int h = args.h, h_out = args.h_out;
  const ChainLayout lay(ch, h, args.ns, kMma, kBf16,
                        kTrain ? 0 : (int)sizeof(TY));
  const TIn* table_a = static_cast<const TIn*>(args.table_a);
  const TIn* table_b = static_cast<const TIn*>(args.table_b);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * args.ns;  // first output column of the slice
  const int ns = min(args.ns, h_out - c0);
  int* pk = reinterpret_cast<int*>(smem + lay.pk);
  int* pj = reinterpret_cast<int*>(smem + lay.pj);
  int* runs = reinterpret_cast<int*>(smem + lay.runs);
  TY* y = reinterpret_cast<TY*>(smem + lay.y);
  auto act = [&](int l) { return reinterpret_cast<T*>(smem + lay.act[l]); };
  auto wt = [&](int l) { return reinterpret_cast<TW*>(smem + lay.wt[l]); };

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
    TW* dst = wt(l);
    const int st = lay.wt_stride[l];
    for (int idx = tid; idx < rows * din; idx += kThreads) {
      const int n = idx / din, k = idx - n * din;
      dst[n * st + k] = EW::from(src[(size_t)(first + n) * din + k]);
    }
  }
  __syncthreads();

  const int n_pairs = args.n_pairs_dev
                          ? min(*args.n_pairs_dev, args.n_pairs)
                          : args.n_pairs;
  const int n_chunks = (n_pairs + kChunk - 1) / kChunk;
  // each chunk's pairs are loaded one chunk ahead (threads < kChunk), so
  // their latency hides behind the chunk before
  int next_k = 0, next_j = 0;
  auto load_pair = [&](int chunk) {
    const int p = chunk * kChunk + tid;
    const bool ok = chunk < n_chunks && p < n_pairs;
    next_k = ok ? args.pair_k[p] : 0;
    next_j = ok ? args.pair_j[p] : 0;
  };
  if (tid < kChunk) load_pair(blockIdx.x);
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int p0 = chunk * kChunk;
    const int np = min(kChunk, n_pairs - p0);
    if (tid < kChunk) {
      pk[tid] = next_k;
      pj[tid] = next_j;
      load_pair(chunk + gridDim.x);
    }
    __syncthreads();
    if (!kTrain && tid < 32) {  // the centers' runs (pairs are by center)
      int n_runs = 0;
      for (int q = 0; q < kChunk; q += 32) {
        const int p = q + tid;
        const bool start = p < np && (p == 0 || pk[p] != pk[p - 1]);
        const unsigned ballot = __ballot_sync(0xffffffffu, start);
        if (start) runs[n_runs + __popc(ballot & ((1u << tid) - 1u))] = p;
        n_runs += __popc(ballot);
      }
      if (tid == 0) {
        runs[n_runs] = np;
        runs[kChunk + 1] = n_runs;
      }
    }
    {  // x0 = act(rnd(A[j] - B[k])); rows past the list are zero.  Each
       // thread issues its row loads (4 values each where the tables
       // allow) before it uses them.
      T* x0 = act(0);
      const int s0 = lay.act_stride[0];
      auto rule = [&](float a, float b) {
        float v = rnd<kBf16>(rnd<kBf16>(a) - rnd<kBf16>(b));
        return args.identity_first ? v : fmaxf(v, 0.f);
      };
      if (args.vec4) {
        const int h4 = h >> 2, n4 = kChunk * h4;
        for (int base = tid; base < n4; base += kThreads * kGather4) {
          typename Raw4<TIn>::T a[kGather4], b[kGather4];
#pragma unroll
          for (int u = 0; u < kGather4; ++u) {
            const int idx = base + u * kThreads;
            const int p = idx / h4, i = (idx - p * h4) << 2;
            if (idx < n4 && p < np) {
              a[u] = load_raw4(&table_a[(size_t)pj[p] * h + i]);
              b[u] = load_raw4(&table_b[(size_t)pk[p] * h + i]);
            }
          }
#pragma unroll
          for (int u = 0; u < kGather4; ++u) {
            const int idx = base + u * kThreads;
            const int p = idx / h4, i = (idx - p * h4) << 2;
            if (idx < n4) {
              float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
              if (p < np) {
                const float4 av = widen4(a[u]), bv = widen4(b[u]);
                v = make_float4(rule(av.x, bv.x), rule(av.y, bv.y),
                                rule(av.z, bv.z), rule(av.w, bv.w));
              }
              store4(&x0[p * s0 + i], v);
            }
          }
        }
      } else {
        for (int base = tid; base < kChunk * h; base += kThreads * kGather) {
          float a[kGather], b[kGather];
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            const int idx = base + u * kThreads;
            const int p = idx / h, i = idx - p * h;
            a[u] = b[u] = 0.f;
            if (idx < kChunk * h && p < np) {
              a[u] = load_in(&table_a[(size_t)pj[p] * h + i]);
              b[u] = load_in(&table_b[(size_t)pk[p] * h + i]);
            }
          }
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            const int idx = base + u * kThreads;
            const int p = idx / h, i = idx - p * h;
            if (idx < kChunk * h) {
              x0[p * s0 + i] = E::from(p < np ? rule(a[u], b[u]) : 0.f);
            }
          }
        }
      }
    }
    __syncthreads();
    for (int l = 0; l + 1 < L; ++l) {
      const float* bias = args.weights_t + ch.b_off[l];
      T* xo = act(l + 1);
      const int so = lay.act_stride[l + 1];
      layer_product<kBf16, kMma>(act(l), lay.act_stride[l], wt(l),
                                 lay.wt_stride[l], ch.dout[l],
                                 k_pad(ch.din[l], kMma),
                                 [&](int r, int c, float v) {
                          xo[r * so + c] =
                              E::from(hidden_out<kBf16>(v, bias[c]));
                        });
      __syncthreads();
    }

    if constexpr (!kTrain) {
      if (L > 0) {
        const float* bias = args.weights_t + ch.b_off[L - 1] + c0;
        const int ys = lay.y_stride;
        layer_product<kBf16, kMma>(act(L - 1), lay.act_stride[L - 1],
                                   wt(L - 1), lay.wt_stride[L - 1], ns,
                                   k_pad(ch.din[L - 1], kMma),
                                   [&](int r, int c, float v) {
                                     y[r * ys + c] = EY::from(
                                         kTail ? hidden_out<kBf16>(v, bias[c])
                                               : last_out(v, bias[c]));
                                   });
      } else {
        const T* x0 = act(0);
        for (int idx = tid; idx < kChunk * ns; idx += kThreads) {
          const int p = idx / ns, c = idx - p * ns;
          y[p * lay.y_stride + c] =
              EY::from(E::to(x0[p * lay.act_stride[0] + c]));
        }
      }
      __syncthreads();
      // max over each center's run of rows, one atomic per run and column
      int* out_bits = reinterpret_cast<int*>(args.out);
      const int n_runs = runs[kChunk + 1];
      for (int task = tid; task < n_runs * ns; task += kThreads) {
        const int r = task / ns, c = task - r * ns;
        const int p1 = runs[r + 1];
        int p = runs[r];
        const int k = pk[p];
        float m = EY::to(y[p * lay.y_stride + c]);
        for (++p; p < p1; ++p) m = fmaxf(m, EY::to(y[p * lay.y_stride + c]));
        atomicMax(&out_bits[(size_t)k * h_out + c0 + c], ordered_key(m));
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
        layer_product<kBf16, kMma>(act(L - 1), lay.act_stride[L - 1],
                                   wt(L - 1), lay.wt_stride[L - 1], ns,
                                   k_pad(ch.din[L - 1], kMma),
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
inline int slice_width(const Chain& c, int h, int h_out, bool act_bf16,
                       bool w_bf16, int y_bytes, size_t* smem) {
  for (int s = 1; s <= h_out; ++s) {
    const int ns = round_up((h_out + s - 1) / s, 8);
    const ChainLayout lay(c, h, ns, act_bf16, w_bf16, y_bytes);
    if ((size_t)lay.total <= kMaxSmem) {
      *smem = lay.total;
      return ns;
    }
  }
  return 0;
}

// Launches chain_kernel over every chunk: gridDim.y = output slices,
// gridDim.x = persistent CTAs per slice, so that all slices together
// fill the SMs once (and no more CTAs than the list's capacity has
// chunks).
template <bool kBf16, bool kTrain, bool kTail = false>
cudaError_t launch_chain(const ChainArgs& base, int device,
                         cudaStream_t stream) {
  constexpr bool kMma = kBf16 && !kTail;
  const int y_bytes = kTrain ? 0 : (kBf16 && kTail ? 2 : 4);
  ChainArgs args = base;
  size_t smem = 0;
  args.ns = slice_width(args.chain, args.h, args.h_out, kMma, kBf16,
                        y_bytes, &smem);
  // 4 values a load where every row starts aligned for it
  const size_t align = 4 * (kBf16 && kTail ? 2 : 4);
  args.vec4 = args.h % 4 == 0 &&
              reinterpret_cast<uintptr_t>(args.table_a) % align == 0 &&
              reinterpret_cast<uintptr_t>(args.table_b) % align == 0;
  if (args.ns == 0) return cudaErrorInvalidValue;
  const int n_chunks = (args.n_pairs + kChunk - 1) / kChunk;
  if (n_chunks == 0) return cudaSuccess;
  auto* kernel = chain_kernel<kBf16, kTrain, kTail>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int slices = (args.h_out + args.ns - 1) / args.ns;
  const int ctas = (sms * (per_sm > 0 ? per_sm : 1) + slices - 1) / slices;
  const dim3 grid(ctas < n_chunks ? ctas : n_chunks, slices);
  kernel<<<grid, kThreads, smem, stream>>>(args);
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
