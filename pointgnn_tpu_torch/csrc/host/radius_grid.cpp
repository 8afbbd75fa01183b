// Grid-hash fixed-radius neighbor search of the host-built graph (the
// PyTorch port's copy of the JAX package's cpp/graphlib/radius_grid.cpp,
// its radius search only).
//
// Algorithm: CSR-by-sort spatial hashing.  Points are hashed into cubic
// cells with edge length = radius; the sorted (cell_key, point) layout
// gives per-cell ranges by binary search, so each center scans at most
// its 27 neighboring cells.  Neighbor capping uses per-center reservoir
// sampling (uniform without replacement), seeded deterministically per
// center so results are reproducible and thread-order independent.
//
// Exposed as a C ABI for ctypes (pointgnn_tpu_torch/postprocess/
// native.py).  Parallelized over centers in dynamic blocks of 64, as the
// JAX package's OpenMP loop is, on std::thread workers: the host
// compiler of the GPU machine links no OpenMP runtime.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// body(c) for every c in [0, n), blocks of `block` handed out in order
// to one worker per hardware thread (the calling thread is one of them).
template <class Body>
static void for_each_center(int64_t n, int64_t block, const Body& body) {
  const int64_t blocks = (n + block - 1) / block;
  const int64_t hw = std::max<int64_t>(1, std::thread::hardware_concurrency());
  const int64_t workers = std::min(hw, blocks);
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (int64_t b = next.fetch_add(1); b < blocks; b = next.fetch_add(1)) {
      const int64_t hi = std::min(n, (b + 1) * block);
      for (int64_t c = b * block; c < hi; ++c) body(c);
    }
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < workers; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
}

// splitmix64 — tiny deterministic per-center PRNG stream.
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

static inline uint64_t rand_below(uint64_t& s, uint64_t n) {
  // modulo bias is irrelevant at these magnitudes
  return splitmix64(s) % n;
}

struct Grid {
  std::vector<int64_t> sorted_keys;   // [n] cell key per point, sorted
  std::vector<int64_t> sorted_point;  // [n] original point index
  int64_t dims[3];
  double origin[3];
  double inv_cell;
};

static void build_grid(const float* pts, int64_t n, const float* centers,
                       int64_t m, double cell, Grid* g) {
  double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      double v = pts[i * 3 + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  for (int64_t i = 0; i < m; ++i)
    for (int d = 0; d < 3; ++d) {
      double v = centers[i * 3 + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  g->inv_cell = 1.0 / cell;
  for (int d = 0; d < 3; ++d) {
    g->origin[d] = lo[d];
    // +3 head-room: one for rounding, one so that center cells +-1 stay
    // inside the addressable range without wrap-around
    g->dims[d] = (int64_t)((hi[d] - lo[d]) * g->inv_cell) + 3;
  }
  g->sorted_keys.resize(n);
  g->sorted_point.resize(n);
  std::vector<std::pair<int64_t, int64_t>> kv(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = (int64_t)((pts[i * 3 + 0] - g->origin[0]) * g->inv_cell) + 1;
    int64_t cy = (int64_t)((pts[i * 3 + 1] - g->origin[1]) * g->inv_cell) + 1;
    int64_t cz = (int64_t)((pts[i * 3 + 2] - g->origin[2]) * g->inv_cell) + 1;
    kv[i] = {(cx * g->dims[1] + cy) * g->dims[2] + cz, i};
  }
  std::sort(kv.begin(), kv.end());
  for (int64_t i = 0; i < n; ++i) {
    g->sorted_keys[i] = kv[i].first;
    g->sorted_point[i] = kv[i].second;
  }
}

}  // namespace

extern "C" {

// Count + emit (point, center) pairs with |p - c| <= radius.
//
// Two-phase contract driven by *out_count:
//   pass 1 (out_src == nullptr): writes per-center counts into
//     out_counts[m] (post-cap) and returns total.
//   pass 2: fills out_src/out_dst (size >= total from pass 1), grouped
//     by center ascending.
// Returns 0 on success.
int pgnn_radius_neighbors(const float* points, int64_t n_points,
                          const float* centers, int64_t n_centers,
                          float radius, int32_t max_neighbors, uint64_t seed,
                          int64_t* out_counts,  // [n_centers]
                          int64_t* out_offsets, // [n_centers+1], pass2 input
                          int64_t* out_src, int64_t* out_dst) {
  if (n_points == 0 || n_centers == 0) return 0;
  // Built during the counting pass, read-only in the fill pass.  The
  // two passes must be issued back-to-back by a single caller (the
  // Python wrapper holds a lock around both), so a process-wide slot
  // is safe and avoids rebuilds.
  static Grid grid;
  const bool counting = (out_src == nullptr);
  if (counting) {
    build_grid(points, n_points, centers, n_centers, radius, &grid);
  }
  const double r2 = (double)radius * (double)radius;
  const int64_t* skeys = grid.sorted_keys.data();
  const int64_t* spoint = grid.sorted_point.data();
  const int64_t n = n_points;
  const int64_t d1 = grid.dims[1], d2g = grid.dims[2];

  for_each_center(n_centers, 64, [&](int64_t c) {
    const double cx = centers[c * 3 + 0], cy = centers[c * 3 + 1],
                 cz = centers[c * 3 + 2];
    const int64_t gx = (int64_t)((cx - grid.origin[0]) * grid.inv_cell) + 1;
    const int64_t gy = (int64_t)((cy - grid.origin[1]) * grid.inv_cell) + 1;
    const int64_t gz = (int64_t)((cz - grid.origin[2]) * grid.inv_cell) + 1;
    int64_t found = 0;
    int64_t* dst_slot = counting ? nullptr : out_src + out_offsets[c];
    const int64_t cap =
        (max_neighbors > 0) ? (int64_t)max_neighbors : INT64_MAX;
    uint64_t rng_state = seed * 0x9e3779b97f4a7c15ULL + (uint64_t)c + 1;
    for (int64_t ox = -1; ox <= 1; ++ox)
      for (int64_t oy = -1; oy <= 1; ++oy)
        for (int64_t oz = -1; oz <= 1; ++oz) {
          const int64_t key =
              ((gx + ox) * d1 + (gy + oy)) * d2g + (gz + oz);
          const int64_t* lo = std::lower_bound(skeys, skeys + n, key);
          const int64_t* hi = std::upper_bound(lo, skeys + n, key);
          for (const int64_t* it = lo; it != hi; ++it) {
            const int64_t p = spoint[it - skeys];
            const double dx = points[p * 3 + 0] - cx;
            const double dy = points[p * 3 + 1] - cy;
            const double dz = points[p * 3 + 2] - cz;
            if (dx * dx + dy * dy + dz * dz <= r2) {
              if (counting) {
                ++found;
              } else {
                // reservoir sampling: first `cap` kept, later ones
                // replace a uniform slot with prob cap/found
                if (found < cap) {
                  dst_slot[found] = p;
                } else {
                  const uint64_t j = rand_below(rng_state, (uint64_t)found + 1);
                  if ((int64_t)j < cap) dst_slot[j] = p;
                }
                ++found;
              }
            }
          }
        }
    if (counting) {
      out_counts[c] = std::min(found, cap);
    } else {
      const int64_t kept = std::min(found, cap);
      int64_t* dsts = out_dst + out_offsets[c];
      for (int64_t i = 0; i < kept; ++i) dsts[i] = c;
    }
  });
  return 0;
}

}  // extern "C"
