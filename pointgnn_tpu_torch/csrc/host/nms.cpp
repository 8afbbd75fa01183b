// Greedy rotated-box NMS with median merge and overlap-weighted rescore.
//
// The native loop of pointgnn_tpu_torch/postprocess/nms.py::_greedy_nms,
// built at first use by pointgnn_tpu_torch/postprocess/native.py with the
// host compiler and loaded with ctypes.  Its pair test is the one of the
// numpy loop there, in f64, including the float32 cast of the
// intersection volume.
//
// The greedy loop tests a survivor only against the later boxes whose
// axis-aligned bounds can meet its own.  Each box's bounds and top-face
// area are computed once.  A uniform grid over x-z (cells the median
// box's larger x/z extent, at most 256 a side) lists each box in every
// cell its bounds cover; a box that covers more than 16 cells, or whose
// x/z bounds are no finite interval, goes to an oversize list instead.  A
// survivor walks the lists of the cells its bounds cover and the oversize
// list, and each list sheds the boxes removed or passed on the way; an
// oversize survivor scans every later box.  This is exact: a pair whose
// bounds do not meet overlaps by 0.0, and 0.0 > threshold is false for
// any threshold >= 0, so those pairs were never removed.  A negative
// threshold removes them, so it scans every later box.  The candidates
// are tested in ascending index, so `removed`, the merge's median and the
// rescore's sum see the same boxes in the same order as a scan of every
// later box.
//
// The original boxes' corners: that library is handed them by its
// caller, computed by numpy (core/boxes.py::boxes_to_corners); this loop
// computes them itself, once per box (pgnn_box_corners), with numpy's
// arithmetic written out as explicit fused multiply-adds, unless its
// caller hands it corners (the quantized variant's).  Every other value
// is computed by the floating-point operations that cpp/graphlib/nms.cpp
// (the JAX package's library) uses for it, in the same order; a vertex's
// side of a clip edge is computed once.  The polygons live in fixed
// arrays.  Built with that library's flags (-O3 -march=native
// -std=c++17, no -ffast-math), the compiler contracts the same products
// into FMAs and the results equal that library's bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Vec2 {
  double x, z;
};

// Sutherland-Hodgman keeps or drops each vertex and adds at most one
// crossing after it, so each clip edge at most doubles the vertices: the
// four edges take a quad to at most 64, whatever its shape.
constexpr int kMaxPoly = 64;

// The grid: cells a side, and the most cells a box may cover before it
// goes to the oversize list.
constexpr int64_t kMaxCellsPerAxis = 256;
constexpr int64_t kMaxCellsPerBox = 16;

// Shoelace area, sign-free (iou.py::polygon_area).
double polygon_area(const Vec2* p, size_t n) {
  double s = 0.0;
  for (size_t i = 0; i < n; ++i) {
    const Vec2& a = p[i];
    const Vec2& b = p[(i + 1) % n];
    s += a.x * b.z - b.x * a.z;
  }
  return 0.5 * std::abs(s);
}

double cross2(double ux, double uz, double vx, double vz) {
  return ux * vz - uz * vx;
}

// Sutherland-Hodgman convex clip (iou.py::clip_polygon) of the quad
// `subject` by the convex quad `clip` (reoriented CCW), >=0 counted
// inside, identical branch structure so degenerate cases round the same
// way.  Returns the area of the clipped polygon, 0.0 below 3 vertices.
double clipped_area(const Vec2 subject[4], Vec2 clip[4]) {
  if (cross2(clip[1].x - clip[0].x, clip[1].z - clip[0].z,
             clip[2].x - clip[1].x, clip[2].z - clip[1].z) < 0) {
    std::swap(clip[0], clip[3]);
    std::swap(clip[1], clip[2]);
  }
  Vec2 buf_a[kMaxPoly], buf_b[kMaxPoly];
  Vec2* output = buf_a;
  Vec2* next = buf_b;
  std::copy(subject, subject + 4, output);
  size_t n = 4;
  for (int e = 0; e < 4 && n > 0; ++e) {
    const Vec2 a = clip[e];
    const Vec2 b = clip[(e + 1) % 4];
    const double ex = b.x - a.x, ez = b.z - a.z;
    size_t m = 0;
    // each vertex's side, computed once: it is the next vertex's `dn`
    const double d0 = cross2(ex, ez, output[0].x - a.x, output[0].z - a.z);
    double d = d0;
    for (size_t j = 0; j < n; ++j) {
      const Vec2& v = output[j];
      const Vec2& w = output[(j + 1) % n];
      const double dn =
          j + 1 < n ? cross2(ex, ez, w.x - a.x, w.z - a.z) : d0;
      if (d >= 0) next[m++] = v;
      if ((d >= 0) != (dn >= 0)) {
        const double denom = d - dn;
        if (denom != 0) {
          const double t = d / denom;
          next[m++] = {v.x + t * (w.x - v.x), v.z + t * (w.z - v.z)};
        }
      }
      d = dn;
    }
    std::swap(output, next);
    n = m;
  }
  return n < 3 ? 0.0 : polygon_area(output, n);
}

// A box's axis-aligned bounds over its 8 corners, folded as the JAX
// library folds them in each pair test.
struct Bounds {
  double max[3], min[3];
};

Bounds bounds_of(const double* c /* [8][3] */) {
  Bounds b;
  for (int d = 0; d < 3; ++d) {
    b.max[d] = -1e300;
    b.min[d] = 1e300;
  }
  for (int k = 0; k < 8; ++k) {
    for (int d = 0; d < 3; ++d) {
      b.max[d] = std::max(b.max[d], c[k * 3 + d]);
      b.min[d] = std::min(b.min[d], c[k * 3 + d]);
    }
  }
  return b;
}

bool bounds_meet(const Bounds& b1, const Bounds& b2) {
  for (int d = 0; d < 3; ++d) {
    if (b1.max[d] < b2.min[d] || b1.min[d] > b2.max[d]) return false;
  }
  return true;
}

// The top face (corner rows 0-3) in x-z.
void top_face(const double* c, Vec2 out[4]) {
  out[0] = {c[0], c[2]};
  out[1] = {c[3], c[5]};
  out[2] = {c[6], c[8]};
  out[3] = {c[9], c[11]};
}

double top_area(const double* c) {
  Vec2 quad[4];
  top_face(c, quad);
  return polygon_area(quad, 4);
}

// Overlap of box 1 with box 2 (iou.py::overlapped_boxes_3d for a single
// pair) whose bounds meet; `area1`, `area2` are their top_area.
double pair_overlap(const double* c1, const Bounds& b1, double area1,
                    const double* c2, const Bounds& b2, double area2) {
  Vec2 poly1[4], poly2[4];
  top_face(c1, poly1);
  top_face(c2, poly2);
  const double shared_area = clipped_area(poly1, poly2);
  const double shared_y =
      std::min(b2.max[1], b1.max[1]) - std::max(b2.min[1], b1.min[1]);
  // parity with iou.py:99 `np.float32(intersection) / (union - intersection)`:
  // only the NUMERATOR is rounded to float32; the denominator keeps the
  // unrounded float64 intersection (numpy folds the f32 back to f64 for
  // the division).
  const double inter_f64 = shared_y * shared_area;
  const double uni =
      (b2.max[1] - b2.min[1]) * area2 + (b1.max[1] - b1.min[1]) * area1;
  return (double)(float)inter_f64 / (uni - inter_f64);
}

// boxes_to_corners for ONE box as cpp/graphlib/nms.cpp computes it (its
// products contracted where the compiler contracts them), used to
// refresh the merged box's corners for rescoring.
void box_corners(const double* b, double* out /* [24] */) {
  const double x = b[0], y = b[1], z = b[2];
  const double l = b[3], h = b[4], w = b[5], yaw = b[6];
  static const double cx[4] = {1, 1, -1, -1};
  static const double cz[4] = {1, -1, -1, 1};
  const double c = std::cos(yaw), s = std::sin(yaw);
  for (int k = 0; k < 8; ++k) {
    const double lx = cx[k % 4] * (l / 2.0);
    const double lz = cz[k % 4] * (w / 2.0);
    const double ly = k < 4 ? 0.0 : -h;
    out[k * 3 + 0] = c * lx + s * lz + x;
    out[k * 3 + 1] = ly + y;
    out[k * 3 + 2] = -s * lx + c * lz + z;
  }
}

// numpy-parity median over m values (average of middle pair when even).
double median(std::vector<double>& v) {
  const size_t n = v.size();
  std::sort(v.begin(), v.end());
  if (n % 2 == 1) return v[n / 2];
  return 0.5 * (v[n / 2 - 1] + v[n / 2]);
}

// The boxes in a uniform x-z grid: a list per cell of the boxes whose
// bounds cover it, ascending, and a last list of the boxes that fit no
// cell range (oversize).  A list drops the boxes the loop is done with
// as it is walked.
class BevGrid {
 public:
  explicit BevGrid(const std::vector<Bounds>& bounds) {
    const int64_t n = static_cast<int64_t>(bounds.size());
    big_.assign(n, 1);
    double x_lo = 1e300, x_hi = -1e300, z_lo = 1e300, z_hi = -1e300;
    std::vector<double> extent;
    extent.reserve(n);
    for (const Bounds& b : bounds) {
      if (!placeable(b)) continue;
      x_lo = std::min(x_lo, b.min[0]);
      x_hi = std::max(x_hi, b.max[0]);
      z_lo = std::min(z_lo, b.min[2]);
      z_hi = std::max(z_hi, b.max[2]);
      extent.push_back(std::max(b.max[0] - b.min[0], b.max[2] - b.min[2]));
    }
    double cell = 1.0;  // no box fits a cell: every one is oversize
    if (!extent.empty()) {
      std::nth_element(extent.begin(), extent.begin() + extent.size() / 2,
                       extent.end());
      cell = std::max({extent[extent.size() / 2],
                       (x_hi - x_lo) / kMaxCellsPerAxis,
                       (z_hi - z_lo) / kMaxCellsPerAxis});
      if (!(cell > 0)) cell = 1.0;  // every box a point, all at one place
      x0_ = x_lo;
      z0_ = z_lo;
    }
    inv_cell_ = 1.0 / cell;
    nx_ = 1 + index_below((x_hi - x_lo) * inv_cell_, kMaxCellsPerAxis - 1);
    nz_ = 1 + index_below((z_hi - z_lo) * inv_cell_, kMaxCellsPerAxis - 1);
    const int64_t oversize = nx_ * nz_;
    begin_.assign(oversize + 2, 0);
    int64_t r[4];
    for (int64_t j = 0; j < n; ++j) {
      if (!fits(bounds[j], r)) {
        ++begin_[oversize + 1];
        continue;
      }
      big_[j] = 0;
      for (int64_t iz = r[2]; iz <= r[3]; ++iz)
        for (int64_t ix = r[0]; ix <= r[1]; ++ix) ++begin_[iz * nx_ + ix + 1];
    }
    for (size_t c = 1; c < begin_.size(); ++c) begin_[c] += begin_[c - 1];
    items_.resize(begin_.back());
    end_.assign(begin_.begin(), begin_.end() - 1);
    for (int64_t j = 0; j < n; ++j) {
      if (big_[j]) {
        items_[end_[oversize]++] = j;
        continue;
      }
      cell_range(bounds[j], r);
      for (int64_t iz = r[2]; iz <= r[3]; ++iz)
        for (int64_t ix = r[0]; ix <= r[1]; ++ix)
          items_[end_[iz * nx_ + ix]++] = j;
    }
  }

  bool oversize(int64_t j) const { return big_[j] != 0; }

  // Calls wanted(j) for every j > i on the list of each cell that `b`
  // (box i's bounds, i not oversize) covers, then on the oversize list;
  // wanted(j) says whether a later survivor may still want j.  Each list
  // keeps only the j > i that were wanted: the loop's index only grows.
  template <typename Wanted>
  void for_each_later(int64_t i, const Bounds& b, Wanted wanted) {
    int64_t r[4];
    cell_range(b, r);
    for (int64_t iz = r[2]; iz <= r[3]; ++iz)
      for (int64_t ix = r[0]; ix <= r[1]; ++ix)
        walk(i, iz * nx_ + ix, wanted);
    walk(i, nx_ * nz_, wanted);
  }

 private:
  // A finite interval on x and on z (a box whose corners are all NaN
  // there keeps the fold's start, an inverted interval).
  static bool placeable(const Bounds& b) {
    for (int d : {0, 2}) {
      if (!(std::isfinite(b.min[d]) && std::isfinite(b.max[d]) &&
            b.min[d] <= b.max[d]))
        return false;
    }
    return true;
  }

  // floor(t) clamped to [0, hi]: monotone in t, so two boxes whose
  // bounds meet on an axis share a cell on it.
  static int64_t index_below(double t, int64_t hi) {
    return static_cast<int64_t>(
        std::min(static_cast<double>(hi), std::max(0.0, t)));
  }

  // Whether `b` goes in the cells it covers (r), not on the oversize
  // list.
  bool fits(const Bounds& b, int64_t r[4]) const {
    if (!placeable(b)) return false;
    cell_range(b, r);
    return (r[1] - r[0] + 1) * (r[3] - r[2] + 1) <= kMaxCellsPerBox;
  }

  // r = {ix_lo, ix_hi, iz_lo, iz_hi}, inclusive.
  void cell_range(const Bounds& b, int64_t r[4]) const {
    r[0] = index_below((b.min[0] - x0_) * inv_cell_, nx_ - 1);
    r[1] = index_below((b.max[0] - x0_) * inv_cell_, nx_ - 1);
    r[2] = index_below((b.min[2] - z0_) * inv_cell_, nz_ - 1);
    r[3] = index_below((b.max[2] - z0_) * inv_cell_, nz_ - 1);
  }

  template <typename Wanted>
  void walk(int64_t i, int64_t list, Wanted& wanted) {
    int64_t kept = begin_[list];
    for (int64_t p = begin_[list]; p < end_[list]; ++p) {
      const int64_t j = items_[p];
      if (j > i && wanted(j)) items_[kept++] = j;
    }
    end_[list] = kept;
  }

  double x0_ = 0, z0_ = 0, inv_cell_ = 1;
  int64_t nx_ = 1, nz_ = 1;
  std::vector<uint8_t> big_;
  // list c holds items_[begin_[c], end_[c])
  std::vector<int64_t> begin_, end_, items_;
};

}  // namespace

extern "C" {

// core/boxes.py::boxes_to_corners (expand=(1,1,1)) of `n` boxes [n,7]
// into `out` [n,8,3], value for value: numpy's operations in numpy's
// order.  numpy takes the local corners (+-l/2, 0 or -h, +-w/2) times
// yaw_rotation's transpose as a stack of small matrix products, each
// output the sum of three products accumulated from 0.0 by fused
// multiply-adds, then adds the center.  The fma calls are written out,
// so the result does not depend on what the compiler contracts; it
// equals numpy's bit for bit where numpy's cos, sin and small matrix
// products round so.
void pgnn_box_corners(const double* boxes, int64_t n, double* out) {
  static const double cx[4] = {1, 1, -1, -1};
  static const double cz[4] = {1, -1, -1, 1};
  for (int64_t i = 0; i < n; ++i) {
    const double* b = boxes + i * 7;
    double* o = out + i * 24;
    const double c = std::cos(b[6]), s = std::sin(b[6]);
    // yaw_rotation's rows
    const double rot[3][3] = {{c, 0.0, s}, {0.0, 1.0, 0.0}, {-s, 0.0, c}};
    const double dh = b[4] * 0.0;  // h * (f0 - 1.0)
    const double half_l = b[3] / 2.0, half_w = b[5] / 2.0;
    const double face_y[2] = {dh / 2.0, -b[4] - dh / 2.0};
    for (int k = 0; k < 8; ++k) {
      const double local[3] = {cx[k % 4] * half_l, face_y[k / 4],
                               cz[k % 4] * half_w};
      for (int j = 0; j < 3; ++j) {
        double acc = std::fma(local[0], rot[j][0], 0.0);
        acc = std::fma(local[1], rot[j][1], acc);
        acc = std::fma(local[2], rot[j][2], acc);
        o[k * 3 + j] = acc + b[j];
      }
    }
  }
}

// All arrays row-major.  `boxes` [n,7] sorted by decreasing score is
// copied into `out_boxes` and mutated by merging; `scores` mutated by
// rescoring; `keep` [n] gets 1 for survivors.  The greedy pair tests
// use the corners of the ORIGINAL boxes (reference never refreshes
// corners after a merge); only the rescore step recomputes the merged
// box's corners.  `corners` [n,8,3] gives them (the quantized variant's
// rounded corners); null, the loop computes them itself from `boxes`
// (pgnn_box_corners, once per box, into a buffer of its own).  `counts` [4]
// gets, over the greedy loop's survivors i: the kept same-class j > i
// (the pairs a scan of every later box tests), those handed to the
// bounds test (after the grid), and those whose bounds meet (each
// clipped once; the rescore's clips are not counted); then the boxes
// whose corners the loop computed (n with null `corners`, else 0).
void pgnn_nms(const double* boxes, const double* corners,
              const int64_t* classes, double* scores, int64_t n,
              double threshold, int merge, int rescore, double* out_boxes,
              uint8_t* keep, int64_t* counts) {
  std::copy(boxes, boxes + n * 7, out_boxes);
  std::fill(keep, keep + n, uint8_t{1});
  std::fill(counts, counts + 4, int64_t{0});
  std::vector<double> own;
  if (corners == nullptr) {
    own.resize(n * 24);
    pgnn_box_corners(boxes, n, own.data());
    corners = own.data();
    counts[3] = n;
  }
  if (n < 2) return;
  std::vector<Bounds> bounds(n);
  std::vector<double> area(n);
  for (int64_t j = 0; j < n; ++j) {
    bounds[j] = bounds_of(corners + j * 24);
    area[j] = top_area(corners + j * 24);
  }
  // kept boxes of each class at or after the loop's index
  std::vector<int64_t> class_ids(classes, classes + n);
  std::sort(class_ids.begin(), class_ids.end());
  class_ids.erase(std::unique(class_ids.begin(), class_ids.end()),
                  class_ids.end());
  std::vector<int64_t> cls(n), remaining(class_ids.size(), 0);
  for (int64_t j = 0; j < n; ++j) {
    cls[j] = std::lower_bound(class_ids.begin(), class_ids.end(),
                              classes[j]) - class_ids.begin();
    ++remaining[cls[j]];
  }
  const bool use_grid = !(threshold < 0);
  BevGrid grid(bounds);
  std::vector<int64_t> seen(n, -1), candidates, removed;
  std::vector<double> col(16);
  double merged_c[24];
  for (int64_t i = 0; i + 1 < n; ++i) {
    if (!keep[i]) continue;
    const int64_t ci = cls[i];
    counts[0] += remaining[ci] - 1;
    candidates.clear();
    if (use_grid && !grid.oversize(i)) {
      // pairs whose bounds do not meet overlap by 0.0 and are skipped
      grid.for_each_later(i, bounds[i], [&](int64_t j) {
        if (!keep[j]) return false;
        if (cls[j] == ci && seen[j] != i) {
          seen[j] = i;
          candidates.push_back(j);
        }
        return true;
      });
      std::sort(candidates.begin(), candidates.end());
    } else {
      for (int64_t j = i + 1; j < n; ++j)
        if (keep[j] && cls[j] == ci) candidates.push_back(j);
    }
    counts[1] += static_cast<int64_t>(candidates.size());
    removed.clear();
    for (int64_t j : candidates) {
      double ov = 0.0;
      if (bounds_meet(bounds[i], bounds[j])) {
        ++counts[2];
        ov = pair_overlap(corners + i * 24, bounds[i], area[i],
                          corners + j * 24, bounds[j], area[j]);
      }
      if (ov > threshold) removed.push_back(j);
    }
    if (merge && !removed.empty()) {
      for (int d = 0; d < 7; ++d) {
        col.clear();
        for (int64_t j : removed) col.push_back(out_boxes[j * 7 + d]);
        col.push_back(out_boxes[i * 7 + d]);
        out_boxes[i * 7 + d] = median(col);
      }
    }
    if (rescore && !removed.empty()) {
      box_corners(out_boxes + i * 7, merged_c);
      const Bounds merged_b = bounds_of(merged_c);
      const double merged_area = top_area(merged_c);
      double add = 0.0;
      for (int64_t j : removed) {
        const double ov =
            bounds_meet(merged_b, bounds[j])
                ? pair_overlap(merged_c, merged_b, merged_area,
                               corners + j * 24, bounds[j], area[j])
                : 0.0;
        add += scores[j] * ov;
      }
      scores[i] += add;
    }
    for (int64_t j : removed) keep[j] = 0;
    remaining[ci] -= 1 + static_cast<int64_t>(removed.size());
  }
}

}  // extern "C"
