// Greedy rotated-box NMS with median merge and overlap-weighted rescore.
//
// The port's copy of cpp/graphlib/nms.cpp (``pgnn_nms`` and its
// helpers), built at first use by pointgnn_tpu_torch/postprocess/native.py
// with the host compiler and loaded with ctypes.  It is the native loop
// of pointgnn_tpu_torch/postprocess/nms.py::_greedy_nms: the same pair
// tests as the numpy loop there, in f64, including the float32 cast of
// the intersection volume.  Built with the JAX package's flags (-O3
// -march=native -std=c++17, no -ffast-math), so the compiler contracts
// the same products into FMAs and the results equal the JAX package's
// library bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Vec2 {
  double x, z;
};

// Shoelace area, sign-free (iou.py::polygon_area).
double polygon_area(const std::vector<Vec2>& p) {
  double s = 0.0;
  const size_t n = p.size();
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

// Sutherland-Hodgman convex clip (iou.py::clip_polygon): clip `subject`
// by convex quad `clip` (reoriented CCW), >=0 counted inside, identical
// branch structure so degenerate cases round the same way.
std::vector<Vec2> clip_polygon(std::vector<Vec2> output, Vec2 clip[4]) {
  if (cross2(clip[1].x - clip[0].x, clip[1].z - clip[0].z,
             clip[2].x - clip[1].x, clip[2].z - clip[1].z) < 0) {
    std::swap(clip[0], clip[3]);
    std::swap(clip[1], clip[2]);
  }
  std::vector<Vec2> next;
  for (int e = 0; e < 4 && !output.empty(); ++e) {
    const Vec2 a = clip[e];
    const Vec2 b = clip[(e + 1) % 4];
    const double ex = b.x - a.x, ez = b.z - a.z;
    const size_t n = output.size();
    next.clear();
    for (size_t j = 0; j < n; ++j) {
      const Vec2& v = output[j];
      const Vec2& w = output[(j + 1) % n];
      const double d = cross2(ex, ez, v.x - a.x, v.z - a.z);
      const double dn = cross2(ex, ez, w.x - a.x, w.z - a.z);
      if (d >= 0) next.push_back(v);
      if ((d >= 0) != (dn >= 0)) {
        const double denom = d - dn;
        if (denom != 0) {
          const double t = d / denom;
          next.push_back({v.x + t * (w.x - v.x), v.z + t * (w.z - v.z)});
        }
      }
    }
    output.swap(next);
  }
  return output;
}

// corners: [8][3] row-major (top face rows 0-3).  Overlap of one box
// against another (iou.py::overlapped_boxes_3d for a single pair; the
// AABB prefilter lives in the caller's loop).
double pair_overlap(const double* c1, const double* c2) {
  double max1[3], min1[3], max2[3], min2[3];
  for (int d = 0; d < 3; ++d) {
    max1[d] = max2[d] = -1e300;
    min1[d] = min2[d] = 1e300;
  }
  for (int k = 0; k < 8; ++k) {
    for (int d = 0; d < 3; ++d) {
      max1[d] = std::max(max1[d], c1[k * 3 + d]);
      min1[d] = std::min(min1[d], c1[k * 3 + d]);
      max2[d] = std::max(max2[d], c2[k * 3 + d]);
      min2[d] = std::min(min2[d], c2[k * 3 + d]);
    }
  }
  for (int d = 0; d < 3; ++d) {
    if (max1[d] < min2[d] || min1[d] > max2[d]) return 0.0;
  }
  std::vector<Vec2> poly1 = {{c1[0], c1[2]},
                             {c1[3], c1[5]},
                             {c1[6], c1[8]},
                             {c1[9], c1[11]}};
  Vec2 poly2[4] = {{c2[0], c2[2]},
                   {c2[3], c2[5]},
                   {c2[6], c2[8]},
                   {c2[9], c2[11]}};
  const double area1 = polygon_area(poly1);
  std::vector<Vec2> quad2 = {poly2[0], poly2[1], poly2[2], poly2[3]};
  const double area2 = polygon_area(quad2);
  std::vector<Vec2> inter = clip_polygon(std::move(poly1), poly2);
  const double shared_area = inter.size() < 3 ? 0.0 : polygon_area(inter);
  const double shared_y =
      std::min(max2[1], max1[1]) - std::max(min2[1], min1[1]);
  // parity with iou.py:99 `np.float32(intersection) / (union - intersection)`:
  // only the NUMERATOR is rounded to float32; the denominator keeps the
  // unrounded float64 intersection (numpy folds the f32 back to f64 for
  // the division).
  const double inter_f64 = shared_y * shared_area;
  const double uni = (max2[1] - min2[1]) * area2 + (max1[1] - min1[1]) * area1;
  return (double)(float)inter_f64 / (uni - inter_f64);
}

// boxes_to_corners for ONE box (core/boxes.py:47-75, expand=(1,1,1)),
// used to refresh the merged box's corners for rescoring.
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

}  // namespace

extern "C" {

// All arrays row-major.  `boxes` [n,7] sorted by decreasing score is
// copied into `out_boxes` and mutated by merging; `scores` mutated by
// rescoring; `keep` [n] gets 1 for survivors.  `corners` [n,8,3] are
// the (possibly quantized) corners of the ORIGINAL boxes — the greedy
// pair tests always use these (reference never refreshes corners after
// a merge); only the rescore step recomputes the merged box's corners.
void pgnn_nms(const double* boxes, const double* corners,
              const int64_t* classes, double* scores, int64_t n,
              double threshold, int merge, int rescore, double* out_boxes,
              uint8_t* keep) {
  std::copy(boxes, boxes + n * 7, out_boxes);
  std::fill(keep, keep + n, uint8_t{1});
  std::vector<int64_t> removed;
  std::vector<double> col(16);
  double merged_c[24];
  for (int64_t i = 0; i + 1 < n; ++i) {
    if (!keep[i]) continue;
    removed.clear();
    for (int64_t j = i + 1; j < n; ++j) {
      if (!keep[j] || classes[j] != classes[i]) continue;
      const double ov = pair_overlap(corners + i * 24, corners + j * 24);
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
      double add = 0.0;
      for (int64_t j : removed) {
        add += scores[j] * pair_overlap(merged_c, corners + j * 24);
      }
      scores[i] += add;
    }
    for (int64_t j : removed) keep[j] = 0;
  }
}

}  // extern "C"
