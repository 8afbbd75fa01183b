// Offline KITTI object-detection AP evaluator.
//
// Native-equivalent of the reference's only C++ component, the
// `kitti_native_evaluation` submodule (reference .gitmodules:1-3,
// README.md:110-118): reads ground-truth and detection label files and
// computes official-protocol average precision for 2D bbox, bird's-eye
// view, and 3D boxes, plus AOS, at easy/moderate/hard difficulty, with
// both 11-point and 40-point interpolation.  Re-implemented from the
// published KITTI protocol (not copied): per-difficulty ignore rules,
// neighbor-class ignores (Van~Car, Person_sitting~Pedestrian),
// DontCare-region suppression, recall-sampled score thresholds, greedy
// best-overlap assignment.
//
// Usage: evaluate_object_offline <gt_dir> <result_dir>
//   gt_dir:      directory of KITTI ground-truth label .txt files
//   result_dir:  directory with detections under <result_dir>/data/
// Writes  <result_dir>/stats_<class>_ap.txt and prints a summary.

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int kNumDifficulty = 3;
constexpr double kMinHeight[kNumDifficulty] = {40.0, 25.0, 25.0};
constexpr int kMaxOcclusion[kNumDifficulty] = {0, 1, 2};
constexpr double kMaxTruncation[kNumDifficulty] = {0.15, 0.3, 0.5};
constexpr int kNSamplePts = 41;

struct Label {
  std::string type;
  double truncation = 0, occlusion = 0, alpha = 0;
  double x1 = 0, y1 = 0, x2 = 0, y2 = 0;       // 2D bbox
  double h = 0, w = 0, l = 0;                  // dimensions
  double x = 0, y = 0, z = 0, ry = 0;          // location + yaw
  double score = 0;
};

struct ClassSpec {
  std::string name;
  std::vector<std::string> neighbors;  // ignored, not penalized
  double min_overlap_2d;
  double min_overlap_3d;  // also used for BEV
};

const std::vector<ClassSpec> kClasses = {
    {"Car", {"Van"}, 0.7, 0.7},
    {"Pedestrian", {"Person_sitting"}, 0.5, 0.5},
    {"Cyclist", {}, 0.5, 0.5},
};

std::vector<Label> ParseFile(const std::string& path) {
  std::vector<Label> labels;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    Label lb;
    if (!(ss >> lb.type)) continue;
    ss >> lb.truncation >> lb.occlusion >> lb.alpha >> lb.x1 >> lb.y1 >>
        lb.x2 >> lb.y2 >> lb.h >> lb.w >> lb.l >> lb.x >> lb.y >> lb.z >>
        lb.ry;
    if (!(ss >> lb.score)) lb.score = 0;
    labels.push_back(lb);
  }
  return labels;
}

// ---------------------------------------------------------------------------
// geometry
// ---------------------------------------------------------------------------

double Box2dOverlap(const Label& a, const Label& b) {
  double ix = std::min(a.x2, b.x2) - std::max(a.x1, b.x1);
  double iy = std::min(a.y2, b.y2) - std::max(a.y1, b.y1);
  if (ix <= 0 || iy <= 0) return 0;
  double inter = ix * iy;
  double ua = (a.x2 - a.x1) * (a.y2 - a.y1);
  double ub = (b.x2 - b.x1) * (b.y2 - b.y1);
  return inter / (ua + ub - inter);
}

struct Pt {
  double x, z;
};

// BEV footprint corners (camera coords: x right, z forward; yaw about y)
std::vector<Pt> BevCorners(const Label& b) {
  double c = std::cos(b.ry), s = std::sin(b.ry);
  double hl = b.l / 2, hw = b.w / 2;
  std::vector<Pt> out(4);
  const double cx[4] = {hl, hl, -hl, -hl};
  const double cz[4] = {hw, -hw, -hw, hw};
  for (int i = 0; i < 4; ++i) {
    out[i] = {b.x + c * cx[i] + s * cz[i], b.z - s * cx[i] + c * cz[i]};
  }
  return out;
}

double PolyArea(const std::vector<Pt>& p) {
  double a = 0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.z - v.x * u.z;
  }
  return std::fabs(a) / 2;
}

double Cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.z - o.z) - (a.z - o.z) * (b.x - o.x);
}

// Sutherland-Hodgman convex clip
std::vector<Pt> ClipPoly(std::vector<Pt> subject, std::vector<Pt> clip) {
  if (Cross(clip[0], clip[1], clip[2]) < 0)
    std::reverse(clip.begin(), clip.end());
  for (size_t i = 0; i < clip.size() && !subject.empty(); ++i) {
    const Pt& a = clip[i];
    const Pt& b = clip[(i + 1) % clip.size()];
    std::vector<Pt> out;
    for (size_t j = 0; j < subject.size(); ++j) {
      const Pt& p = subject[j];
      const Pt& q = subject[(j + 1) % subject.size()];
      double dp = Cross(a, b, p), dq = Cross(a, b, q);
      if (dp >= 0) out.push_back(p);
      if ((dp >= 0) != (dq >= 0)) {
        double t = dp / (dp - dq);
        out.push_back({p.x + t * (q.x - p.x), p.z + t * (q.z - p.z)});
      }
    }
    subject = std::move(out);
  }
  return subject;
}

double BevInterArea(const Label& a, const Label& b) {
  auto inter = ClipPoly(BevCorners(a), BevCorners(b));
  if (inter.size() < 3) return 0;
  return PolyArea(inter);
}

double BoxBevOverlap(const Label& a, const Label& b) {
  double inter = BevInterArea(a, b);
  double ua = a.l * a.w, ub = b.l * b.w;
  double denom = ua + ub - inter;
  return denom > 0 ? inter / denom : 0;
}

double Box3dOverlap(const Label& a, const Label& b) {
  double inter_area = BevInterArea(a, b);
  // y points down: box spans [y - h, y]
  double ymax = std::min(a.y, b.y);
  double ymin = std::max(a.y - a.h, b.y - b.h);
  double inter = inter_area * std::max(0.0, ymax - ymin);
  double va = a.l * a.w * a.h, vb = b.l * b.w * b.h;
  double denom = va + vb - inter;
  return denom > 0 ? inter / denom : 0;
}

// ---------------------------------------------------------------------------
// evaluation protocol
// ---------------------------------------------------------------------------

enum Metric { kMetric2d = 0, kMetricBev = 1, kMetric3d = 2 };

double Overlap(Metric m, const Label& det, const Label& gt) {
  switch (m) {
    case kMetric2d:
      return Box2dOverlap(det, gt);
    case kMetricBev:
      return BoxBevOverlap(det, gt);
    default:
      return Box3dOverlap(det, gt);
  }
}

// gt assignment category
enum GtCat { kValid, kIgnored, kExcluded };

struct FrameEval {
  std::vector<GtCat> gt_cat;
  std::vector<int> dontcare;         // indices of DontCare gts
  std::vector<bool> det_same_class;  // detection type == class
  std::vector<bool> det_too_small;   // height below difficulty min
};

FrameEval ClassifyFrame(const std::vector<Label>& gts,
                        const std::vector<Label>& dets,
                        const ClassSpec& cls, int difficulty) {
  FrameEval fe;
  fe.gt_cat.resize(gts.size(), kExcluded);
  for (size_t i = 0; i < gts.size(); ++i) {
    const Label& g = gts[i];
    if (g.type == "DontCare") {
      fe.dontcare.push_back(i);
      continue;
    }
    bool same = g.type == cls.name;
    bool neighbor =
        std::find(cls.neighbors.begin(), cls.neighbors.end(), g.type) !=
        cls.neighbors.end();
    if (!same && !neighbor) continue;
    bool too_hard = g.occlusion > kMaxOcclusion[difficulty] ||
                    g.truncation > kMaxTruncation[difficulty] ||
                    (g.y2 - g.y1) < kMinHeight[difficulty];
    if (same && !too_hard)
      fe.gt_cat[i] = kValid;
    else
      fe.gt_cat[i] = kIgnored;  // same-but-harder or neighbor class
  }
  fe.det_same_class.resize(dets.size());
  fe.det_too_small.resize(dets.size());
  for (size_t j = 0; j < dets.size(); ++j) {
    fe.det_same_class[j] = dets[j].type == cls.name;
    fe.det_too_small[j] =
        (dets[j].y2 - dets[j].y1) < kMinHeight[difficulty];
  }
  return fe;
}

struct PrPoint {
  double tp = 0, fp = 0, fn = 0;
  double similarity = 0;  // orientation similarity accumulator (AOS)
};

// One frame's contribution at a given score threshold.
void EvalFrame(const std::vector<Label>& gts, const std::vector<Label>& dets,
               const FrameEval& fe, const ClassSpec& cls, Metric metric,
               double thresh, bool compute_aos, PrPoint* pr,
               std::vector<double>* matched_scores) {
  double min_overlap = metric == kMetric2d ? cls.min_overlap_2d
                                           : cls.min_overlap_3d;
  std::vector<bool> det_assigned(dets.size(), false);
  std::vector<bool> gt_assigned(gts.size(), false);
  // greedy: each valid/ignored gt takes its best-overlap detection
  for (size_t i = 0; i < gts.size(); ++i) {
    if (fe.gt_cat[i] == kExcluded) continue;
    int best = -1;
    double best_overlap = min_overlap;
    bool best_ignored_det = false;
    for (size_t j = 0; j < dets.size(); ++j) {
      if (!fe.det_same_class[j] || det_assigned[j]) continue;
      if (dets[j].score < thresh) continue;
      double ov = Overlap(metric, dets[j], gts[i]);
      if (ov < best_overlap) continue;
      // prefer any qualifying detection; among them the highest overlap
      if (best < 0 || ov > best_overlap || best_ignored_det) {
        best = j;
        best_overlap = ov;
        best_ignored_det = fe.det_too_small[j];
      }
    }
    if (best < 0) {
      if (fe.gt_cat[i] == kValid && matched_scores == nullptr) pr->fn += 1;
      continue;
    }
    det_assigned[best] = true;
    gt_assigned[i] = true;
    if (fe.gt_cat[i] == kValid && !fe.det_too_small[best]) {
      if (matched_scores != nullptr) {
        matched_scores->push_back(dets[best].score);
      } else {
        pr->tp += 1;
        if (compute_aos) {
          pr->similarity +=
              (1.0 + std::cos(gts[i].alpha - dets[best].alpha)) / 2.0;
        }
      }
    }
    // matches to ignored gts / too-small detections: neither TP nor FP
  }
  if (matched_scores != nullptr) return;
  // false positives: unassigned same-class detections above threshold,
  // not excused by size, not covering a DontCare region
  for (size_t j = 0; j < dets.size(); ++j) {
    if (!fe.det_same_class[j] || det_assigned[j]) continue;
    if (dets[j].score < thresh || fe.det_too_small[j]) continue;
    bool in_dontcare = false;
    for (int dc : fe.dontcare) {
      if (Box2dOverlap(dets[j], gts[dc]) > 0.5) {
        in_dontcare = true;
        break;
      }
    }
    if (!in_dontcare) pr->fp += 1;
  }
}

std::vector<double> GetThresholds(std::vector<double> scores,
                                  double n_groundtruth) {
  std::sort(scores.begin(), scores.end(), std::greater<double>());
  std::vector<double> thresholds;
  double current_recall = 0;
  for (size_t i = 0; i < scores.size(); ++i) {
    double l_recall = (i + 1) / n_groundtruth;
    double r_recall =
        i < scores.size() - 1 ? (i + 2) / n_groundtruth : l_recall;
    if ((r_recall - current_recall) < (current_recall - l_recall) &&
        i < scores.size() - 1)
      continue;
    thresholds.push_back(scores[i]);
    current_recall += 1.0 / (kNSamplePts - 1.0);
  }
  return thresholds;
}

struct ApResult {
  double ap11 = 0, ap40 = 0, aos11 = 0, aos40 = 0;
  std::vector<double> precision;  // at kNSamplePts recall points
};

ApResult EvalClassMetric(const std::vector<std::vector<Label>>& all_gts,
                         const std::vector<std::vector<Label>>& all_dets,
                         const ClassSpec& cls, Metric metric, int difficulty,
                         bool compute_aos) {
  size_t n = all_gts.size();
  std::vector<FrameEval> frame_eval(n);
  double n_gt = 0;
  std::vector<double> matched_scores;
  for (size_t f = 0; f < n; ++f) {
    frame_eval[f] = ClassifyFrame(all_gts[f], all_dets[f], cls, difficulty);
    for (GtCat c : frame_eval[f].gt_cat)
      if (c == kValid) n_gt += 1;
    PrPoint dummy;
    EvalFrame(all_gts[f], all_dets[f], frame_eval[f], cls, metric, -1e9,
              false, &dummy, &matched_scores);
  }
  ApResult res;
  res.precision.assign(kNSamplePts, 0);
  if (n_gt == 0 || matched_scores.empty()) return res;
  std::vector<double> thresholds = GetThresholds(matched_scores, n_gt);
  std::vector<PrPoint> pr(thresholds.size());
  for (size_t f = 0; f < n; ++f) {
    for (size_t t = 0; t < thresholds.size(); ++t) {
      EvalFrame(all_gts[f], all_dets[f], frame_eval[f], cls, metric,
                thresholds[t], compute_aos, &pr[t], nullptr);
    }
  }
  std::vector<double> precision(kNSamplePts, 0), aos(kNSamplePts, 0);
  for (size_t t = 0; t < thresholds.size(); ++t) {
    double denom = pr[t].tp + pr[t].fp;
    precision[t] = denom > 0 ? pr[t].tp / denom : 0;
    aos[t] = denom > 0 ? pr[t].similarity / denom : 0;
  }
  // monotone smoothing: precision at recall r = max precision at >= r
  for (int t = kNSamplePts - 2; t >= 0; --t) {
    precision[t] = std::max(precision[t], precision[t + 1]);
    aos[t] = std::max(aos[t], aos[t + 1]);
  }
  // 11-point: recall 0, 0.1, ..., 1.0 (indices 0, 4, 8, ...)
  for (int t = 0; t < kNSamplePts; t += 4) {
    res.ap11 += precision[t] / 11.0 * 100.0;
    res.aos11 += aos[t] / 11.0 * 100.0;
  }
  // 40-point: recall 1/40 ... 1 (indices 1..40)
  for (int t = 1; t < kNSamplePts; ++t) {
    res.ap40 += precision[t] / 40.0 * 100.0;
    res.aos40 += aos[t] / 40.0 * 100.0;
  }
  res.precision = precision;
  return res;
}

std::vector<std::string> ListTxt(const std::string& dir) {
  std::vector<std::string> names;
  DIR* d = opendir(dir.c_str());
  if (!d) return names;
  while (dirent* e = readdir(d)) {
    std::string n = e->d_name;
    if (n.size() > 4 && n.substr(n.size() - 4) == ".txt")
      names.push_back(n);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  return names;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    std::fprintf(stderr, "usage: %s <gt_dir> <result_dir>\n", argv[0]);
    return 1;
  }
  std::string gt_dir = argv[1];
  std::string result_dir = argv[2];
  std::string det_dir = result_dir + "/data";

  std::vector<std::string> files = ListTxt(det_dir);
  if (files.empty()) {
    std::fprintf(stderr, "no detection files in %s\n", det_dir.c_str());
    return 1;
  }
  std::vector<std::vector<Label>> gts, dets;
  for (const std::string& f : files) {
    gts.push_back(ParseFile(gt_dir + "/" + f));
    dets.push_back(ParseFile(det_dir + "/" + f));
  }
  std::printf("Loaded %zu frames\n", files.size());

  const char* metric_names[3] = {"detection", "bev", "3d"};
  const char* diff_names[3] = {"easy", "moderate", "hard"};
  for (const ClassSpec& cls : kClasses) {
    bool any = false;
    for (const auto& frame : gts)
      for (const Label& g : frame)
        if (g.type == cls.name) any = true;
    if (!any) continue;
    std::ofstream stats(result_dir + "/stats_" +
                        [&] {
                          std::string s = cls.name;
                          for (char& c : s) c = std::tolower(c);
                          return s;
                        }() +
                        "_ap.txt");
    for (int m = 0; m < 3; ++m) {
      for (int d = 0; d < kNumDifficulty; ++d) {
        ApResult r = EvalClassMetric(gts, dets, cls, Metric(m), d,
                                     /*compute_aos=*/m == kMetric2d);
        std::printf("%s_%s_%s AP: %.4f AP_R40: %.4f", cls.name.c_str(),
                    metric_names[m], diff_names[d], r.ap11, r.ap40);
        if (m == kMetric2d)
          std::printf(" AOS: %.4f AOS_R40: %.4f", r.aos11, r.aos40);
        std::printf("\n");
        stats << cls.name << "_" << metric_names[m] << "_" << diff_names[d]
              << " " << r.ap11 << " " << r.ap40 << "\n";
      }
    }
  }
  return 0;
}
