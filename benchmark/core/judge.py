"""The comparison that decides ``correct`` for a served frame.

The timed path's output of one frame is read at two places: the device
program's hypotheses (``device_fn``'s top-k scores, classes, decoded
boxes and vertex coordinates) and the detections that the host
merge-NMS made of them.

The network is held to two references (:data:`REFERENCES`): the plain
float32 network, and the same with its folded tables rounded to
bfloat16, as a program that folds and computes in bfloat16 stores them.
The tables hold absolute coordinates, so that rounding alone puts such
a program's outputs about as far from the float32 network as a float8
network's (at pedestrian radii above all), while it puts the float8
network no nearer to the second reference than to the first.  Each
network number is taken against the reference nearer in it, so a
program may fold or not.

Five numbers, each the worst over the sampled frames:

- ``score_err``: the widest gap between a served hypothesis's score and
  the reference's probability of that (vertex, class); the gap by which
  a served hypothesis lies below the reference's own top-k cut; and the
  widest gap between the served and the reference's sorted top-k
  scores.  A hypothesis at a vertex that is no reference keypoint counts
  1.  This covers the graph build (keypoints, both levels'
  neighborhoods), the network and the softmax, mask and top-k.
- ``box_err``: the widest gap between a served hypothesis's box and the
  reference's decoding of that (vertex, class): the center in meters,
  the length, height and width relative to the reference's, the yaw in
  radians.  This covers the box heads and the decode.
- ``score_median``, ``box_median``: the medians over the frame's
  hypotheses of the same per-hypothesis gaps.  The widest gaps catch one
  wrong answer; the medians catch a lower precision everywhere.
- ``nms_err``: the reference merge-NMS (float64) run on the served
  hypotheses against the served detections: 1 where the kept classes
  differ, else the widest relative gap of a box field or a score.  The
  NMS follows the program's hypotheses, so it checks that stage alone;
  the numbers above check the stages before it from the raw frame.
"""

import numpy as np

from benchmark.reference import nms as ref_nms
from benchmark.reference import pointgnn as ref

# every number of a run that judged no frame: over any limit, and a
# number that JSON can carry
NOTHING_JUDGED = 1e30

NUMBERS = ("score_err", "box_err", "nms_err", "score_median",
           "box_median")
NETWORK = ("score_err", "box_err", "score_median", "box_median")

# the references that the network's output is held to, by their
# ``reference/pointgnn.py`` precision
REFERENCES = ("f32", "bf16_tables")


def fold_classes(cls, num_classes):
    """The vertical sub-class ``2c`` served as its class ``2c - 1``."""
    out = np.asarray(cls).astype(np.int64).copy()
    for v in range(2, num_classes - 1, 2):
        out[out == v] = v - 1
    return out


def reference_nms(hyp_scores, hyp_cls, hyp_boxes, config, dtype=np.float64):
    """Merge-NMS of the kept hypotheses (score > 0), as served."""
    keep = np.asarray(hyp_scores) > 0
    return ref_nms.merge_nms(
        fold_classes(np.asarray(hyp_cls)[keep], config["num_classes"]),
        np.asarray(hyp_boxes, np.float64)[keep],
        np.asarray(hyp_scores, np.float64)[keep],
        config["nms_overlapped_thres"], dtype=dtype)


def _rel_gap(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def box_gaps(boxes, ref_boxes):
    """Each ``[N, 7]`` box's widest gap: center (m), size (relative), yaw
    (rad)."""
    a = np.asarray(boxes, np.float64).reshape(-1, 7)
    b = np.asarray(ref_boxes, np.float64).reshape(-1, 7)
    d = np.abs(a - b)
    return np.maximum(np.maximum(d[:, :3].max(axis=1, initial=0.0),
                                 (d[:, 3:6] / np.abs(b[:, 3:6]))
                                 .max(axis=1, initial=0.0)), d[:, 6])


def judge_network(hyps, graph, probs, enc, config, max_hypotheses):
    """``{number: value}`` of :data:`NETWORK` for one frame against one
    reference.  ``hyps = (scores, classes, boxes, xyz)`` as ``device_fn``
    returns them (masked rows carry score -1); ``graph``, ``probs``,
    ``enc`` the reference's."""
    scores, cls, boxes, xyz = (np.asarray(a) for a in hyps)
    keep = scores > 0
    s = scores[keep].astype(np.float64)
    c = cls[keep].astype(np.int64)
    b = boxes[keep].astype(np.float64)
    x = np.ascontiguousarray(xyz[keep], dtype=np.float32)
    nc = config["num_classes"]

    kp = np.ascontiguousarray(graph.kp_xyz.cpu().numpy(), dtype=np.float32)
    index = {row.tobytes(): i for i, row in enumerate(kp)}
    k = np.array([index.get(row.tobytes(), -1) for row in x], np.int64)
    found = k >= 0
    p = probs.detach().cpu().numpy().astype(np.float64)
    cand = ref.candidate_scores(probs, config)
    ranked = np.sort(cand.reshape(-1))[::-1]
    ranked = ranked[ranked > 0][:max_hypotheses]
    cut = ranked[-1] if len(ranked) == max_hypotheses else 1.0 / nc

    err = np.ones(len(s))
    kk, cc = k[found], c[found]
    sub = np.ones(len(kk))
    fg = (cc >= 1) & (cc <= nc - 2)
    pr = p[kk[fg], cc[fg]]
    sub[fg] = np.maximum(np.abs(s[found][fg] - pr), np.maximum(0.0, cut - pr))
    err[found] = sub
    served = np.sort(s)[::-1]
    n = max(len(served), len(ranked))
    pad = lambda a: np.concatenate([a, np.full(n - len(a), 1.0 / nc)])
    rank_gap = float(np.max(np.abs(pad(served) - pad(ranked)))) if n else 0.0
    score_err = max(float(err.max()) if len(err) else 0.0, rank_gap)
    score_median = float(np.median(err)) if len(err) else 0.0

    ok = found.copy()
    ok[found] = fg
    e = enc.detach().cpu().numpy()
    ref_boxes = ref.decode(e[k[ok], c[ok]], c[ok],
                           kp[k[ok]].astype(np.float64), config)
    gaps = box_gaps(b[ok], ref_boxes)
    box_err = float(gaps.max()) if len(gaps) else 0.0
    box_median = float(np.median(gaps)) if len(gaps) else 0.0
    return {"score_err": score_err, "box_err": box_err,
            "score_median": score_median, "box_median": box_median}


def judge_nms(hyps, dets, config):
    """``nms_err`` of one frame: the reference merge-NMS of the served
    hypotheses against the served detections ``dets = (classes, boxes,
    scores)``."""
    scores, cls, boxes, _ = (np.asarray(a) for a in hyps)
    r_cls, r_boxes, r_scores = reference_nms(scores, cls, boxes, config)
    d_cls, d_boxes, d_scores = (np.asarray(a) for a in dets)
    if len(d_cls) != len(r_cls) or not np.array_equal(
            np.asarray(d_cls, np.int64), np.asarray(r_cls, np.int64)):
        return 1.0
    return max(_rel_gap(d_boxes, r_boxes), _rel_gap(d_scores, r_scores))


def judge_frames(frames, config, max_hypotheses):
    """``(numbers, detail)`` over ``frames = [(hyps, dets, graph, {reference:
    (probs, enc)}), ...]``: each network number is its worst over the
    frames against the reference nearer in that number; ``detail`` has
    each reference's worst numbers.  ``dets`` None leaves the frame's
    NMS unjudged (``nms_err`` 0 where no frame's is judged)."""
    per_ref = {}
    nms = []
    for hyps, dets, graph, outs in frames:
        for name, (probs, enc) in outs.items():
            per_ref.setdefault(name, []).append(judge_network(
                hyps, graph, probs, enc, config, max_hypotheses))
        if dets is not None:
            nms.append(judge_nms(hyps, dets, config))
    detail = {name: worst(rows, NETWORK) for name, rows in per_ref.items()}
    numbers = {n: min(d[n] for d in detail.values()) for n in NETWORK}
    numbers["nms_err"] = max(nms, default=0.0)
    return numbers, detail


def worst(per_frame, names):
    """The worst of each number of ``names`` over frames."""
    return {name: max(f[name] for f in per_frame) for name in names}


def verdict(numbers, limits):
    """True where every number is at or under its limit."""
    return all(np.isfinite(numbers[n]) and numbers[n] <= limits[n]
               for n in NUMBERS)
