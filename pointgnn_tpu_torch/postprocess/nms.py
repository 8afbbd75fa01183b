"""Greedy 3D NMS with box merging and overlap-weighted rescoring
(copy of :mod:`pointgnn_tpu.postprocess.nms`).

Boxes are processed in decreasing score order; pairwise overlaps use
the original corners; with ``merge`` overlapped same-class boxes are
replaced by their elementwise median (including the kept box); with
``rescore`` the kept score grows by the removed scores weighted by
their overlap with the merged box.

With the default overlap, :func:`iou.overlapped_boxes_3d`, the greedy
loop runs natively (``csrc/host/nms.cpp`` through
:mod:`postprocess.native`, which raises if it cannot be built); any
other ``overlapped_fn`` runs the numpy loop, the plain version the tests
hold the native one against.  The native loop computes the original
boxes' corners itself, with :func:`boxes_3d_to_corners`'s arithmetic
(:func:`native.box_corners`), so the Python around it is the score
sort and the gather of the kept boxes; the quantized variant
(:func:`nms_boxes_3d`) rounds numpy's corners and hands them to it, and
the numpy loop computes its corners with numpy.  The native loop takes
each survivor's candidates from a grid over the boxes' x-z bounds: a
pair whose axis-aligned bounds do not meet overlaps by 0.0, which no
threshold >= 0 exceeds, so only pairs whose bounds meet are tested (a
negative threshold tests every pair).  It tests them in index order with
the same arithmetic as the JAX package's native loop, and equals it bit
for bit.  ``counters``, a dict, gets the native loop's counts added to
it (:func:`native.greedy_nms`); the numpy loop leaves it as it is.
"""

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.postprocess import iou, native


def boxes_3d_to_corners(boxes_3d: np.ndarray) -> np.ndarray:
    """[N, 7] -> [N, 8, 3] corners."""
    return box_ops.boxes_to_corners(boxes_3d)


def bboxes_sort(classes, scores, bboxes, top_k=400, attributes=None):
    """Sort by decreasing score, keep top_k (<=0 disables the cap)."""
    order = np.argsort(-scores)
    if top_k > 0:
        order = order[:top_k]
    attributes = attributes[order] if attributes is not None else None
    return classes[order], scores[order], bboxes[order], attributes


def _greedy_nms(classes, scores, bboxes, nms_threshold, overlapped_fn,
                merge, rescore, quantize_factor=None, counters=None):
    if overlapped_fn is iou.overlapped_boxes_3d:
        corners = None  # the native loop computes them
        if quantize_factor is not None:
            corners = np.int32(boxes_3d_to_corners(bboxes)
                               * quantize_factor).astype(np.float64)
        keep, scores, bboxes, counts = native.greedy_nms(
            bboxes, corners, classes, scores, nms_threshold, merge, rescore)
        if counters is not None:
            for key, val in counts.items():
                counters[key] = counters.get(key, 0) + val
        return keep, scores, bboxes
    bboxes = np.array(bboxes, dtype=np.float64, copy=True)
    scores = np.array(scores, copy=True)
    corners = boxes_3d_to_corners(bboxes)
    if quantize_factor is not None:
        corners = np.int32(corners * quantize_factor).astype(np.float64)
    n = len(scores)
    keep = np.ones(n, dtype=bool)
    for i in range(n - 1):
        if not keep[i]:
            continue
        rest = np.arange(i + 1, n)[keep[i + 1:]]
        if len(rest) == 0:
            continue
        overlap = overlapped_fn(corners[i], corners[rest])
        removed = rest[(overlap > nms_threshold) & (classes[rest] == classes[i])]
        if merge:
            group = np.concatenate([bboxes[removed], bboxes[[i]]], axis=0)
            bboxes[i] = np.median(group, axis=0)
        if rescore and len(removed) > 0:
            merged_corners = boxes_3d_to_corners(bboxes[[i]])[0]
            merged_overlap = overlapped_fn(merged_corners, corners[removed])
            scores[i] += float(np.sum(scores[removed] * merged_overlap))
        keep[removed] = False
    return keep, scores, bboxes


def _nms(class_labels, detection_boxes_3d, detection_scores,
         overlapped_thres, overlapped_fn, appr_factor, top_k, attributes,
         merge, rescore, quantize=False, counters=None):
    classes, scores, bboxes, attributes = bboxes_sort(
        class_labels, detection_scores, detection_boxes_3d, top_k=top_k,
        attributes=attributes,
    )
    if len(scores) == 0:
        return classes, bboxes, scores, attributes
    keep, scores, bboxes = _greedy_nms(
        classes, scores, bboxes, overlapped_thres, overlapped_fn,
        merge, rescore, appr_factor if quantize else None, counters,
    )
    attributes = attributes[keep] if attributes is not None else None
    return classes[keep], bboxes[keep], scores[keep], attributes


def nms_boxes_3d(class_labels, detection_boxes_3d, detection_scores,
                 overlapped_thres=0.5, overlapped_fn=iou.overlapped_boxes_3d,
                 appr_factor=10.0, top_k=-1, attributes=None,
                 counters=None):
    """Plain suppression over appr_factor-quantized corners."""
    return _nms(class_labels, detection_boxes_3d, detection_scores,
                overlapped_thres, overlapped_fn, appr_factor, top_k,
                attributes, merge=False, rescore=False, quantize=True,
                counters=counters)


def nms_boxes_3d_uncertainty(class_labels, detection_boxes_3d,
                             detection_scores, overlapped_thres=0.5,
                             overlapped_fn=iou.overlapped_boxes_3d,
                             appr_factor=10.0, top_k=-1, attributes=None,
                             counters=None):
    """Median merge + overlap-weighted rescoring (the default)."""
    return _nms(class_labels, detection_boxes_3d, detection_scores,
                overlapped_thres, overlapped_fn, appr_factor, top_k,
                attributes, merge=True, rescore=True, counters=counters)


def nms_boxes_3d_merge_only(class_labels, detection_boxes_3d,
                            detection_scores, overlapped_thres=0.5,
                            overlapped_fn=iou.overlapped_boxes_3d,
                            appr_factor=10.0, top_k=-1, attributes=None,
                            counters=None):
    """Median merge without rescoring."""
    return _nms(class_labels, detection_boxes_3d, detection_scores,
                overlapped_thres, overlapped_fn, appr_factor, top_k,
                attributes, merge=True, rescore=False, counters=counters)


def nms_boxes_3d_score_only(class_labels, detection_boxes_3d,
                            detection_scores, overlapped_thres=0.5,
                            overlapped_fn=iou.overlapped_boxes_3d,
                            appr_factor=10.0, top_k=-1, attributes=None,
                            counters=None):
    """Rescoring without merging."""
    return _nms(class_labels, detection_boxes_3d, detection_scores,
                overlapped_thres, overlapped_fn, appr_factor, top_k,
                attributes, merge=False, rescore=True, counters=counters)


def get_nms_fn(box_merge: bool = True, box_score: bool = True):
    """Select the NMS variant from the merge and rescore switches."""
    if box_merge and box_score:
        return nms_boxes_3d_uncertainty
    if box_merge:
        return nms_boxes_3d_merge_only
    if box_score:
        return nms_boxes_3d_score_only
    return nms_boxes_3d
