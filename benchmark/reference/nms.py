"""Plain reference of Point-GNN's merge-NMS (numpy).

Greedy non-maximum suppression over rotated 3D boxes, as in
WeijingShi/Point-GNN ``nms_boxes_3d_uncertainty``: boxes in decreasing
score order; a kept box removes every later box of its class whose 3D
overlap exceeds the threshold; with ``merge`` the kept box becomes the
elementwise median of itself and the boxes it removed; with ``rescore``
its score grows by the removed scores weighted by their overlap with the
merged box.  The overlap is the BEV polygon intersection (convex
clipping) times the shared height, over the union, with the intersection
volume cast to float32 as the reference code does.

The clipping runs vectorized over all the candidate boxes of one kept
box.  ``dtype`` is float64 (the precision served) or float32 (the
control).
"""

import numpy as np

_SX = np.array([1, 1, -1, -1], np.float64)
_SZ = np.array([1, -1, -1, 1], np.float64)


def corners(boxes, dtype=np.float64):
    """``[N, 7]`` boxes -> ``[N, 8, 3]`` corners (top face first: rows
    0-3 at ``y``, rows 4-7 at ``y - h``)."""
    b = np.asarray(boxes, dtype).reshape(-1, 7)
    x, y, z, l, h, w, yaw = (b[:, i:i + 1] for i in range(7))
    lx = np.concatenate([_SX, _SX]).astype(dtype)[None, :] * (l / 2)
    lz = np.concatenate([_SZ, _SZ]).astype(dtype)[None, :] * (w / 2)
    ly = np.concatenate([np.zeros((len(b), 4), dtype),
                         np.repeat(-h, 4, axis=1)], axis=1)
    c, s = np.cos(yaw), np.sin(yaw)
    cx = c * lx + s * lz + x
    cz = -s * lx + c * lz + z
    cy = ly + y
    return np.stack([cx, cy, cz], axis=-1)


def _area(poly, count):
    """Shoelace area of polygons ``[M, V, 2]`` with ``count`` vertices."""
    v = poly.shape[1]
    idx = np.arange(v)[None, :]
    nxt = (idx + 1) % np.maximum(count[:, None], 1)
    q = np.take_along_axis(poly, nxt[..., None], axis=1)
    term = poly[..., 0] * q[..., 1] - q[..., 0] * poly[..., 1]
    term = np.where(idx < count[:, None], term, 0)
    return 0.5 * np.abs(term.sum(axis=1))


def _clip(subject, count, clip):
    """Clip convex polygons ``subject [M, V, 2]`` by one convex quad."""
    a0, a1, a2 = clip[0], clip[1], clip[2]
    if (a1[0] - a0[0]) * (a2[1] - a1[1]) - (a1[1] - a0[1]) * (a2[0] - a1[0]) < 0:
        clip = clip[::-1]
    for e in range(4):
        if subject.shape[1] == 0:
            break
        a, b = clip[e], clip[(e + 1) % 4]
        ex, ez = b[0] - a[0], b[1] - a[1]
        v = subject.shape[1]
        idx = np.arange(v)[None, :]
        valid = idx < count[:, None]
        nxt = (idx + 1) % np.maximum(count[:, None], 1)
        w = np.take_along_axis(subject, nxt[..., None], axis=1)
        d = ex * (subject[..., 1] - a[1]) - ez * (subject[..., 0] - a[0])
        dn = ex * (w[..., 1] - a[1]) - ez * (w[..., 0] - a[0])
        inside = d >= 0
        denom = d - dn
        cross = valid & (inside != (dn >= 0)) & (denom != 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(cross, d / np.where(denom == 0, 1, denom), 0)
        p = subject + t[..., None] * (w - subject)
        pts = np.stack([subject, p], axis=2).reshape(len(subject), 2 * v, 2)
        ok = np.stack([valid & inside, cross], axis=2).reshape(len(subject),
                                                               2 * v)
        order = np.argsort(~ok, axis=1, kind="stable")
        count = ok.sum(axis=1)
        width = int(count.max()) if len(count) else 0
        subject = np.take_along_axis(pts, order[..., None], axis=1)[:, :width]
    return subject, count


def _boxes_near(hi1, lo1, hi2, lo2):
    """Whether axis-aligned extents overlap on every axis."""
    return ~np.any((hi1 < lo2) | (lo1 > hi2), axis=-1)


def overlaps(one, many, dtype=np.float64):
    """3D overlap of corners ``one [8, 3]`` with each of ``many [M, 8, 3]``."""
    out = np.zeros(len(many), dtype)
    if len(many) == 0:
        return out
    hi1, lo1 = one.max(axis=0), one.min(axis=0)
    hi2, lo2 = many.max(axis=1), many.min(axis=1)
    sel = np.flatnonzero(_boxes_near(hi1, lo1, hi2, lo2))
    if len(sel) == 0:
        return out
    poly1 = one[:4][:, [0, 2]]
    poly2 = many[sel][:, :4][:, :, [0, 2]]
    four = np.full(len(sel), 4)
    inter, n_inter = _clip(poly2, four, poly1)
    shared = np.where(n_inter >= 3, _area(inter, n_inter), 0).astype(dtype)
    area1 = _area(poly1[None], np.array([4]))[0]
    area2 = _area(poly2, four)
    shared_y = np.minimum(hi2[sel, 1], hi1[1]) - np.maximum(lo2[sel, 1], lo1[1])
    inter_v = shared_y * shared
    union = (hi2[sel, 1] - lo2[sel, 1]) * area2 + (hi1[1] - lo1[1]) * area1
    out[sel] = inter_v.astype(np.float32) / (union - inter_v)
    return out


def merge_nms(classes, boxes, scores, threshold, merge=True, rescore=True,
              dtype=np.float64):
    """``(classes, boxes, scores)`` of the kept boxes, best first.

    A box can only remove a later box of its class whose axis-aligned
    extent meets its own (the overlap is 0 otherwise), so those pairs are
    found once for all boxes before the greedy pass."""
    scores = np.asarray(scores, dtype)
    order = np.argsort(-scores)
    classes = np.asarray(classes)[order]
    scores = scores[order].copy()
    boxes = np.asarray(boxes, dtype)[order].copy()
    n = len(scores)
    if n == 0:
        return classes, boxes, scores
    box_corners = corners(boxes, dtype)
    hi, lo = box_corners.max(axis=1), box_corners.min(axis=1)
    near = _boxes_near(hi[:, None], lo[:, None], hi[None], lo[None])
    near &= classes[:, None] == classes[None, :]
    near &= np.triu(np.ones((n, n), bool), k=1)
    keep = np.ones(n, bool)
    for i in np.flatnonzero(near.any(axis=1)):
        if not keep[i]:
            continue
        rest = np.flatnonzero(near[i] & keep)
        if len(rest) == 0:
            continue
        ov = overlaps(box_corners[i], box_corners[rest], dtype)
        removed = rest[ov > threshold]
        if merge:
            boxes[i] = np.median(np.concatenate([boxes[removed], boxes[[i]]]),
                                 axis=0)
        if rescore and len(removed):
            mo = overlaps(corners(boxes[[i]], dtype)[0], box_corners[removed],
                          dtype)
            scores[i] += dtype(np.sum(scores[removed] * mo))
        keep[removed] = False
    return classes[keep], boxes[keep], scores[keep]
