"""Rotated-box 3D overlap (copy of the exact backend of
:mod:`pointgnn_tpu.postprocess.iou`): BEV polygon intersection by
Sutherland-Hodgman clipping times the height overlap::

    intersection = shared_y * bev_shared_area
    union        = (y_max-y_min) * area2 + (y0_max-y0_min) * area1
    overlap      = intersection / (union - intersection)

and the legacy rasterized approximation of the same overlap
(:func:`overlapped_boxes_3d_rasterized`), which counts the pixels of the
two footprints drawn on a shared canvas.  The JAX package fills them
with ``cv2.fillPoly`` when OpenCV imports and with its scanline
``_fill_convex_quad`` otherwise; the port has only the scanline fill.
"""

import numpy as np


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of an (N, 2) polygon (sign-free)."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))
    )


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Clip convex ``subject`` by convex ``clip`` ((N, 2) vertices)."""
    def cross2(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    # counter-clockwise clip polygon so "inside" is a fixed side
    if cross2(clip[1] - clip[0], clip[2] - clip[1]) < 0:
        clip = clip[::-1]
    output = subject
    for i in range(len(clip)):
        if len(output) == 0:
            break
        a, b = clip[i], clip[(i + 1) % len(clip)]
        d = cross2(b - a, output - a)  # >0 strictly inside
        next_d = np.roll(d, -1)
        next_v = np.roll(output, -1, axis=0)
        new_pts = []
        for j in range(len(output)):
            if d[j] >= 0:
                new_pts.append(output[j])
            if (d[j] >= 0) != (next_d[j] >= 0):
                denom = d[j] - next_d[j]
                if denom != 0:
                    t = d[j] / denom
                    new_pts.append(output[j] + t * (next_v[j] - output[j]))
        output = np.array(new_pts) if new_pts else np.zeros((0, 2))
    return output


def rect_intersection_area(poly1: np.ndarray, poly2: np.ndarray) -> float:
    """Area of the intersection of two convex (N, 2) polygons."""
    inter = clip_polygon(poly1, poly2)
    if len(inter) < 3:
        return 0.0
    return polygon_area(inter)


def overlapped_boxes_3d(single_box: np.ndarray, box_list: np.ndarray) -> np.ndarray:
    """Overlap of one box against a list, all given as (8, 3) corners;
    the first four corner rows are the top face whose (x, z) columns
    form the BEV footprint."""
    box_list = np.asarray(box_list)
    if len(box_list) == 0:
        return np.zeros(0)
    single_max = np.max(single_box, axis=0)
    single_min = np.min(single_box, axis=0)
    y0_max, y0_min = single_max[1], single_min[1]
    max_corner = np.max(box_list, axis=1)
    min_corner = np.min(box_list, axis=1)
    non_overlap = np.any(
        (single_max < min_corner) | (single_min > max_corner), axis=1
    )
    poly1 = single_box[:4][:, [0, 2]]
    area1 = polygon_area(poly1)
    overlap = np.zeros(len(box_list))
    for i in np.flatnonzero(~non_overlap):
        poly2 = box_list[i][:4][:, [0, 2]]
        shared_area = rect_intersection_area(poly1, poly2)
        area2 = polygon_area(poly2)
        y_max, y_min = max_corner[i, 1], min_corner[i, 1]
        shared_y = min(y_max, y0_max) - max(y_min, y0_min)
        intersection = shared_y * shared_area
        union = (y_max - y_min) * area2 + (y0_max - y0_min) * area1
        overlap[i] = np.float32(intersection) / (union - intersection)
    return overlap


# the reference's fast-poly name; the same exact geometry
overlapped_boxes_3d_fast_poly = overlapped_boxes_3d


def _fill_convex_quad(buf: np.ndarray, quad: np.ndarray) -> None:
    """Rasterize a convex integer quad into ``buf`` (rows = z, cols = x):
    each row covers the span between the polygon's edge crossings,
    endpoints rounded and included."""
    n = len(quad)
    zs = quad[:, 1]
    z_lo = max(int(np.min(zs)), 0)
    z_hi = min(int(np.max(zs)), buf.shape[0] - 1)
    for z in range(z_lo, z_hi + 1):
        xs = []
        for j in range(n):
            (x0, z0), (x1, z1) = quad[j], quad[(j + 1) % n]
            if z0 == z1:
                if z == z0:
                    xs.extend([x0, x1])
                continue
            lo, hi = (z0, z1) if z0 < z1 else (z1, z0)
            if lo <= z <= hi:
                xs.append(x0 + (x1 - x0) * (z - z0) / (z1 - z0))
        if not xs:
            continue
        x_lo = max(int(round(min(xs))), 0)
        x_hi = min(int(round(max(xs))), buf.shape[1] - 1)
        if x_hi >= x_lo:
            buf[z, x_lo:x_hi + 1] = 1


def overlapped_boxes_3d_rasterized(
    single_box: np.ndarray, box_list: np.ndarray
) -> np.ndarray:
    """Legacy rasterized approximate overlap.

    Expects integer-quantized corners (``nms.nms_boxes_3d`` multiplies
    them by ``appr_factor`` and truncates to int32): both BEV footprints are
    filled into pixel buffers anchored at their joint bounding-box
    minimum, and the overlap is computed from pixel counts, an
    ``appr_factor``-controlled approximation of the exact polygon IoU.
    """
    box_list = np.asarray(box_list)
    if len(box_list) == 0:
        return np.zeros(0)
    single_box = np.asarray(single_box)
    single_max = np.max(single_box, axis=0)
    single_min = np.min(single_box, axis=0)
    x0_max, y0_max, z0_max = single_max
    x0_min, y0_min, z0_min = single_min
    max_corner = np.max(box_list, axis=1)
    min_corner = np.min(box_list, axis=1)
    non_overlap = np.any(
        (single_max < min_corner) | (single_min > max_corner), axis=1
    )
    overlap = np.zeros(len(box_list))
    quad1 = single_box[:4][:, [0, 2]]
    for i in np.flatnonzero(~non_overlap):
        box = box_list[i]
        x_max, y_max, z_max = max_corner[i]
        x_min, y_min, z_min = min_corner[i]
        offset = np.array(
            [min(x0_min, x_min), min(z0_min, z_min)], dtype=np.int64
        )
        w = int(max(x0_max, x_max) - offset[0])
        h = int(max(z0_max, z_max) - offset[1])
        if w <= 0 or h <= 0:
            continue
        buf1 = np.zeros((h, w), dtype=np.int32)
        buf2 = np.zeros_like(buf1)
        _fill_convex_quad(buf1, (quad1 - offset).astype(np.int32))
        _fill_convex_quad(buf2, (box[:4][:, [0, 2]] - offset).astype(np.int32))
        shared_area = int(np.count_nonzero(buf1 * buf2))
        area1 = int(np.count_nonzero(buf1))
        area2 = int(np.count_nonzero(buf2))
        shared_y = min(y_max, y0_max) - max(y_min, y0_min)
        intersection = shared_y * shared_area
        union = (y_max - y_min) * area2 + (y0_max - y0_min) * area1
        overlap[i] = np.float32(intersection) / (union - intersection)
    return overlap
