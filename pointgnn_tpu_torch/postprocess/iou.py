"""Rotated-box 3D overlap (copy of the exact backend of
:mod:`pointgnn_tpu.postprocess.iou`): BEV polygon intersection by
Sutherland-Hodgman clipping times the height overlap::

    intersection = shared_y * bev_shared_area
    union        = (y_max-y_min) * area2 + (y0_max-y0_min) * area1
    overlap      = intersection / (union - intersection)
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
        inter = clip_polygon(poly1, poly2)
        shared_area = polygon_area(inter) if len(inter) >= 3 else 0.0
        area2 = polygon_area(poly2)
        y_max, y_min = max_corner[i, 1], min_corner[i, 1]
        shared_y = min(y_max, y0_max) - max(y_min, y0_min)
        intersection = shared_y * shared_area
        union = (y_max - y_min) * area2 + (y0_max - y0_min) * area1
        overlap[i] = np.float32(intersection) / (union - intersection)
    return overlap
