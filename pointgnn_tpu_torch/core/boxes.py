"""7-DoF 3D box geometry in KITTI camera coordinates (numpy).

Copy of the parts of :mod:`pointgnn_tpu.core.boxes` that serving,
label packing, augmentation and crop-paste augmentation need.
A box is ``(x, y, z, l, h, w, yaw)``: center of the bottom face at
``(x, y, z)`` (camera frame: x right, y down, z forward), length ``l``
along the heading axis, height ``h``, width ``w``, ``yaw`` about y.
The matmul forms (not einsum) keep the results bitwise equal to the
JAX package's host code.
"""

from typing import Dict, Tuple

import numpy as np

# Unit-box corner template in the box frame before yaw rotation:
# (l/2 sign, w/2 sign) for the 4 top corners, repeated at the bottom.
_CORNER_XZ = np.array(
    [[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=np.float64
)


def yaw_rotation(yaw: np.ndarray) -> np.ndarray:
    """Rotation matrices about the camera y axis. [..., 3, 3]."""
    yaw = np.asarray(yaw)
    c, s = np.cos(yaw), np.sin(yaw)
    zeros = np.zeros_like(c)
    ones = np.ones_like(c)
    return np.stack(
        [
            np.stack([c, zeros, s], axis=-1),
            np.stack([zeros, ones, zeros], axis=-1),
            np.stack([-s, zeros, c], axis=-1),
        ],
        axis=-2,
    )


def boxes_to_corners(
    boxes: np.ndarray, expand: Tuple[float, float, float] = (1.0, 1.0, 1.0)
) -> np.ndarray:
    """``[N, 7]`` boxes -> ``[N, 8, 3]`` corners: top face at ``y``,
    bottom face at ``y - h``; ``expand=(f0, f1, f2)`` grows height
    symmetrically and scales width/length."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 7)
    x, y, z, l, h, w, yaw = [boxes[:, i] for i in range(7)]
    f0, f1, f2 = expand
    dh = h * (f0 - 1.0)
    w = w * f1
    l = l * f2
    cx = np.concatenate([_CORNER_XZ[:, 0], _CORNER_XZ[:, 0]])[None, :]
    cz = np.concatenate([_CORNER_XZ[:, 1], _CORNER_XZ[:, 1]])[None, :]
    local_x = cx * (l[:, None] / 2.0)
    local_z = cz * (w[:, None] / 2.0)
    top_y = (dh / 2.0)[:, None] * np.ones((1, 4))
    bot_y = (-h - dh / 2.0)[:, None] * np.ones((1, 4))
    local_y = np.concatenate([top_y, bot_y], axis=1)
    local = np.stack([local_x, local_y, local_z], axis=-1)
    rot = yaw_rotation(yaw)
    rotated = np.matmul(local, rot.transpose(0, 2, 1))
    centers = np.stack([x, y, z], axis=-1)[:, None, :]
    return rotated + centers


def box_to_corners(box, expand=(1.0, 1.0, 1.0)) -> np.ndarray:
    """Single-box convenience wrapper -> [8, 3]."""
    return boxes_to_corners(np.asarray(box)[None, :], expand)[0]


def boxes_to_normals(
    boxes: np.ndarray, expand: Tuple[float, float, float] = (1.0, 1.0, 1.0)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(normals [N,3,3], lower [N,3], upper [N,3])``: a point ``p`` is
    inside box ``i`` iff ``lower[i] < normals[i] @ p < upper[i]``."""
    corners = boxes_to_corners(boxes, expand)
    wx = corners[:, 0, :] - corners[:, 4, :]
    wy = corners[:, 0, :] - corners[:, 1, :]
    wz = corners[:, 0, :] - corners[:, 3, :]
    normals = np.stack([wx, wy, wz], axis=1)
    lo_pts = np.stack(
        [corners[:, 4, :], corners[:, 1, :], corners[:, 3, :]], axis=1
    )
    hi_pts = np.stack(
        [corners[:, 0, :], corners[:, 0, :], corners[:, 0, :]], axis=1
    )
    lower = np.matmul(normals[:, :, None, :], lo_pts[:, :, :, None])[
        :, :, 0, 0
    ]
    upper = np.matmul(normals[:, :, None, :], hi_pts[:, :, :, None])[
        :, :, 0, 0
    ]
    return normals, lower, upper


def points_in_boxes(
    xyz: np.ndarray,
    boxes: np.ndarray,
    expand: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """Boolean mask [N_boxes, N_points]: strict interior test."""
    normals, lower, upper = boxes_to_normals(boxes, expand)
    projected = np.matmul(
        np.asarray(xyz, np.float64)[None, :, :], normals.transpose(0, 2, 1)
    )
    inside = (projected > lower[:, None, :]) & (projected < upper[:, None, :])
    return inside.all(axis=-1)


def points_in_box(xyz, box, expand=(1.0, 1.0, 1.0)) -> np.ndarray:
    """[N_points] mask for one box."""
    return points_in_boxes(xyz, np.asarray(box)[None, :], expand)[0]


def points_in_box_bev(xyz, box, expand=(1.0, 1.0, 1.0)) -> np.ndarray:
    """[N_points] mask of 2D (width/length plane) containment: the test
    of :func:`points_in_boxes` without the height-spanning normal."""
    normals, lower, upper = boxes_to_normals(np.asarray(box)[None, :], expand)
    normals, lower, upper = normals[0, 1:], lower[0, 1:], upper[0, 1:]
    projected = np.asarray(xyz, np.float64) @ normals.T
    inside = (projected > lower) & (projected < upper)
    return inside.all(axis=-1)


def label_to_box(label: Dict) -> np.ndarray:
    """KITTI label dict -> [7] box array (x, y, z, l, h, w, yaw)."""
    return np.array(
        [
            label["x3d"],
            label["y3d"],
            label["z3d"],
            label["length"],
            label["height"],
            label["width"],
            label["yaw"],
        ],
        dtype=np.float64,
    )


def box_to_label(box: np.ndarray) -> Dict:
    """[7] box -> the geometry keys of a KITTI label dict."""
    x, y, z, l, h, w, yaw = [float(v) for v in np.asarray(box).reshape(7)]
    return {
        "x3d": x,
        "y3d": y,
        "z3d": z,
        "length": l,
        "height": h,
        "width": w,
        "yaw": yaw,
    }


def normalize_yaw(yaw: float) -> float:
    """Fold yaw into [-pi/4, 3*pi/4) as the label assigners do."""
    while yaw < -0.25 * np.pi:
        yaw += np.pi
    while yaw > 0.75 * np.pi:
        yaw -= np.pi
    return yaw
