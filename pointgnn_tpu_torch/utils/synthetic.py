"""Synthetic KITTI-like LiDAR frames (copy of
:mod:`pointgnn_tpu.utils.synthetic`; the same seed gives the same frame
in both packages).

Emulates a spinning LiDAR over a ground plane with parked "car" boxes,
cropped to a forward camera frustum, in camera coordinates (x right,
y down, z forward).
"""

from typing import List, Tuple

import numpy as np

from pointgnn_tpu_torch.core.points import Points


def synthetic_lidar_frame(
    seed: int = 0,
    n_beams: int = 64,
    points_per_beam: int = 1400,
    max_range: float = 70.0,
    n_cars: int = 8,
) -> Tuple[Points, List[dict]]:
    """Returns (Points in camera coords with intensity+rgb attr, labels)."""
    rng = np.random.RandomState(seed)
    # beam elevations from -24.9deg to +2deg (KITTI HDL-64 like)
    elev = np.linspace(-24.9, 2.0, n_beams) * np.pi / 180.0
    azim = rng.uniform(-0.7, 0.7, (n_beams, points_per_beam))
    ee = np.repeat(elev[:, None], points_per_beam, 1)
    # ground-plane intersection range (sensor 1.73 m above ground)
    h = 1.73
    with np.errstate(divide="ignore"):
        ground_r = np.where(ee < -0.005, h / np.tan(-ee), max_range)
    r = np.minimum(ground_r, max_range) * (
        1.0 + rng.randn(n_beams, points_per_beam) * 0.01
    )
    # velodyne-style coords: x forward, y left, z up
    x = (r * np.cos(ee) * np.cos(azim)).ravel()
    y = (r * np.cos(ee) * np.sin(azim)).ravel()
    z = (r * np.sin(ee)).ravel()

    labels = []
    for _ in range(n_cars):
        cx = rng.uniform(5, 50)
        cy = rng.uniform(-12, 12)
        yaw = rng.uniform(-np.pi, np.pi)
        l, w, hh = 3.9 + rng.randn() * 0.3, 1.6, 1.5
        # carve points: re-target a slab of ground points onto the box
        d = np.hypot(x - cx, y - cy)
        nz = np.flatnonzero(d < max(l, w) / 2)
        if len(nz):
            z[nz] = rng.uniform(-h, -h + hh, len(nz))
        labels.append(
            {
                "name": "Car",
                "x3d": -cy, "y3d": 0.1, "z3d": cx,  # cam coords
                "length": l, "width": w, "height": hh, "yaw": yaw,
                "truncation": 0.0, "occlusion": 0,
                "alpha": 0, "xmin": 0, "ymin": 0, "xmax": 100, "ymax": 100,
            }
        )

    # frustum crop (forward, +-40deg) then convert to camera coords:
    # cam x = -velo y, cam y = -velo z, cam z = velo x
    keep = (x > 1.0) & (np.abs(np.arctan2(y, x)) < 0.7)
    cam = np.stack([-y[keep], -z[keep], x[keep]], axis=1).astype(np.float32)
    intensity = rng.rand(len(cam), 1).astype(np.float32)
    rgb = rng.rand(len(cam), 3).astype(np.float32)
    return Points(xyz=cam, attr=np.hstack([intensity, rgb])), labels
