"""Frozen copy of ``pointgnn_tpu_torch.utils.synthetic.synthetic_lidar_frame``.

A spinning 64-beam LiDAR over a ground plane with parked cars carved
into it, cropped to the forward camera frustum (+-40 degrees), in camera
coordinates (x right, y down, z forward).  The benchmark keeps its own
copy so that a change to the program cannot change the traffic.  The
same seed gives the same frame as the program's generator.
"""

import numpy as np


def synthetic_lidar_frame(seed=0, n_beams=64, points_per_beam=1400,
                          max_range=70.0, n_cars=8):
    """Returns ``(xyz [N, 3] float32, attr [N, 4] float32, labels)``:
    camera coordinates, intensity + rgb, and the carved cars."""
    rng = np.random.RandomState(seed)
    elev = np.linspace(-24.9, 2.0, n_beams) * np.pi / 180.0
    azim = rng.uniform(-0.7, 0.7, (n_beams, points_per_beam))
    ee = np.repeat(elev[:, None], points_per_beam, 1)
    h = 1.73
    with np.errstate(divide="ignore"):
        ground_r = np.where(ee < -0.005, h / np.tan(-ee), max_range)
    r = np.minimum(ground_r, max_range) * (
        1.0 + rng.randn(n_beams, points_per_beam) * 0.01
    )
    x = (r * np.cos(ee) * np.cos(azim)).ravel()
    y = (r * np.cos(ee) * np.sin(azim)).ravel()
    z = (r * np.sin(ee)).ravel()

    labels = []
    for _ in range(n_cars):
        cx = rng.uniform(5, 50)
        cy = rng.uniform(-12, 12)
        yaw = rng.uniform(-np.pi, np.pi)
        l, w, hh = 3.9 + rng.randn() * 0.3, 1.6, 1.5
        d = np.hypot(x - cx, y - cy)
        nz = np.flatnonzero(d < max(l, w) / 2)
        if len(nz):
            z[nz] = rng.uniform(-h, -h + hh, len(nz))
        labels.append({"name": "Car", "x3d": -cy, "y3d": 0.1, "z3d": cx,
                       "length": l, "width": w, "height": hh, "yaw": yaw})

    keep = (x > 1.0) & (np.abs(np.arctan2(y, x)) < 0.7)
    cam = np.stack([-y[keep], -z[keep], x[keep]], axis=1).astype(np.float32)
    intensity = rng.rand(len(cam), 1).astype(np.float32)
    rgb = rng.rand(len(cam), 3).astype(np.float32)
    return cam, np.hstack([intensity, rgb]), labels
