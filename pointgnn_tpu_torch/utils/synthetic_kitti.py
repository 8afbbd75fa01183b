"""Synthetic KITTI directory trees (the port's copy of
``tools/make_synthetic_kitti.py``).

The same layout (``image/<split>/image_2``, ``velodyne/<split>/velodyne``,
``calib/<split>/calib``, ``labels/training/label_2`` and
``3DOP_splits/``), the same calibration text, label lines and frames
from the same seed, with the images written by
:func:`pointgnn_tpu_torch.data.png.write_png` instead of OpenCV or PIL,
so it also runs where neither is installed.  ``n_ground`` sets the
ground points per frame (12000 in the tool).

    python -m pointgnn_tpu_torch.utils.synthetic_kitti <out_dir> [num_frames]
"""

import os

import numpy as np

from pointgnn_tpu_torch.data.png import write_png

CALIB_TEXT = """\
P0: 7.070493000000e+02 0.000000000000e+00 6.040814000000e+02 0.000000000000e+00 0.000000000000e+00 7.070493000000e+02 1.805066000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P1: 7.070493000000e+02 0.000000000000e+00 6.040814000000e+02 -3.797842000000e+02 0.000000000000e+00 7.070493000000e+02 1.805066000000e+02 0.000000000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 0.000000000000e+00
P2: 7.070493000000e+02 0.000000000000e+00 6.040814000000e+02 4.575831000000e+01 0.000000000000e+00 7.070493000000e+02 1.805066000000e+02 -3.454157000000e-01 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 4.981016000000e-03
P3: 7.070493000000e+02 0.000000000000e+00 6.040814000000e+02 -3.341081000000e+02 0.000000000000e+00 7.070493000000e+02 1.805066000000e+02 2.330660000000e+00 0.000000000000e+00 0.000000000000e+00 1.000000000000e+00 3.201153000000e-03
R0_rect: 9.999128000000e-01 1.009263000000e-02 -8.511932000000e-03 -1.012729000000e-02 9.999406000000e-01 -4.037671000000e-03 8.470675000000e-03 4.123522000000e-03 9.999556000000e-01
Tr_velo_to_cam: 6.927964000000e-03 -9.999722000000e-01 -2.757829000000e-03 -2.457729000000e-02 -1.162982000000e-03 2.749836000000e-03 -9.999955000000e-01 -6.127237000000e-02 9.999753000000e-01 6.931141000000e-03 -1.143899000000e-03 -3.321029000000e-01
"""


# (l, h, w, points-per-cluster) per KITTI class; ped/cyc use the
# dataset's typical dimensions (the dataset's box medians)
OBJECT_DIMS = {
    "Car": (4.0, 1.60, 1.80, 400),
    "Pedestrian": (0.80, 1.75, 0.60, 140),
    "Cyclist": (1.76, 1.73, 0.60, 180),
}


def make_frame(rng, n_ground=12000, objects=()):
    """Velodyne-frame points: ground plane + per-class object clusters.

    ``objects`` is a list of ``(class_name, x_velo, y_velo)``."""
    pts = np.zeros((n_ground, 4), dtype=np.float32)
    pts[:, 0] = rng.uniform(3, 70, n_ground)
    pts[:, 1] = rng.uniform(-25, 25, n_ground)
    pts[:, 2] = rng.uniform(-1.75, -1.55, n_ground)  # ground
    pts[:, 3] = rng.uniform(0, 1, n_ground)
    clusters = [pts]
    for (cls, vx, vy) in objects:
        l, h, w, m = OBJECT_DIMS[cls]
        c = np.zeros((m, 4), dtype=np.float32)
        c[:, 0] = rng.uniform(vx - l / 2, vx + l / 2, m)
        c[:, 1] = rng.uniform(vy - w / 2, vy + w / 2, m)
        c[:, 2] = rng.uniform(-1.6, -1.6 + h - 0.05, m)
        c[:, 3] = rng.uniform(0, 1, m)
        clusters.append(c)
    return np.concatenate(clusters, axis=0)


def label_line(cls, x_velo, y_velo, yaw=0.05):
    """An object label in camera coords for a cluster at velo (x, y),
    with the 2D bbox computed by projecting the 3D box through P2."""
    # velo (x fwd, y left, z up) ~ cam (z fwd, x right, y down)
    x3d, y3d, z3d = -y_velo, 1.65, x_velo
    l, h, w = OBJECT_DIMS[cls][:3]
    # project the 8 corners with the P2 intrinsics (R0/Tr are near
    # identity in camera coords, so P2 alone is accurate enough here)
    c, s = np.cos(yaw), np.sin(yaw)
    corners = []
    for dx in (-l / 2, l / 2):
        for dy in (0.0, -h):
            for dz in (-w / 2, w / 2):
                cx = x3d + c * dx + s * dz
                cy = y3d + dy
                cz = z3d - s * dx + c * dz
                u = (7.070493e2 * cx + 6.040814e2 * cz + 4.575831e1) / cz
                v = (7.070493e2 * cy + 1.805066e2 * cz - 0.3454157) / cz
                corners.append((u, v))
    us = [p[0] for p in corners]
    vs = [p[1] for p in corners]
    xmin, xmax = max(min(us), 0.0), min(max(us), 1242.0)
    ymin, ymax = max(min(vs), 0.0), min(max(vs), 375.0)
    return (
        "%s 0.00 0 1.85 %.2f %.2f %.2f %.2f "
        "%.2f %.2f %.2f %.2f %.2f %.2f %.2f"
        % (cls, xmin, ymin, xmax, ymax, h, w, l, x3d, y3d, z3d, yaw)
    )


def car_label_line(x_velo, y_velo, yaw=0.05):
    return label_line("Car", x_velo, y_velo, yaw)


def main(out_dir, num_frames=4, classes=("Car",), split="training",
         n_ground=12000):
    """Write ``num_frames`` frames; ``split='testing'`` writes the KITTI
    test-server layout (no labels dir, no split files)."""
    is_test = split == "testing"
    dirs = {
        "image": os.path.join(out_dir, "image/%s/image_2" % split),
        "velo": os.path.join(out_dir, "velodyne/%s/velodyne" % split),
        "calib": os.path.join(out_dir, "calib/%s/calib" % split),
    }
    if not is_test:
        dirs["label"] = os.path.join(out_dir, "labels/training/label_2")
        dirs["splits"] = os.path.join(out_dir, "3DOP_splits")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(num_frames):
        name = "%06d" % i
        names.append(name)
        # three well-separated objects at varying ranges/lateral
        # offsets, cycling through the requested classes
        objects = [
            (classes[i % len(classes)], 18.0 + 4 * (i % 5), -3.0 - (i % 3)),
            (classes[(i + 1) % len(classes)], 32.0 + 3 * (i % 4),
             4.0 + (i % 2)),
            (classes[(i + 2) % len(classes)], 45.0 - 2 * (i % 3),
             -8.0 + 2 * (i % 4)),
        ]
        make_frame(rng, n_ground=n_ground, objects=objects).tofile(
            os.path.join(dirs["velo"], name + ".bin")
        )
        with open(os.path.join(dirs["calib"], name + ".txt"), "w") as f:
            f.write(CALIB_TEXT)
        if not is_test:
            with open(
                os.path.join(dirs["label"], name + ".txt"), "w"
            ) as f:
                for (cls, vx, vy) in objects:
                    f.write(label_line(cls, vx, vy) + "\n")
        img = rng.integers(0, 255, (375, 1242, 3)).astype(np.uint8)
        write_png(os.path.join(dirs["image"], name + ".png"), img)
    if not is_test:
        with open(os.path.join(dirs["splits"], "val.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        with open(os.path.join(dirs["splits"], "train.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return names


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("out_dir")
    parser.add_argument("num_frames", nargs="?", type=int, default=4)
    parser.add_argument("classes", nargs="?", default="Car",
                        help="comma-separated class names")
    parser.add_argument("--split", default="training",
                        choices=("training", "testing"))
    parser.add_argument("--n_ground", type=int, default=12000)
    args = parser.parse_args()
    main(args.out_dir, args.num_frames,
         classes=tuple(args.classes.split(",")), split=args.split,
         n_ground=args.n_ground)
    print("synthetic KITTI (%s) written to %s (%d frames)"
          % (args.split, args.out_dir, args.num_frames))
