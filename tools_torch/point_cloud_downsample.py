#!/usr/bin/env python3
"""Simulate a lower-resolution LiDAR by dropping beams.

Clusters each point's elevation cosine into 64 beams (a 1-D k-means in
numpy, :func:`kmeans_1d`), keeps every ``downsample_rate``-th beam
(taking the midpoint between adjacent beam centres as the boundary) and
writes new velodyne ``.bin`` files.

Usage:
    python tools_torch/point_cloud_downsample.py <dataset_root> \\
        [--split 3DOP_splits/val.txt] [--rate 2] [--output_dir DIR]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def _assign(x, centers):
    """``(labels, means)``: each point of sorted 1-D ``x`` to the nearest
    of the sorted ``centers`` (the boundaries are the midpoints), and each
    centre's points' mean (an empty centre keeps its place)."""
    labels = np.searchsorted((centers[1:] + centers[:-1]) / 2.0, x)
    counts = np.bincount(labels, minlength=len(centers))
    sums = np.bincount(labels, weights=x, minlength=len(centers))
    return labels, np.where(counts > 0, sums / np.maximum(counts, 1),
                            centers)


def _lloyd(x, centers, max_iter=300, tol=1e-4):
    """Lloyd iterations from sorted ``centers`` until the centres move
    less than ``tol`` of the data's variance (scikit-learn's rule);
    returns ``(centers, inertia)``, the centres the means of their
    points."""
    tol = tol * float(np.var(x))
    for _ in range(max_iter):
        new = np.sort(_assign(x, centers)[1])
        shift = float(np.sum((new - centers) ** 2))
        centers = new
        if shift <= tol:
            break
    labels, centers = _assign(x, centers)
    return centers, float(np.sum((x - centers[labels]) ** 2))


def _plus_plus(x, k, rng):
    """k-means++ seeding on 1-D data."""
    centers = [x[rng.integers(len(x))]]
    d2 = (x - centers[0]) ** 2
    for _ in range(1, k):
        total = d2.sum()
        if total <= 0:
            centers.append(x[rng.integers(len(x))])
        else:
            centers.append(x[np.searchsorted(np.cumsum(d2),
                                             rng.random() * total)])
        d2 = np.minimum(d2, (x - centers[-1]) ** 2)
    return np.sort(np.asarray(centers, np.float64))


def kmeans_1d(values, n_clusters, n_init=3, seed=0):
    """Sorted centres of a 1-D k-means of ``values``, the best inertia
    of ``n_init`` runs: the first starts from the centres of the groups
    split at the ``n_clusters - 1`` widest gaps of the sorted values
    (each of well-separated beams a group), the others from k-means++
    seeded by ``seed``."""
    x = np.sort(np.asarray(values, np.float64).ravel())
    k = min(n_clusters, len(x))
    gaps = np.argsort(np.diff(x), kind="stable")[::-1][:k - 1]
    bounds = np.concatenate([[0], np.sort(gaps) + 1, [len(x)]])
    starts = [np.array([x[a:b].mean() for a, b in zip(bounds[:-1],
                                                      bounds[1:])])]
    rng = np.random.default_rng(seed)
    starts += [_plus_plus(x, k, rng) for _ in range(n_init - 1)]
    best = None
    for start in starts:
        centers, inertia = _lloyd(x, start)
        if best is None or inertia < best[1]:
            best = (centers, inertia)
    return np.sort(best[0])


def beam_mask(
    xyz: np.ndarray, downsample_rate: int, n_beams: int = 64, seed: int = 0
) -> np.ndarray:
    """Boolean mask keeping every downsample_rate-th elevation beam."""
    norm = np.sqrt(np.sum(xyz * xyz, axis=1, keepdims=True))
    cos = (xyz[:, [2]] / np.maximum(norm, 1e-12)).astype(np.float64)
    centers = kmeans_1d(cos, n_beams, n_init=3, seed=seed)
    centers = np.concatenate([[-1.0], centers, [1.0]])
    cos = np.squeeze(cos)
    mask = np.zeros(len(xyz), dtype=bool)
    for i in range(0, len(centers) - 2, downsample_rate):
        lower = (centers[i] + centers[i + 1]) / 2
        higher = (centers[i + 1] + centers[i + 2]) / 2
        mask |= (cos > lower) & (cos < higher)
    return mask


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="LiDAR beam downsampling for KITTI velodyne files"
    )
    parser.add_argument("dataset_root", type=str)
    parser.add_argument("--split", type=str, default="3DOP_splits/val.txt")
    parser.add_argument("--rate", type=int, default=2)
    parser.add_argument("--output_dir", type=str, default="")
    args = parser.parse_args(argv)

    from pointgnn_tpu_torch.data.kitti import KittiDataset

    dataset = KittiDataset(
        os.path.join(args.dataset_root, "image/training/image_2"),
        os.path.join(args.dataset_root, "velodyne/training/velodyne/"),
        os.path.join(args.dataset_root, "calib/training/calib/"),
        "",
        os.path.join(args.dataset_root, args.split),
        is_training=False,
    )
    output_dir = args.output_dir or os.path.join(
        args.dataset_root,
        "velodyne/training_downsampled_%d/velodyne/" % args.rate,
    )
    os.makedirs(output_dir, exist_ok=True)
    for frame_idx in range(dataset.num_files):
        points = dataset.get_velo_points(frame_idx)
        mask = beam_mask(points.xyz, args.rate)
        out = np.hstack([points.xyz[mask], points.attr[mask]]).astype(
            np.float32
        )
        out.tofile(
            os.path.join(output_dir, dataset.get_filename(frame_idx) + ".bin")
        )
        print("%s: %d -> %d points" % (dataset.get_filename(frame_idx),
                                      points.n, mask.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
