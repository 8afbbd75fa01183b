"""Voxel-grid averaging (copy of the average variant of
:mod:`pointgnn_tpu.graph.voxel`), used by
``KittiDataset.get_cam_points`` when a config sets
``downsample_by_voxel_size``.

Voxel keys come from the min-corner offset grid (floor-divide after the
offset, optional random 3D shift of the grid); every occupied voxel
yields the mean xyz (and attr) of its points, in key order.
"""

from typing import Optional

import numpy as np

from pointgnn_tpu_torch.core.points import Points


def _voxel_keys(xyz: np.ndarray, voxel_size, rng=None) -> np.ndarray:
    """Scalar voxel key per point. Optional random grid shift."""
    if len(xyz) == 0:  # empty frame: no occupied voxels
        return np.zeros(0, dtype=np.int64)
    xyz_min = xyz.min(axis=0, keepdims=True)
    shifted = xyz - xyz_min
    if rng is not None:
        shifted = shifted + voxel_size * rng.random((1, 3))
    idx = np.floor(shifted / voxel_size).astype(np.int64)
    dims = idx.max(axis=0) + 1
    return idx[:, 0] + idx[:, 1] * dims[0] + idx[:, 2] * dims[1] * dims[0]


def voxel_downsample_average(
    points: Points, voxel_size: float, rng: Optional[np.random.Generator] = None
) -> Points:
    """Average xyz (and attr) of all points per occupied voxel."""
    keys = _voxel_keys(points.xyz, voxel_size, rng)
    order = np.argsort(keys, kind="stable")
    sorted_xyz = points.xyz[order]
    _, starts, counts = np.unique(
        keys[order], return_index=True, return_counts=True
    )
    mean_xyz = np.add.reduceat(sorted_xyz, starts, axis=0) / counts[:, None]
    attr = None
    if points.attr is not None:
        sorted_attr = points.attr[order]
        attr = np.add.reduceat(sorted_attr, starts, axis=0) / counts[:, None]
    return Points(xyz=mean_xyz, attr=attr)
