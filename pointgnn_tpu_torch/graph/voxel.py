"""Voxel-grid downsampling (copy of :mod:`pointgnn_tpu.graph.voxel`).
``KittiDataset.get_cam_points`` averages when a config sets
``downsample_by_voxel_size``; the augmentations
``random_voxel_downsample`` and ``dilute_background`` keep one random
point per voxel; the host-built graph (``graph/builder.py``) downsamples
its levels with :func:`multi_level_downsample_random` or
:func:`multi_level_downsample_select`.

Voxel keys come from the min-corner offset grid (floor-divide after the
offset, optional random 3D shift of the grid); every occupied voxel
yields the mean xyz (and attr) of its points, in key order, or one of
its original points chosen uniformly at random.
"""

from typing import List, Optional, Tuple

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


def voxel_downsample_random_indices(
    xyz: np.ndarray,
    voxel_size: float,
    rng: np.random.Generator,
    add_rnd3d: bool = False,
) -> np.ndarray:
    """One random point index per occupied voxel ([K] indices): shuffle
    the points, then take the first point of each voxel group in the
    shuffled order, a uniform choice per voxel.  Draws the grid shift
    (with ``add_rnd3d``) before the permutation."""
    keys = _voxel_keys(xyz, voxel_size, rng if add_rnd3d else None)
    perm = rng.permutation(len(keys))
    order = perm[np.argsort(keys[perm], kind="stable")]
    sorted_keys = keys[order]
    first = np.ones(len(sorted_keys), dtype=bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return order[first]


def voxel_downsample_random(
    points: Points,
    voxel_size: float,
    rng: Optional[np.random.Generator] = None,
    add_rnd3d: bool = False,
) -> Points:
    if rng is None:
        rng = np.random.default_rng()
    sel = voxel_downsample_random_indices(points.xyz, voxel_size, rng,
                                          add_rnd3d)
    return points.mask(sel)


def multi_level_downsample_random(
    points_xyz: np.ndarray,
    base_voxel_size: float,
    levels: List[float],
    add_rnd3d: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One random point per voxel at each scale of ``levels``.

    Returns ``(vertex_coord_list, keypoint_indices_list)``, ``len(levels)
    + 1`` vertex levels; a scale equal to the one before copies the level
    and gives identity indices.  Keypoint indices are [K, 1] int64 arrays
    into the previous level."""
    if rng is None:
        rng = np.random.default_rng()
    vertex_coord_list = [np.asarray(points_xyz)]
    keypoint_indices_list = []
    last_level = 0.0
    for level in levels:
        last_xyz = vertex_coord_list[-1]
        if np.isclose(last_level, level):
            vertex_coord_list.append(last_xyz.copy())
            keypoint_indices_list.append(
                np.arange(len(last_xyz), dtype=np.int64)[:, None])
        else:
            sel = voxel_downsample_random_indices(
                last_xyz, base_voxel_size * level, rng, add_rnd3d)
            vertex_coord_list.append(last_xyz[sel])
            keypoint_indices_list.append(sel.astype(np.int64)[:, None])
        last_level = level
    return vertex_coord_list, keypoint_indices_list


def multi_level_downsample_select(
    points_xyz: np.ndarray,
    base_voxel_size: float,
    levels: List[float],
    add_rnd3d: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The "center" method: average each voxel, then snap the average to
    the nearest point of the level (``scipy.spatial.cKDTree``).  Same
    return structure as :func:`multi_level_downsample_random`."""
    from scipy.spatial import cKDTree

    if rng is None:
        rng = np.random.default_rng()
    points_xyz = np.asarray(points_xyz)
    vertex_coord_list = [points_xyz]
    keypoint_indices_list = []
    last_level = 0.0
    for level in levels:
        base = vertex_coord_list[-1]
        if np.isclose(last_level, level):
            vertex_coord_list.append(base.copy())
            keypoint_indices_list.append(
                np.arange(len(base), dtype=np.int64)[:, None])
        else:
            centers = voxel_downsample_average(
                Points(xyz=base, attr=None), base_voxel_size * level,
                rng if add_rnd3d else None,
            ).xyz
            _, idx = cKDTree(base).query(centers, k=1)
            idx = np.asarray(idx, dtype=np.int64)
            vertex_coord_list.append(base[idx])
            keypoint_indices_list.append(idx[:, None])
        last_level = level
    return vertex_coord_list, keypoint_indices_list
