"""Fixed-radius neighbor search of the host-built graph (counterpart of
:mod:`pointgnn_tpu.graph.radius`).

The main path is the native grid search (``csrc/host/radius_grid.cpp``
through :func:`pointgnn_tpu_torch.postprocess.native.radius_neighbors`);
a failed build raises, nothing replaces it.  ``use_native=False`` runs
the plain numpy grid search (cells of edge ``radius``, the 27 cells
around each center, inclusive distance test, optional per-center cap by
a random priority), kept to hold the native search against.

Both return ``[E, 2] = (point_index, center_index)`` int64 edges grouped
by center in ascending order.  With an ``rng``, the native path draws its
seed from it (``rng.integers(0, 2**63 - 1)``) on every call, capped or
not, as the JAX function does, so every later draw of a frame matches.
"""

from typing import Optional

import numpy as np

from pointgnn_tpu_torch.postprocess import native

_NEIGHBOR_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)],
    dtype=np.int64,
)  # [27, 3]


def radius_neighbors(
    points_xyz: np.ndarray,
    centers_xyz: np.ndarray,
    radius: float,
    num_neighbors: int = -1,
    rng: Optional[np.random.Generator] = None,
    use_native: bool = True,
) -> np.ndarray:
    """All (point, center) pairs with ``|p - c| <= radius``; with
    ``num_neighbors > 0`` a uniform random subset of at most that many
    per center."""
    points_xyz = np.ascontiguousarray(points_xyz, dtype=np.float32)
    centers_xyz = np.ascontiguousarray(centers_xyz, dtype=np.float32)
    n = len(points_xyz)
    m = len(centers_xyz)
    if n == 0 or m == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if use_native:
        seed = int(rng.integers(0, 2**63 - 1)) if rng is not None else 12345
        return native.radius_neighbors(points_xyz, centers_xyz, radius,
                                       num_neighbors, seed)
    return _radius_neighbors_numpy(points_xyz, centers_xyz, radius,
                                   num_neighbors, rng)


def _radius_neighbors_numpy(points_xyz, centers_xyz, radius, num_neighbors,
                            rng):
    m = len(centers_xyz)
    inv = 1.0 / float(radius)
    origin = points_xyz.min(axis=0)
    pcell = np.floor((points_xyz - origin) * inv).astype(np.int64)
    ccell = np.floor((centers_xyz - origin) * inv).astype(np.int64)
    # grid dims from the union, so center cells outside the points'
    # bounding box still get valid (possibly empty) keys
    hi = np.maximum(pcell.max(axis=0), ccell.max(axis=0)) + 2
    lo = np.minimum(pcell.min(axis=0), ccell.min(axis=0)) - 1
    pcell -= lo
    ccell -= lo
    dims = hi - lo + 1

    def key_of(cell):
        return (cell[..., 0] * dims[1] + cell[..., 1]) * dims[2] + cell[..., 2]

    pkey = key_of(pcell)
    order = np.argsort(pkey, kind="stable")
    sorted_key = pkey[order]
    # the 27 candidate cells of every center
    nkey = key_of(ccell[:, None, :] + _NEIGHBOR_OFFSETS[None]).reshape(-1)
    starts = np.searchsorted(sorted_key, nkey, side="left")
    ends = np.searchsorted(sorted_key, nkey, side="right")
    counts = ends - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0, 2), dtype=np.int64)
    # flat ragged gather: each (center, cell) range emits its span
    cand_center = np.repeat(np.repeat(np.arange(m, dtype=np.int64), 27),
                            counts)
    cum = np.cumsum(counts)
    flat_pos = np.arange(total, dtype=np.int64) - np.repeat(cum - counts,
                                                            counts)
    cand_point = order[np.repeat(starts, counts) + flat_pos]
    d2 = np.sum((points_xyz[cand_point] - centers_xyz[cand_center]) ** 2,
                axis=-1)
    keep = d2 <= radius * radius + 1e-12
    cand_point = cand_point[keep]
    cand_center = cand_center[keep]

    if num_neighbors > 0:
        if rng is None:
            rng = np.random.default_rng()
        # a random rank within each center group; keep rank < cap
        priority = rng.random(len(cand_center))
        order2 = np.lexsort((priority, cand_center))
        cand_center = cand_center[order2]
        cand_point = cand_point[order2]
        group_start = np.ones(len(cand_center), dtype=bool)
        group_start[1:] = cand_center[1:] != cand_center[:-1]
        group_idx = np.cumsum(group_start) - 1
        first_of_group = np.flatnonzero(group_start)
        rank = np.arange(len(cand_center)) - first_of_group[group_idx]
        sel = rank < num_neighbors
        cand_center = cand_center[sel]
        cand_point = cand_point[sel]
    else:
        order2 = np.argsort(cand_center, kind="stable")
        cand_center = cand_center[order2]
        cand_point = cand_point[order2]
    return np.stack([cand_point, cand_center], axis=1)
