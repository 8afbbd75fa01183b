"""On-device two-level graph construction (torch).

Counterpart of :mod:`pointgnn_tpu.graph.device_builder`: voxel keypoint
selection (deterministic for serving, randomized per step for training),
then per level either a capped radius edge list (:func:`radius_edges`)
or slab metadata (cell-sorted rows plus per-cell row offsets, so the
``slab_edge_max`` kernel walks the exact uncapped radius graph with no
edge list).  The integer metadata is bitwise equal to the JAX
builder's:

- every sort is stable (``torch.argsort(stable=True)``), as
  ``jnp.argsort`` is;
- ``jnp.nonzero(size=K, fill_value=P)`` becomes a cumsum compaction
  with a static output size (no ``torch.nonzero`` and its host sync);
- the ``mode="drop"`` scatter of ``_cell_offsets`` and the dropped
  overflow slot of the radius cell tables scatter into one extra slot
  that is then cut off;
- ``jax.lax.top_k`` becomes ``torch.topk(sorted=True)`` on the same
  slot-ranked keys (the kept keys are distinct, so the order is too).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.graph.pad import PaddedGraph
from pointgnn_tpu_torch.utils import thread_warnings

# static packing dims for voxel keys (same as the JAX builder)
_DX, _DY, _DZ = 1024, 128, 1024


class LevelSpec(NamedTuple):
    radius: float
    cell_cap: int        # edge list: max candidates per grid cell (M)
    per_center_cap: int  # edge list: max neighbors kept per center (S)
    grid_xz: int = 256   # edge list: dense 2D grid extent (cells/side)
    # slab grid: cell size decoupled from the radius; the kernel walks
    # +/- slab_halo cell columns around each center block
    slab_cell: float = 0.0
    slab_grid: int = 0
    slab_halo: int = 1
    # JAX compacts with approx_max_k on the TPU when set; off the TPU
    # (and always here) the compaction is the exact top-k
    approx_topk: bool = False


class DeviceGraphSpec(NamedTuple):
    """Static configuration of the two-level Point-GNN graph."""

    num_points: int       # P: raw point capacity
    num_keypoints: int    # K: downsampled vertex capacity
    voxel_size: float     # level-0 downsampling voxel
    level0: LevelSpec     # raw -> keypoints
    level1: LevelSpec     # keypoints -> keypoints
    slab_level1: bool = False
    slab_level0: bool = False


def spec_from_config(
    config: dict,
    num_points: int = 32768,
    num_keypoints: int = 16384,
    runtime: bool = True,
    cell_caps: Tuple[int, int] = (96, 192),
    per_center_caps: Tuple[int, int] = (32, 256),
    world_extent: float = 130.0,
    approx_topk: bool = False,
) -> DeviceGraphSpec:
    """Derive the spec from a reference-format model config (the same
    derivation as the JAX ``spec_from_config``)."""
    kwargs = config["runtime_graph_gen_kwargs" if runtime else
                    "graph_gen_kwargs"]
    levels = kwargs["level_configs"]
    if len(levels) != 2:
        raise ValueError("device builder supports the 2-level family")
    scale0 = levels[0]["graph_scale"]
    if not np.isclose(scale0, levels[1]["graph_scale"]):
        raise ValueError("level 1 must share level-0 vertices")
    voxel = kwargs["base_voxel_size"] * scale0

    def level(i, cell_cap, per_center_cap):
        r = float(levels[i]["graph_gen_kwargs"]["radius"])
        grid = int(np.clip(int(np.ceil(world_extent / r)), 32, 512))
        slab_cell = max(r, world_extent / 256.0)
        slab_halo = int(np.ceil(r / slab_cell - 1e-9))
        slab_grid = int(np.ceil(world_extent / slab_cell))
        return LevelSpec(
            r, cell_cap, per_center_cap, grid_xz=grid,
            slab_cell=slab_cell, slab_grid=slab_grid, slab_halo=slab_halo,
            approx_topk=approx_topk,
        )

    return DeviceGraphSpec(
        num_points=num_points,
        num_keypoints=num_keypoints,
        voxel_size=float(voxel),
        level0=level(0, cell_caps[0], per_center_caps[0]),
        level1=level(1, cell_caps[1], per_center_caps[1]),
    )


def _masked_min(xyz, mask):
    inf = torch.full_like(xyz, float("inf"))
    return torch.where(mask[:, None], xyz, inf).amin(dim=0)


def _cell_keys(xyz, mask, cell_size, origin):
    """Pack integer voxel coordinates into one int32 key; invalid
    points get the maximal key so they sort to the end."""
    ijk = torch.floor((xyz - origin) / cell_size).to(torch.int32)
    hi = torch.tensor([_DX - 1, _DY - 1, _DZ - 1], dtype=torch.int32,
                      device=xyz.device)
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi)
    key = ijk[:, 0] + _DX * (ijk[:, 1] + _DY * ijk[:, 2])
    big = _DX * _DY * _DZ
    return torch.where(mask, key, torch.full_like(key, big))


def draw_randomization(num_points, generator):
    """The training draws of :func:`voxel_select` from ``generator``, on
    its device: ``(shift [3] uniform in [0, 1), perm [num_points])``, a
    sub-voxel shift of the grid origin and a permutation of the
    points."""
    dev = generator.device
    shift = torch.rand(3, generator=generator, device=dev)
    perm = torch.randperm(num_points, generator=generator, device=dev)
    return shift, perm


def _voxel_origin(xyz, mask, voxel_size, shift=None):
    """Voxel-grid origin: the masked point minimum, moved back by
    ``shift * voxel_size`` when a training shift is given."""
    origin = _masked_min(xyz, mask)
    if shift is not None:
        origin = origin - shift.to(origin.dtype) * voxel_size
    return origin


def _compact(flags, size, fill):
    """Indices of the first ``size`` True entries of ``flags``, padded
    with ``fill``: ``jnp.nonzero(flags, size=size, fill_value=fill)``
    with a static output shape."""
    n = flags.shape[0]
    rank = torch.cumsum(flags.to(torch.int64), 0) - 1
    dest = torch.where(flags & (rank < size), rank,
                       torch.full_like(rank, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64,
                     device=flags.device)
    out.scatter_(0, dest, torch.arange(n, device=flags.device))
    return out[:size]


def voxel_select(xyz, mask, voxel_size, num_keypoints, rnd=None):
    """One representative point index per occupied voxel.

    Without ``rnd`` (serving): the lowest-index point, grid anchored at
    the point-cloud minimum.  With ``rnd`` (training), the draws
    ``(shift [3], perm [P])`` of :func:`draw_randomization` (or the same
    draws made elsewhere, as the tests inject JAX's): the origin moves
    back by ``shift * voxel_size`` and the representative is the first
    point of its voxel in permuted order, i.e. a uniformly random one (a
    stable sort of the permuted keys).

    Returns ``(indices [K] int64 into xyz, kp_mask [K] bool)``; the first
    ``num_keypoints`` voxels in key order are kept.
    """
    p = xyz.shape[0]
    shift, perm = rnd if rnd is not None else (None, None)
    origin = _voxel_origin(xyz, mask, voxel_size, shift)
    keys = _cell_keys(xyz, mask, voxel_size, origin)
    if perm is None:
        order = torch.argsort(keys, stable=True)
    else:
        perm = perm.to(device=xyz.device, dtype=torch.int64)
        order = perm[torch.argsort(keys[perm], stable=True)]
    sorted_keys = keys[order]
    big = _DX * _DY * _DZ
    first = torch.ones(p, dtype=torch.bool, device=xyz.device)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = first & (sorted_keys < big)
    slots = _compact(first, num_keypoints, p)
    kp_mask = slots < p
    indices = order[torch.clamp(slots, max=p - 1)]
    return torch.where(kp_mask, indices, torch.zeros_like(indices)), kp_mask


def radius_edges(
    src_xyz, src_mask, ctr_xyz, ctr_mask, level: LevelSpec,
    return_counts=False,
):
    """Fixed-radius neighbors, grouped by center with sentinel padding.

    Returns ``(edges_src [K*S], edges_dst [K*S])`` int32 in the
    SRC-sentinel layout: ``dst`` is always the owning center (so the list
    is dst-sorted) and padded slots carry ``src == num_sources``.  With
    ``return_counts`` also a dict of int32 scalars:
    ``saturated_centers`` (centers with more than ``per_center_cap``
    in-radius candidates, whose neighbor set is truncated) and
    ``cell_overflow_sources`` (valid sources dropped from cells holding
    more than ``cell_cap``).

    The JAX builder's steps, in its order: sources go into a dense 2D
    (x, z) grid of ``cell_cap``-slot cell tables (rank within a cell from
    one stable sort and a running max of group starts; overflowing and
    invalid sources land in one dropped slot); each center gathers its
    3x3 neighboring cell tables and tests ``dx*dx + dy*dy + dz*dz <=
    r*r`` in float32, in that order; the first ``per_center_cap`` hits in
    slot order are kept by a sorted top-k on a slot-ranked key.
    ``level.approx_topk`` (``approx_max_k`` on a TPU) runs the exact
    top-k, as JAX does off the TPU.
    """
    n = src_xyz.shape[0]
    k = ctr_xyz.shape[0]
    r, m, s = level.radius, level.cell_cap, level.per_center_cap
    g = level.grid_xz
    num_cells = g * g
    dev = src_xyz.device
    src_mask = src_mask.to(torch.bool)
    ctr_mask = ctr_mask.to(torch.bool)
    origin = _masked_min(src_xyz, src_mask)

    def cell_xz(xyz):
        cx = torch.floor((xyz[:, 0] - origin[0]) / r).to(torch.int32)
        cz = torch.floor((xyz[:, 2] - origin[2]) / r).to(torch.int32)
        return torch.clamp(cx, 0, g - 1), torch.clamp(cz, 0, g - 1)

    sx, sz = cell_xz(src_xyz)
    src_cell = torch.where(src_mask, sx * g + sz,
                           torch.full_like(sx, num_cells)).to(torch.int64)

    # within-cell rank from one stable sort of the source cells
    order = torch.argsort(src_cell, stable=True)
    sorted_cell = src_cell[order]
    first_of_group = torch.ones(n, dtype=torch.bool, device=dev)
    first_of_group[1:] = sorted_cell[1:] != sorted_cell[:-1]
    ar = torch.arange(n, device=dev)
    group_start = torch.where(first_of_group, ar, torch.zeros_like(ar))
    group_start = torch.cummax(group_start, dim=0).values
    rank = ar - group_start

    # dense cell tables [num_cells, m]; overflow/invalid -> dropped slot
    in_table = (sorted_cell < num_cells) & (rank < m)
    table_slot = torch.where(in_table, sorted_cell * m + rank,
                             torch.full_like(rank, num_cells * m))

    def to_table(vals, fill):
        t = torch.full((num_cells * m + 1,), fill, dtype=vals.dtype,
                       device=dev)
        t.scatter_(0, table_slot, vals)
        return t[:-1].reshape(num_cells, m)

    inf = float("inf")
    tbl_x = to_table(src_xyz[order, 0], inf)
    tbl_y = to_table(src_xyz[order, 1], inf)
    tbl_z = to_table(src_xyz[order, 2], inf)
    tbl_i = to_table(order.to(torch.int32), 0)

    # 3x3 neighbor cells per center (x-major) -> row-gather the tables
    cxc, czc = cell_xz(ctr_xyz)
    d = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    off_x = d.repeat_interleave(3)
    off_z = d.repeat(3)
    ncx = cxc[:, None] + off_x[None, :]
    ncz = czc[:, None] + off_z[None, :]
    in_grid = (ncx >= 0) & (ncx < g) & (ncz >= 0) & (ncz < g)
    nc = torch.where(
        in_grid,
        torch.clamp(ncx, 0, g - 1) * g + torch.clamp(ncz, 0, g - 1),
        torch.zeros_like(ncx),
    ).to(torch.int64)
    width = 9 * m
    cand_x = tbl_x[nc].reshape(k, width)
    cand_y = tbl_y[nc].reshape(k, width)
    cand_z = tbl_z[nc].reshape(k, width)
    cand_i = tbl_i[nc].reshape(k, width)

    dx = cand_x - ctr_xyz[:, 0:1]
    dy = cand_y - ctr_xyz[:, 1:2]
    dz = cand_z - ctr_xyz[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz  # inf-filled slots fail the test
    r2 = torch.tensor(float(np.float32(float(r) * float(r))),
                      dtype=torch.float32, device=dev)
    ok = (
        (d2 <= r2)
        & ctr_mask[:, None]
        & in_grid.repeat_interleave(m, dim=1)
    )

    # compact to the first s hits per center: top-k on a slot-ranked key
    slot_rank = width - torch.arange(width, dtype=torch.int32, device=dev)
    key = torch.where(ok, slot_rank[None, :],
                      torch.zeros((), dtype=torch.int32, device=dev))
    topv, topi = torch.topk(key, s, dim=1, sorted=True)
    picked = torch.gather(cand_i, 1, topi)
    # invalid slots become the sentinel n whatever topk picked among the
    # zero keys; dst is always the owning center
    edges_src = torch.where(topv > 0, picked,
                            torch.full_like(picked, n)).reshape(-1)
    edges_dst = torch.arange(k, dtype=torch.int32, device=dev)[
        :, None].expand(k, s).reshape(-1)
    if return_counts:
        counts = {
            "saturated_centers": (ok.sum(dim=1) > s).sum().to(torch.int32),
            "cell_overflow_sources": (
                (sorted_cell < num_cells) & (rank >= m)
            ).sum().to(torch.int32),
        }
        return edges_src, edges_dst, counts
    return edges_src, edges_dst


def slab_grid_of(level: LevelSpec):
    """(cell_size, grid) of the level's slab grid."""
    cell = level.slab_cell or level.radius
    grid = level.slab_grid or level.grid_xz
    return cell, grid


def slab_kernel_wiring(level: LevelSpec) -> dict:
    """The model-side slab kwargs for one level: the one derivation of
    {grid_g, radius, halo}, so the kernel walks the grid the builder
    wrote."""
    return {
        "grid_g": slab_grid_of(level)[1],
        "radius": level.radius,
        "halo": level.slab_halo,
    }


def grid_cells(xyz, mask, level: LevelSpec, origin=None):
    """Slab-grid cell id per row (pad rows get ``g*g``).
    Returns ``(cell [N] int32, origin [3])``."""
    r, g = slab_grid_of(level)
    if origin is None:
        origin = _masked_min(xyz, mask)
    cx = torch.clamp(
        torch.floor((xyz[:, 0] - origin[0]) / r).to(torch.int32), 0, g - 1
    )
    cz = torch.clamp(
        torch.floor((xyz[:, 2] - origin[2]) / r).to(torch.int32), 0, g - 1
    )
    cell = torch.where(mask, cx * g + cz, torch.full_like(cx, g * g))
    return cell.to(torch.int32), origin


def _cell_offsets(sorted_cell, num_cells):
    """``searchsorted(sorted_cell, arange(num_cells + 1))`` as a scatter
    of each cell's first row plus a reverse cummin that back-fills the
    empty cells."""
    n = sorted_cell.shape[0]
    dev = sorted_cell.device
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_cell[1:] != sorted_cell[:-1]
    # non-first rows land in the extra slot num_cells + 2, cut off below
    # (JAX scatters them out of bounds under mode="drop")
    idx = torch.where(first, sorted_cell.to(torch.int64),
                      torch.full((n,), num_cells + 2, dtype=torch.int64,
                                 device=dev))
    tbl = torch.full((num_cells + 3,), -1, dtype=torch.int32, device=dev)
    tbl.scatter_(0, idx, torch.arange(n, dtype=torch.int32, device=dev))
    tbl = tbl[: num_cells + 1]
    filled = torch.where(tbl >= 0, tbl, torch.full_like(tbl, n))
    return torch.cummin(filled.flip(0), dim=0).values.flip(0)


def slab_metadata(kp_xyz, kp_mask, level: LevelSpec, secondary=None):
    """Cell-sort order + per-cell row offsets for one slab level.

    Returns ``(order [K], sorted_cell [K], offsets [g*g+1])``;
    ``secondary`` (e.g. the level-0 fine cell) orders rows within each
    cell."""
    cell, _ = grid_cells(kp_xyz, kp_mask, level)
    if secondary is None:
        order = torch.argsort(cell, stable=True)
    else:
        o1 = torch.argsort(secondary, stable=True)
        order = o1[torch.argsort(cell[o1], stable=True)]
    sorted_cell = cell[order]
    offsets = _cell_offsets(sorted_cell, slab_grid_of(level)[1] ** 2)
    return order, sorted_cell, offsets


def inverse_permutation(order):
    n = order.shape[0]
    inv = torch.zeros(n, dtype=torch.int64, device=order.device)
    inv[order] = torch.arange(n, device=order.device)
    return inv


def build_padded_graph(
    points_xyz,            # [P, 3] float32
    features,              # [P, C] float32
    points_mask,           # [P] bool/float
    spec: DeviceGraphSpec,
    rnd=None,
    return_counters=False,
):
    """Two-level graph: per level a capped radius edge list or, where
    the spec's slab flag is set, slab metadata (the edge list is then a
    1-element dummy).

    With ``slab_level0`` raw points are sorted into level-0 cell order;
    with ``slab_level1`` keypoints are sorted into level-1 cell-major
    order (level-0 cell minor when ``slab_level0`` is set too), and the
    level-0 edges are built on that order.  ``rnd`` randomizes the
    keypoint selection for training (see :func:`voxel_select`).

    With ``return_counters`` also returns a dict of int32 scalars:
    ``voxels_occupied``, ``keypoints_dropped`` and, for each edge-list
    level ``i``, ``l{i}_saturated_centers`` and
    ``l{i}_cell_overflow_sources`` (see :func:`radius_edges`)."""
    dev = points_xyz.device
    counters = {}
    points_mask = points_mask.to(torch.bool)
    kp_idx, kp_mask = voxel_select(
        points_xyz, points_mask, spec.voxel_size, spec.num_keypoints, rnd
    )
    if return_counters:
        # occupied voxels on the grid the selection used
        keys = _cell_keys(
            points_xyz, points_mask, spec.voxel_size,
            _voxel_origin(points_xyz, points_mask, spec.voxel_size,
                          None if rnd is None else rnd[0]),
        )
        sk = torch.sort(keys).values
        first = torch.ones(sk.shape[0], dtype=torch.bool, device=dev)
        first[1:] = sk[1:] != sk[:-1]
        occupied = (first & (sk < _DX * _DY * _DZ)).sum().to(torch.int32)
        counters["voxels_occupied"] = occupied
        counters["keypoints_dropped"] = torch.clamp(
            occupied - spec.num_keypoints, min=0)
    kp_xyz = torch.where(
        kp_mask[:, None], points_xyz[kp_idx], torch.zeros((), device=dev)
    )
    slab_offsets = slab_center_cell = None
    slab0_offsets = slab0_center_cell = None
    kp_fine = None
    if spec.slab_level0:
        # level 0: sort raw points by their level-0 cell
        p_cell, p_origin = grid_cells(points_xyz, points_mask, spec.level0)
        p_order = torch.argsort(p_cell, stable=True)
        points_xyz = points_xyz[p_order]
        features = features[p_order]
        points_mask = points_mask[p_order]
        slab0_offsets = _cell_offsets(
            p_cell[p_order], slab_grid_of(spec.level0)[1] ** 2
        )
        kp_idx = inverse_permutation(p_order)[kp_idx]
        kp_fine, _ = grid_cells(kp_xyz, kp_mask, spec.level0, p_origin)
    if spec.slab_level1:
        # level 1: keypoints in level-1 cell-major (level-0 cell-minor)
        # order; every later per-keypoint array follows it
        order, slab_center_cell, slab_offsets = slab_metadata(
            kp_xyz, kp_mask, spec.level1, secondary=kp_fine
        )
        kp_idx = kp_idx[order]
        kp_mask = kp_mask[order]
        kp_xyz = kp_xyz[order]
        if kp_fine is not None:
            slab0_center_cell = kp_fine[order]
    elif kp_fine is not None:
        slab0_center_cell = kp_fine

    dummy = torch.zeros((1,), dtype=torch.int32, device=dev)
    edges = []
    for i, (slab_level, src, smask, level) in enumerate((
        (spec.slab_level0, points_xyz, points_mask, spec.level0),
        (spec.slab_level1, kp_xyz, kp_mask, spec.level1),
    )):
        if slab_level:  # exact, uncapped: nothing to saturate
            edges.append((dummy, dummy))
            continue
        res = radius_edges(src, smask, kp_xyz, kp_mask, level,
                           return_counts=return_counters)
        if return_counters:
            for key, val in res[2].items():
                counters["l%d_%s" % (i, key)] = val
        edges.append(res[:2])

    k = spec.num_keypoints
    maskf = points_mask.to(torch.float32)
    kp_maskf = kp_mask.to(torch.float32)
    graph = PaddedGraph(
        features=features * maskf[:, None],
        vertex_xyz=(points_xyz * maskf[:, None], kp_xyz, kp_xyz),
        vertex_mask=(maskf, kp_maskf, kp_maskf),
        keypoint_indices=(
            kp_idx.to(torch.int32),
            torch.arange(k, dtype=torch.int32, device=dev),
        ),
        edges_src=(edges[0][0], edges[1][0]),
        edges_dst=(edges[0][1], edges[1][1]),
        cls_labels=torch.zeros((k,), dtype=torch.int32, device=dev),
        encoded_boxes=torch.zeros((k, 7), dtype=torch.float32, device=dev),
        valid_boxes=torch.zeros((k,), dtype=torch.float32, device=dev),
        slab_offsets=slab_offsets,
        slab_center_cell=slab_center_cell,
        slab0_offsets=slab0_offsets,
        slab0_center_cell=slab0_center_cell,
    )
    if return_counters:
        return graph, counters
    return graph


def host_overflow_stats(xyz: np.ndarray, spec: DeviceGraphSpec):
    """Host-side overflow accounting for one frame: points beyond
    ``spec.num_points`` and occupied voxels beyond ``num_keypoints``
    (the same packing as the device voxel keys)."""
    n = len(xyz)
    kept = np.asarray(xyz[: spec.num_points], np.float32)
    if len(kept):
        ijk = np.floor(
            (kept - kept.min(axis=0)) / spec.voxel_size
        ).astype(np.int64)
        ijk = np.clip(ijk, 0, np.array([_DX - 1, _DY - 1, _DZ - 1]))
        occupied = len(
            np.unique(ijk[:, 0] + _DX * (ijk[:, 1] + _DY * ijk[:, 2]))
        )
    else:
        occupied = 0
    return {
        "points": n,
        "points_dropped": max(0, n - spec.num_points),
        "voxels_occupied": occupied,
        "keypoints_dropped": max(0, occupied - spec.num_keypoints),
    }


# Pad rows of the packed payload carry this coordinate; any coordinate
# >= PACK_SENTINEL / 10 marks a pad row.
PACK_SENTINEL = 1e6


def _warn_point_drop(n_in, num_points):
    if n_in > num_points:
        # deferred to the consuming thread when called from the
        # trainer's prefetch worker (utils/thread_warnings)
        thread_warnings.warn(
            "point overflow: frame has %d points > device capacity %d; "
            "dropping %d (far-field detections may be lost — raise "
            "num_points in the DeviceGraphSpec)"
            % (n_in, num_points, n_in - num_points),
            RuntimeWarning,
            stacklevel=3,
        )


def pad_points(xyz: np.ndarray, attr: np.ndarray, num_points: int):
    """Host-side: pad raw points to the spec capacity as three arrays,
    ``(xyz [P, 3], attr [P, C], mask [P])`` f32, pad rows zero.  Warns
    when points are dropped."""
    _warn_point_drop(len(xyz), num_points)
    n = min(len(xyz), num_points)
    out_xyz = np.zeros((num_points, 3), np.float32)
    out_attr = np.zeros((num_points, attr.shape[1]), np.float32)
    mask = np.zeros((num_points,), np.float32)
    out_xyz[:n] = xyz[:n]
    out_attr[:n] = attr[:n]
    mask[:n] = 1.0
    return out_xyz, out_attr, mask


def pack_points(xyz: np.ndarray, attr: np.ndarray, num_points: int):
    """Host-side: one [num_points, 3 + C] f32 payload; pad rows carry
    sentinel coordinates.  Warns when points beyond the capacity are
    dropped."""
    _warn_point_drop(len(xyz), num_points)
    n = min(len(xyz), num_points)
    out = np.zeros((num_points, 3 + attr.shape[1]), np.float32)
    out[n:, :3] = PACK_SENTINEL
    out[:n, :3] = xyz[:n]
    out[:n, 3:] = attr[:n]
    return out


def unpack_points(packed):
    """Device-side inverse of :func:`pack_points`:
    ``(xyz [P,3], features [P,C], mask [P])`` with zeroed pad rows."""
    mask = (packed[:, 0] < PACK_SENTINEL / 10).to(torch.float32)
    xyz = torch.where(
        mask[:, None] > 0, packed[:, :3], torch.zeros((), device=packed.device)
    )
    feats = packed[:, 3:] * mask[:, None]
    return xyz, feats, mask
