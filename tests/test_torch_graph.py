"""The port's on-device slab graph builder against the JAX builder.

The integer metadata (keypoint indices, masks, slab offsets and center
cells) and the sorted coordinates must be bitwise equal: the kernels'
walks and every later comparison depend on the same row order.
"""

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.utils.synthetic import (
    synthetic_lidar_frame as port_synthetic_lidar_frame,
)

NUM_POINTS, NUM_KEYPOINTS = 1024, 256

BITWISE = [
    "slab_offsets", "slab_center_cell", "slab0_offsets",
    "slab0_center_cell", "features",
]


def _frame(seed):
    pts, _ = synthetic_lidar_frame(seed=seed, n_beams=16, points_per_beam=64)
    if seed == 2:
        # a far-field crop: pad points and pad keypoints both occur
        keep = pts.xyz[:, 2] > 25.0
        pts = pts.mask(keep)
    return pts


def _specs():
    cfg = jax_configs.model_config("Car", T=2)
    kw = dict(num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS)
    jspec = jdb.spec_from_config(cfg, **kw)._replace(
        slab_level0=True, slab_level1=True
    )
    tspec = tdb.spec_from_config(configs.model_config("Car", T=2), **kw)
    tspec = tspec._replace(slab_level0=True, slab_level1=True)
    return jspec, tspec


def test_spec_matches_jax():
    jspec, tspec = _specs()
    assert tspec.num_points == jspec.num_points
    assert tspec.voxel_size == jspec.voxel_size
    for lj, lt in ((jspec.level0, tspec.level0), (jspec.level1, tspec.level1)):
        assert (lt.radius, lt.slab_cell, lt.slab_grid, lt.slab_halo) == (
            lj.radius, lj.slab_cell, lj.slab_grid, lj.slab_halo
        )
        assert tdb.slab_kernel_wiring(lt) == {
            k: v for k, v in jdb.slab_kernel_wiring(lj).items()
            if k != "zscan"
        }


def test_synthetic_frame_is_the_same():
    a, la = synthetic_lidar_frame(seed=7, n_beams=16, points_per_beam=64)
    b, lb = port_synthetic_lidar_frame(seed=7, n_beams=16,
                                       points_per_beam=64)
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.attr, b.attr)
    assert la == lb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_padded_graph_bitwise(seed):
    jspec, tspec = _specs()
    pts = _frame(seed)
    packed = jdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    np.testing.assert_array_equal(
        packed, tdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    )
    jg = jax.device_get(jax.jit(
        lambda p: jdb.build_padded_graph(*jdb.unpack_points(p), jspec)
    )(packed))
    tg = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)), tspec
    )
    for name in BITWISE:
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for lvl in range(2):
        np.testing.assert_array_equal(
            np.asarray(jg.keypoint_indices[lvl]),
            tg.keypoint_indices[lvl].numpy(),
        )
    for lvl in range(3):
        np.testing.assert_array_equal(
            np.asarray(jg.vertex_mask[lvl]), tg.vertex_mask[lvl].numpy()
        )
        np.testing.assert_array_equal(
            np.asarray(jg.vertex_xyz[lvl]), tg.vertex_xyz[lvl].numpy()
        )
    n_kp = int(tg.vertex_mask[1].sum())
    if seed == 2:
        assert 0 < n_kp < NUM_KEYPOINTS
        assert tg.vertex_mask[0].sum() < NUM_POINTS
    stats_j = jdb.host_overflow_stats(pts.xyz, jspec)
    assert tdb.host_overflow_stats(pts.xyz, tspec) == stats_j


def test_voxel_select_keeps_lowest_index_per_voxel():
    """Stable sort trap: many points share a voxel, and the
    representative must be the lowest index, as in JAX."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 2, size=(600, 3)).astype(np.float32)
    mask = np.ones(600, bool)
    mask[550:] = False
    ij, mj = jax.jit(lambda x, m: jdb.voxel_select(x, m, 0.8, 64))(xyz, mask)
    it, mt = tdb.voxel_select(
        torch.from_numpy(xyz), torch.from_numpy(mask), 0.8, 64
    )
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    # capacity below the occupied voxels: static-size compaction keeps
    # the first ones in key order
    ij, mj = jax.jit(lambda x, m: jdb.voxel_select(x, m, 0.4, 16))(xyz, mask)
    it, mt = tdb.voxel_select(
        torch.from_numpy(xyz), torch.from_numpy(mask), 0.4, 16
    )
    assert mt.all()
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())


def test_cell_offsets_drop_scatter():
    """Empty cells, repeated cells and pad rows (cell == num_cells)."""
    cells = np.array([0, 0, 3, 3, 3, 7, 9, 9, 16, 16], np.int32)
    j = np.asarray(jdb._cell_offsets(jax.numpy.asarray(cells), 16))
    t = tdb._cell_offsets(torch.from_numpy(cells), 16).numpy()
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(
        t, np.searchsorted(cells, np.arange(17)).astype(np.int32)
    )
