"""The port's capped radius edge lists and edge-list graphs against JAX.

``radius_edges`` (sources in dense cell tables, 3x3 cell gather, exact
f32 distance test, top-k compaction to ``per_center_cap``) and
``build_padded_graph`` on edge-list levels (``slab=False``) and the mixed
``"l1"`` mode must give bitwise-equal edges, integer metadata and
counters.  The caps are small so that centers saturate and cells
overflow.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch.graph import device_builder as tdb

NUM_POINTS, NUM_KEYPOINTS = 1024, 256
CAPS = dict(per_center_caps=(8, 16), cell_caps=(16, 32))


def _cloud(seed, n, extent=20.0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    xyz[:, 1] = rng.uniform(-1, 2, n)
    # a dense clump: overfull cells and saturated centers
    xyz[: n // 8] = (xyz[: n // 8] * 0.05 + 5.0).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n - n // 10:] = False
    return xyz, mask


def _port_level(level):
    return tdb.LevelSpec(**{f: getattr(level, f)
                            for f in tdb.LevelSpec._fields})


LEVELS = {
    "l0_like": jdb.LevelSpec(1.0, 16, 8, grid_xz=32),
    "l1_like": jdb.LevelSpec(2.5, 32, 16, grid_xz=16),
    "approx": jdb.LevelSpec(2.5, 32, 16, grid_xz=16, approx_topk=True),
}


@pytest.mark.parametrize("name", sorted(LEVELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_radius_edges_bitwise(name, seed):
    level = LEVELS[name]
    src, smask = _cloud(seed, 768)
    if name == "l0_like":
        # distinct center set with masked centers
        rng = np.random.default_rng(seed + 10)
        ctr = src[rng.choice(600, 200, replace=False)]
        cmask = np.ones(200, bool)
        cmask[::17] = False
    else:
        ctr, cmask = src, smask
    js, jd, jc = jax.jit(
        lambda a, b, c, d: jdb.radius_edges(a, b, c, d, level,
                                            return_counts=True)
    )(src, smask, ctr, cmask)
    ts, td, tc = tdb.radius_edges(
        torch.from_numpy(src), torch.from_numpy(smask),
        torch.from_numpy(ctr), torch.from_numpy(cmask),
        _port_level(level), return_counts=True,
    )
    assert ts.dtype == td.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert set(tc) == set(jc)
    for key in jc:
        assert int(tc[key]) == int(jc[key]), key
    # the caps bite: truncated centers and dropped sources occur
    assert int(tc["saturated_centers"]) > 0
    assert int(tc["cell_overflow_sources"]) > 0
    # SRC-sentinel layout: pad slots carry n, dst is the owning center
    n, k, s = src.shape[0], ctr.shape[0], level.per_center_cap
    assert (ts.numpy() <= n).all() and (ts.numpy() == n).any()
    np.testing.assert_array_equal(td.numpy(), np.repeat(np.arange(k), s))


def test_radius_edges_without_counts_and_empty_centers():
    level = _port_level(LEVELS["l1_like"])
    src, smask = _cloud(3, 256)
    cmask = np.zeros(256, bool)  # no valid center: every slot is padding
    es, ed = tdb.radius_edges(
        torch.from_numpy(src), torch.from_numpy(smask),
        torch.from_numpy(src), torch.from_numpy(cmask), level,
    )
    assert (es == 256).all()
    assert es.shape == ed.shape == (256 * level.per_center_cap,)


def _frame(seed):
    pts, _ = synthetic_lidar_frame(seed=seed, n_beams=16, points_per_beam=64)
    return jdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)


@pytest.mark.parametrize("mode", ["edges", "l1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_padded_graph_edge_lists_bitwise(mode, seed):
    cfg = jax_configs.model_config("Car", T=2)
    jspec = jdb.spec_from_config(cfg, num_points=NUM_POINTS,
                                 num_keypoints=NUM_KEYPOINTS, **CAPS)
    if mode == "l1":
        jspec = jspec._replace(slab_level1=True)
    tspec = tdb.DeviceGraphSpec(
        jspec.num_points, jspec.num_keypoints, jspec.voxel_size,
        _port_level(jspec.level0), _port_level(jspec.level1),
        jspec.slab_level1, jspec.slab_level0,
    )
    packed = _frame(seed)
    jg, jc = jax.device_get(jax.jit(
        lambda p: jdb.build_padded_graph(*jdb.unpack_points(p), jspec,
                                         return_counters=True)
    )(jnp.asarray(packed)))
    tg, tc = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)), tspec,
        return_counters=True,
    )
    assert set(tc) == set(jc)
    for key in jc:
        assert int(tc[key]) == int(jc[key]), key
    assert int(tc["l0_saturated_centers"]) > 0
    for lvl in range(2):
        for field in ("edges_src", "edges_dst", "keypoint_indices"):
            a = np.asarray(getattr(jg, field)[lvl])
            b = getattr(tg, field)[lvl].numpy()
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg="%s %d"
                                          % (field, lvl))
    for lvl in range(3):
        np.testing.assert_array_equal(np.asarray(jg.vertex_xyz[lvl]),
                                      tg.vertex_xyz[lvl].numpy())
        np.testing.assert_array_equal(np.asarray(jg.vertex_mask[lvl]),
                                      tg.vertex_mask[lvl].numpy())
    np.testing.assert_array_equal(np.asarray(jg.features),
                                  tg.features.numpy())
    for name in ("slab_offsets", "slab_center_cell", "slab0_offsets",
                 "slab0_center_cell"):
        a, b = getattr(jg, name), getattr(tg, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if mode == "l1":
        # level 1 is slab: its edge list is the 1-edge dummy
        assert tg.edges_src[1].shape == (1,)
        assert "l1_saturated_centers" not in tc
    else:
        assert tg.edges_src[1].shape == (
            NUM_KEYPOINTS * jspec.level1.per_center_cap,)


def test_randomized_edge_list_graph_matches_jax():
    """Injected training draws: the counters follow the shifted grid."""
    cfg = jax_configs.model_config("Car", T=2)
    jspec = jdb.spec_from_config(cfg, num_points=NUM_POINTS,
                                 num_keypoints=NUM_KEYPOINTS, **CAPS)
    tspec = tdb.DeviceGraphSpec(
        jspec.num_points, jspec.num_keypoints, jspec.voxel_size,
        _port_level(jspec.level0), _port_level(jspec.level1),
    )
    packed = _frame(2)
    key = jax.random.PRNGKey(3)
    jg, jc = jax.device_get(jax.jit(
        lambda p, k: jdb.build_padded_graph(*jdb.unpack_points(p), jspec,
                                            return_counters=True, rnd_key=k)
    )(jnp.asarray(packed), key))
    kshift, kperm = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.uniform(kshift, (3,)))),
             torch.from_numpy(np.array(
                 jax.random.permutation(kperm, NUM_POINTS))))
    tg, tc = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)), tspec, rnd=draws,
        return_counters=True,
    )
    for key_ in jc:
        assert int(tc[key_]) == int(jc[key_]), key_
    for lvl in range(2):
        np.testing.assert_array_equal(np.asarray(jg.edges_src[lvl]),
                                      tg.edges_src[lvl].numpy())
    np.testing.assert_array_equal(np.asarray(jg.keypoint_indices[0]),
                                  tg.keypoint_indices[0].numpy())


def test_spec_carries_the_edge_list_caps():
    cfg = jax_configs.model_config("Car", T=3)
    kw = dict(num_points=2048, num_keypoints=512, approx_topk=True, **CAPS)
    jspec = jdb.spec_from_config(cfg, **kw)
    from pointgnn_tpu_torch import configs

    tspec = tdb.spec_from_config(configs.model_config("Car", T=3), **kw)
    for lj, lt in ((jspec.level0, tspec.level0),
                   (jspec.level1, tspec.level1)):
        assert lt == _port_level(lj)
