"""ped_cyl_auto_T3_trainval's training path against the JAX package: its
training graph (train scale 0.5: 0.4 m voxels, radii 0.4 / 1.6 m) bitwise
with the same injected randomization, and a union step (6 classes,
Pedestrian and Cyclist targets) against ``jax.value_and_grad``, narrowed
to widths 16-32 and one GNN layer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu_torch.graph import device_builder as tdb
from test_torch_configs import (
    NUM_KEYPOINTS, NUM_POINTS, frame_points, narrow_config, port_spec,
    small_spec,
)
from test_torch_configs_step import union_step_case
from test_torch_train import _jax_draws, _torch_draws


def test_ped_cyl_training_graph_matches_jax():
    """ped_cyl's training graph (scale 0.5: 0.4 m voxels, radii 0.4 /
    1.6 m) with the same randomization: slab metadata, vertices and
    keypoint indices bitwise."""
    cfg = narrow_config("ped_cyl_auto_T3_trainval")
    spec = small_spec(cfg)
    assert spec.voxel_size == pytest.approx(0.4)
    assert (spec.level0.radius, spec.level1.radius) == (0.4, 1.6)
    tspec = tdb.spec_from_config(cfg, num_points=NUM_POINTS,
                                 num_keypoints=NUM_KEYPOINTS, runtime=False)
    assert tspec == port_spec(spec)._replace(slab_level0=False,
                                             slab_level1=False)
    packed = frame_points(1)
    key = jax.random.PRNGKey(11)
    jg = jax.device_get(jax.jit(
        lambda x, k: jdb.build_padded_graph(*jdb.unpack_points(x), spec,
                                            rnd_key=k)
    )(jnp.asarray(packed), key))
    tg = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)),
        port_spec(spec),
        rnd=_torch_draws(_jax_draws(key, NUM_POINTS)),
    )
    for name in ("slab_offsets", "slab_center_cell", "slab0_offsets",
                 "slab0_center_cell"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    for lvl in range(3):
        np.testing.assert_array_equal(tg.vertex_xyz[lvl].numpy(),
                                      np.asarray(jg.vertex_xyz[lvl]))
        np.testing.assert_array_equal(tg.vertex_mask[lvl].numpy(),
                                      np.asarray(jg.vertex_mask[lvl]))
    np.testing.assert_array_equal(tg.keypoint_indices[0].numpy(),
                                  np.asarray(jg.keypoint_indices[0]))


def test_ped_cyl_union_step_matches_jax():
    union_step_case("ped_cyl_auto_T3_trainval")
