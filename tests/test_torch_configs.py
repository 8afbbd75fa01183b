"""Every shipped configuration through the port, against the JAX package.

Each of the seven named configs, with its MLP widths narrowed to 16-32
and its depth cut to at most one GNN layer (CPU-sized), runs the same
slab graph and parameters (handed over through ``params_from_jax``)
through both models: logits and box encodings in f32.  The union
training step of ``car_fixed_T3_train`` is in
``test_torch_configs_step.py``; ped_cyl's training graph and union step
are in ``test_torch_configs_ped_cyl.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax

NUM_POINTS, NUM_KEYPOINTS = 1024, 256
# as tests/test_torch_model.py: the two frameworks sum the same f32
# products in other orders, a few ulps on values of order 1
TOL = dict(rtol=1e-4, atol=1e-4)


def narrow_config(name, max_gnn_layers=1):
    """The named config with MLP widths narrowed to 16-32 and at most
    ``max_gnn_layers`` GNN layers (the predictor is kept)."""
    cfg = jax_configs.get_config(name)
    assert cfg == configs.get_config(name)
    layers = cfg["model_kwargs"]["layer_configs"]
    layers[:] = layers[:-1][:1 + max_gnn_layers] + layers[-1:]
    for lc in layers[:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    return cfg


def small_spec(cfg):
    """Training-graph spec (the config's train graph kwargs) at the
    CPU-sized capacity, both slab levels on."""
    return jdb.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS,
        runtime=False,
    )._replace(slab_level0=True, slab_level1=True)


def port_spec(spec):
    """The port's DeviceGraphSpec with the JAX spec's values (the port's
    LevelSpec has no ``approx_recall``: it never compacts approximately)."""
    def level(lv):
        return tdb.LevelSpec(**{f: getattr(lv, f)
                                for f in tdb.LevelSpec._fields})

    return tdb.DeviceGraphSpec(spec.num_points, spec.num_keypoints,
                               spec.voxel_size, level(spec.level0),
                               level(spec.level1), spec.slab_level1,
                               spec.slab_level0)


def frame_points(seed):
    pts, _ = synthetic_lidar_frame(seed=seed, n_beams=16,
                                   points_per_beam=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)


def _models(cfg, spec):
    wiring = {lvl: jdb.slab_kernel_wiring(getattr(spec, "level%d" % lvl))
              for lvl in (0, 1)}
    n = cfg["num_classes"]
    jmodel = JaxPointGNN(
        num_classes=n, box_encoding_len=7, mode="test", compute_dtype=None,
        edge_sentinel="src", slab_level1=wiring[1], slab_level0=wiring[0],
        **cfg["model_kwargs"],
    )
    tmodel = PointGNN(
        num_classes=n, box_encoding_len=7, mode="test", compute_dtype=None,
        slab_level1=tdb.slab_kernel_wiring(port_spec(spec).level1),
        slab_level0=tdb.slab_kernel_wiring(port_spec(spec).level0),
        **cfg["model_kwargs"],
    )
    return jmodel, tmodel


@pytest.mark.parametrize("name", configs.list_configs())
def test_named_config_forward_matches_jax(name):
    assert len(configs.list_configs()) == 7
    cfg = narrow_config(name)
    spec = small_spec(cfg)
    jmodel, tmodel = _models(cfg, spec)
    packed = frame_points(0)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1), 1))

    @jax.jit
    def jfwd(params, packed):
        graph = jdb.build_padded_graph(*jdb.unpack_points(packed), spec)
        return jmodel.apply(params, graph)

    jlogits, jenc = jax.device_get(jfwd(jparams, packed))
    graph = tdb.build_padded_graph(
        *tdb.unpack_points(torch.from_numpy(packed)),
        port_spec(spec),
    )
    logits, enc = tmodel.apply(params_from_jax(jparams, "cpu"), graph)
    assert logits.shape == jlogits.shape == (NUM_KEYPOINTS,
                                             cfg["num_classes"])
    assert enc.shape == jenc.shape
    assert tmodel.output_graph_level == jmodel.output_graph_level
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    np.testing.assert_allclose(enc.numpy(), jenc, **TOL)
