"""Union training step of ``car_fixed_T3_train`` (no auto-offset MLP)
against ``jax.value_and_grad``, narrowed to widths 16-32 and one GNN
layer (``union_step_case`` also runs ped_cyl's step in
``test_torch_configs_ped_cyl.py``).

As in ``test_torch_train_step.py``: two frames, the same packed labels,
parameters (``params_from_jax``) and graph randomization (the
``jax.random`` draws injected into the port); the loss terms and every
parameter gradient, f32, with the JAX slab kernels in interpret mode.
"""

import warnings

import numpy as np
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.graph import device_labels as jdl
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.parallel import step as jstep
from pointgnn_tpu.train import device_pipeline as jdpipe
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch.data.labels import LABEL_METHODS
from pointgnn_tpu_torch.graph import device_labels as tdl
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import device_pipeline as tdpipe
from pointgnn_tpu_torch.train import optimizers as topt
from test_torch_configs import (
    NUM_POINTS, narrow_config, port_spec, small_spec,
)
from test_torch_train import _jax_draws, _torch_draws
from test_torch_train_step import _grads_tree

# (box name, l, w, h) placed on the frame's own points, so keypoints
# carry localization targets of every class of the config
BOXES = {
    "Car": (("Car", 6.0, 3.0, 2.5),),
    "Pedestrian_and_Cyclist": (("Pedestrian", 2.0, 2.0, 2.5),
                               ("Cyclist", 3.0, 2.0, 2.5)),
}


def _frame(seed, label_method):
    pts, labels = synthetic_lidar_frame(seed=seed, n_beams=16,
                                        points_per_beam=64)
    xyz = pts.xyz[:NUM_POINTS]
    labels = list(labels)
    for i, (name, l, w, h) in enumerate(BOXES[label_method]):
        c = xyz[(i + 1) * len(xyz) // 4]
        labels.append({
            "name": name, "x3d": float(c[0]), "y3d": float(c[1]) + 0.5,
            "z3d": float(c[2]), "length": l, "width": w, "height": h,
            "yaw": 0.3 + seed + i, "truncation": 0.0, "occlusion": 0,
            "alpha": 0, "xmin": 0, "ymin": 0, "xmax": 100, "ymax": 100,
        })
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        packed = jdb.pack_points(pts.xyz, pts.attr[:, :1], NUM_POINTS)
    return packed, labels


def union_step_case(name):
    cfg = narrow_config(name)
    spec = small_spec(cfg)
    label_map, num_classes = LABEL_METHODS[cfg["label_method"]]
    assert num_classes == cfg["num_classes"]
    frames = [_frame(s, cfg["label_method"]) for s in (2, 3)]
    jframes = [jdpipe.DeviceFrame(p, jdl.pack_frame_labels(
        lb, label_map, num_classes)) for p, lb in frames]
    jbatch = jax.tree_util.tree_map(jnp.asarray,
                                    jdpipe.stack_frames(jframes))
    dspec_j, extra_j = jdpipe.resolve_device_setup(cfg, spec=spec, slab=True)
    jmodel = JaxPointGNN(num_classes=num_classes, box_encoding_len=7,
                         mode="train", **extra_j, **cfg["model_kwargs"])
    jbuild = jdpipe.make_graph_builder(dspec_j, jmodel.output_graph_level,
                                       cfg)
    jsums = jstep.make_union_sums_fn(jmodel, jax_loss_config(cfg), jbuild, 2)
    key = jax.random.PRNGKey(5)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(2), 1))

    def lossf(p):
        acc, reg = jsums(p, jbatch, key)
        cls = acc["cls_w"] / jnp.maximum(acc["n_ep"], 1.0)
        loc = acc["loc_w"] / jnp.maximum(acc["n_val"], 1.0)
        return cls + loc + reg, (cls, loc, reg, acc["n_val"])

    (jtotal, (jcls, jloc, jreg, jnval)), jgrads = jax.jit(
        jax.value_and_grad(lossf, has_aux=True))(jparams)
    draws = [_torch_draws(_jax_draws(jax.random.fold_in(key, f),
                                     NUM_POINTS)) for f in range(2)]

    dspec, extra = tdpipe.resolve_device_setup(cfg, port_spec(spec))
    tmodel = PointGNN(num_classes=num_classes, box_encoding_len=7,
                      mode="train", **extra, **cfg["model_kwargs"])
    tbuild = tdpipe.make_graph_builder(dspec, tmodel.output_graph_level,
                                       cfg)
    tsums = tstep.make_union_sums_fn(tmodel, loss_config(cfg), tbuild, 2)
    params = params_from_jax(jparams, device="cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    tframes = [tdpipe.DeviceFrame(p, tdl.pack_frame_labels(
        lb, label_map, num_classes)) for p, lb in frames]
    tbatch = tdpipe.frames_to_device(tdpipe.stack_frames(tframes), "cpu")
    acc, reg = tsums(params, tbatch, draws)
    cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
    loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
    total = cls + loc + reg
    total.backward()

    assert float(jnval) > 0 and float(acc["n_val"]) == float(jnval)
    for term, t, j in (("total", total, jtotal), ("cls", cls, jcls),
                       ("loc", loc, jloc), ("reg", reg, jreg)):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-5,
                                   err_msg=term)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tleaves = jax.tree_util.tree_leaves(_grads_tree(params))
    assert len(jleaves) == len(tleaves) > 0
    # car_fixed has no auto-offset MLP in either tree
    paths = [jax.tree_util.keystr(p) for p, _ in jleaves]
    assert any("auto_offset" in p for p in paths) == ("auto" in name)
    for (path, jg), tg in zip(jleaves, tleaves):
        jg = np.asarray(jg)
        assert tg.shape == jg.shape, path
        # as test_torch_train_step.py: f32 sums in other orders through
        # the chain rule, 1e-4 of the leaf's own scale
        tol = 1e-4 * (1.0 + np.abs(jg).max())
        err = np.abs(tg - jg).max()
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def test_car_fixed_union_step_matches_jax():
    union_step_case("car_fixed_T3_train")
