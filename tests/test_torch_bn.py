"""Batch and instance norm in the port against the JAX package
(``tests/test_bn.py`` is the JAX package's own account of them).

- init carries slim's moving averages (0 / 1) beside ``beta``, in the JAX
  tree; a NONE config carries none;
- normalizing with stored averages equals batch normalization when one
  update at decay 0 stored the batch statistics, and both equal the JAX
  MLP's;
- two train steps on a host-built graph update every moving average leaf
  for leaf as the JAX step does (rtol 1e-4, atol 1e-6), with every norm
  type in one model (pooling point MLP ``fused_BN_center``, output MLP
  ``BN_center``, edge MLP ``BN``, update MLP ``IN``, auto-offset MLP
  ``fused_BN_center``, predictor ``BN_center``); the losses of both steps
  at rtol 1e-5;
- instance norm alone trains in 16 edge chunks with statistics per
  chunk, as in JAX (loss at rtol 1e-5; both packages' f32 gradients
  against the port's float64 ones);
- the test mode normalizes with the stored averages (against the JAX
  model on the same parameters, logits within 1e-4 of ``(1 + max|l|)``,
  and unlike the batch statistics);
- serving a BN config turns the slab and tail paths off and runs the
  segment path.

f32 on both sides, JAX at matmul precision "highest".
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.graph import pad as jpad
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.nn import mlp as jmlp
from pointgnn_tpu.parallel import step as jstep
from pointgnn_tpu.train import checkpoint as jax_ckpt
from pointgnn_tpu.train import optimizers as jopt
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.graph import pad
from pointgnn_tpu_torch.infer import InferencePipeline
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.nn import mlp
from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import optimizers as topt
from test_parallel import CAP, LOSS_CFG, _frame
from test_torch_configs import narrow_config
from test_torch_train_step import _grads_tree

import convert_jax_checkpoint

MIXED = {
    "point_MLP_normalization_type": "fused_BN_center",
    "output_MLP_normalization_type": "BN_center",
    "edge_MLP_normalization_type": "BN",
    "update_MLP_normalization_type": "IN",
    "auto_offset_MLP_normalization_type": "fused_BN_center",
    "normalization_type": "BN_center",
}
TRAIN_CONFIG = {"initial_lr": 0.01, "decay_step": 1000, "decay_factor": 0.1,
                "optimizer": "sgd"}


def norm_configs(norms):
    """car T=1 at widths 16-32 with the given normalization per MLP
    kind (a dict, or one type for every MLP)."""
    lcs = narrow_config("car_auto_T1_train")["model_kwargs"]["layer_configs"]
    for lc in lcs:
        for key in lc["kwargs"]:
            if key.endswith("normalization_type"):
                lc["kwargs"][key] = (norms if isinstance(norms, str)
                                     else norms[key])
    return lcs


def _ema_leaves(tree, path=()):
    """``{path: array}`` of every moving average in a parameter tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ema_leaves(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_ema_leaves(v, path + (i,)))
        return out
    if path and path[-1] in mlp.EMA_KEYS:
        return {path: np.asarray(tree.detach().cpu() if isinstance(
            tree, torch.Tensor) else tree)}
    return {}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


def test_init_carries_slim_moving_averages():
    model = PointGNN(4, 7, norm_configs(MIXED), mode="train")
    assert model._has_bn and model.edge_chunks == 1
    params = model.init(0, 1, "cpu")
    emas = _ema_leaves(params)
    assert len(emas) > 0
    for key, val in emas.items():
        np.testing.assert_array_equal(val, 0.0 if key[-1] == "ema_mean"
                                      else 1.0)
    # the JAX model's tree: the same keys and shapes, beta where centered
    jparams = jax.eval_shape(
        lambda key: JaxPointGNN(4, 7, norm_configs(MIXED),
                                mode="train").init(key, 1),
        jax.random.PRNGKey(0))
    tparams = jax.tree_util.tree_map(
        lambda t: t.numpy(), params, is_leaf=lambda t: isinstance(
            t, torch.Tensor))
    assert _shapes(tparams) == _shapes(jparams)
    # NONE configs carry no moving averages; a predictor without a
    # normalization_type has the JAX default, fused_BN_center
    plain = norm_configs("NONE")
    assert not _ema_leaves(PointGNN(4, 7, plain).init(0, 1, "cpu"))
    del plain[-1]["kwargs"]["normalization_type"]
    default = PointGNN(4, 7, plain, mode="train")
    assert default._has_bn and default.edge_chunks == 1
    assert set(k[0] for k in _ema_leaves(default.init(0, 1, "cpu"))) == {
        plain[-1]["scope"]}


def test_stored_stats_match_batch_stats_at_decay_zero():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32) * 3 + 1
    mask = (rng.rand(64) > 0.3).astype(np.float32)
    jparams = jax.device_get(jmlp.init_mlp(jax.random.PRNGKey(1), 8,
                                           [16, 16], "fused_BN_center"))
    params = params_from_jax(jparams, "cpu")
    collect = {}
    y_batch = mlp.apply_mlp(params, torch.from_numpy(x),
                            normalization_type="fused_BN_center",
                            mask=torch.from_numpy(mask), bn_collect=collect)
    assert set(collect) == {(0,), (1,)}
    mlp.update_bn_ema(params, collect, decay=0.0)
    y_stored = mlp.apply_mlp(params, torch.from_numpy(x),
                             normalization_type="fused_BN_center",
                             mask=torch.from_numpy(mask), bn_use_stored=True)
    np.testing.assert_allclose(y_batch.numpy(), y_stored.numpy(), rtol=1e-5,
                               atol=1e-5)
    jcollect = {}
    with jax.default_matmul_precision("highest"):
        want = jmlp.apply_mlp(jparams, jnp.asarray(x),
                              normalization_type="fused_BN_center",
                              mask=jnp.asarray(mask), bn_collect=jcollect)
    np.testing.assert_allclose(y_batch.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key, stats in jcollect.items():
        for a, b in zip(collect[key], stats):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    for norm in ("BN", "IN"):
        got = mlp.apply_mlp(params, torch.from_numpy(x),
                            normalization_type=norm,
                            mask=torch.from_numpy(mask))
        with jax.default_matmul_precision("highest"):
            want = jmlp.apply_mlp(jparams, jnp.asarray(x),
                                  normalization_type=norm,
                                  mask=jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=norm)


def test_train_steps_update_ema_like_jax():
    """Two sgd steps (decay 0.9) on a host-built graph with every norm
    type: the losses, every moving average and every parameter against
    the JAX step; then the test mode's forward with the stored
    averages."""
    lcs = norm_configs(MIXED)
    graph = jpad.pad_frame(_frame(np.random.RandomState(2)), CAP)
    jmodel = JaxPointGNN(4, 7, lcs, mode="train")
    tmodel = PointGNN(4, 7, lcs, mode="train")
    assert jmodel.edge_chunks == tmodel.edge_chunks
    assert tmodel.edge_chunks == 1
    # glorot weights from a numpy seed, in the JAX package's tree
    jparams = params_to_numpy(tmodel.init(0, 1, "cpu"))
    jo, _ = jopt.build_from_train_config(TRAIN_CONFIG)
    jstate = jstep.init_train_state(jparams, jo)
    jstep_fn = jstep.make_train_step(jmodel, jo, LOSS_CFG, mesh=None,
                                     bn_decay=0.9)
    params = params_from_jax(jax.device_get(jparams), "cpu")
    for key, t in mlp.named_leaves(params):
        t.requires_grad_(key not in mlp.EMA_KEYS)
    to, _ = topt.build_from_train_config(TRAIN_CONFIG)
    tstate = tstep.init_train_state(params, to)
    tstep_fn = tstep.make_train_step(tmodel, to, LOSS_CFG, bn_decay=0.9)
    tgraph = pad.to_device(graph, "cpu")
    for step in range(2):
        with jax.default_matmul_precision("highest"):
            jstate, jaux = jstep_fn(jstate, graph)
        tstate, taux = tstep_fn(tstate, tgraph)
        assert "bn_stats" not in taux
        for k in ("cls_loss", "loc_loss", "total_loss"):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-5, err_msg=(step, k))
    jp = jax.device_get(jstate.params)
    want, got = _ema_leaves(jp), _ema_leaves(tstate.params)
    assert set(got) == set(want)
    assert len(want) > 0
    moved = 0
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-4, atol=1e-6,
                                   err_msg=str(key))
        start = 0.0 if key[-1] == "ema_mean" else 1.0
        moved += not np.allclose(val, start)
        if key[-1] == "ema_var":
            assert (val >= 0).all()
    assert moved > 0
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jp),
                            topt.param_leaves(tstate.params)):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.detach().numpy(), j, rtol=1e-4, atol=1e-5 * (1 + np.abs(
                j).max()), err_msg=jax.tree_util.keystr(path))
    # the test mode reads the stored averages (the JAX model's too), on
    # the JAX step's parameters
    with jax.default_matmul_precision("highest"):
        jlogits, _ = jax.jit(JaxPointGNN(4, 7, lcs, mode="test").apply)(
            jp, graph)
    with torch.no_grad():
        stored, _ = PointGNN(4, 7, lcs, mode="test").apply(
            params_from_jax(jp, "cpu"), tgraph)
        batch, _ = tmodel.apply(params_from_jax(jp, "cpu"), tgraph)
    # instance norm (eps 1e-12) amplifies f32 rounding: the gradients'
    # tolerance, 1e-4 of (1 + max |logit|)
    np.testing.assert_allclose(
        stored.numpy(), np.asarray(jlogits), rtol=1e-4,
        atol=1e-4 * (1 + np.abs(np.asarray(jlogits)).max()))
    assert np.isfinite(stored.numpy()).all()
    assert not np.allclose(stored.numpy(), batch.numpy())


def _double(tree):
    return jax.tree_util.tree_map(
        lambda t: t.to(torch.float64), tree,
        is_leaf=lambda t: isinstance(t, torch.Tensor))


def test_chunked_instance_norm_matches_jax():
    """Instance norm alone trains in 16 edge chunks, each normalized over
    its own rows, as in JAX: the loss at rtol 1e-5.  Instance norm's eps
    (1e-12) amplifies f32 rounding in the gradients, so both f32
    gradients are held against the port's float64 evaluation of the
    same step, within 5e-3 of ``(1 + max|g|)``: the port's and the JAX
    package's f32 rounding, not their semantics, part them."""
    lcs = norm_configs("IN")
    graph = jpad.pad_frame(_frame(np.random.RandomState(2)), CAP)
    jmodel = JaxPointGNN(4, 7, lcs, mode="train")
    tmodel = PointGNN(4, 7, lcs, mode="train")
    assert not tmodel._has_bn and jmodel.edge_chunks == 16
    assert tmodel.edge_chunks == 16
    jparams = params_to_numpy(tmodel.init(0, 1, "cpu"))
    with jax.default_matmul_precision("highest"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jmodel, LOSS_CFG), has_aux=True))(jparams,
                                                                graph)
    tgraph = pad.to_device(graph, "cpu")
    loss_fn = tstep.make_loss_fn(tmodel, LOSS_CFG)
    runs = []
    for dtype in (torch.float32, torch.float64):
        params = params_from_jax(jparams, "cpu")
        g = tgraph
        if dtype == torch.float64:
            params = _double(params)
            g = tgraph._replace(**{k: _double(getattr(tgraph, k)) for k in (
                "features", "vertex_xyz", "vertex_mask", "encoded_boxes",
                "valid_boxes")})
        for t in topt.param_leaves(params):
            t.requires_grad_(True)
        loss, _ = loss_fn(params, g)
        loss.backward()
        runs.append((float(loss),
                     jax.tree_util.tree_leaves(_grads_tree(params))))
    (loss32, grads32), (loss64, grads64) = runs
    np.testing.assert_allclose(loss32, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss64, float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(jleaves) == len(grads32)
    for (path, j), t32, t64 in zip(jleaves, grads32, grads64):
        tol = 5e-3 * (1 + np.abs(t64).max())
        name = jax.tree_util.keystr(path)
        assert np.abs(t32 - t64).max() <= tol, name
        assert np.abs(np.asarray(j) - t64).max() <= tol, name


def test_serving_a_bn_config_takes_the_segment_path(tmp_path):
    """A BN config turns off the slab and tail fast paths (they need
    NONE normalization) and serves through test mode with the stored
    averages; a JAX BN checkpoint converts (``beta``, ``ema_mean`` and
    ``ema_var`` bit for bit) and serves on host graphs."""
    cfg = configs.model_config("Car", T=1)
    cfg["model_kwargs"]["layer_configs"] = norm_configs("fused_BN_center")
    spec = tdb.spec_from_config(cfg, num_points=2048, num_keypoints=512,
                                runtime=True, cell_caps=(16, 32),
                                per_center_caps=(8, 16))
    pipe = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             use_box_score=False, device="cpu")
    assert pipe.slab is False and pipe.pallas_tail is False
    assert not (pipe.device_spec.slab_level0 or pipe.device_spec.slab_level1)
    assert pipe.model._has_bn and pipe.model.edge_chunks == 1
    points, _ = synthetic_lidar_frame(seed=0, n_beams=8, points_per_beam=60)
    assert pipe.run_frame(points) is not None
    # a JAX checkpoint with moved averages, through the converter
    jparams = params_to_numpy(pipe.model.init(0, 1, "cpu"))
    rng = np.random.default_rng(0)
    for path, val in _ema_leaves(jparams).items():
        node = jparams
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = (val + rng.uniform(0.1, 1.0, val.shape)).astype(
            np.float32)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, 3, {"params": jparams}, config=cfg)
    convert_jax_checkpoint.convert(jax_dir, port_dir)
    host = InferencePipeline(cfg, checkpoint_dir=port_dir,
                             use_box_score=False, device="cpu")
    assert host.restored_step == 3
    want = jax.tree_util.tree_leaves(jparams)
    got = jax.tree_util.tree_leaves(params_to_numpy(host.params))
    assert len(got) == len(want) and len(_ema_leaves(jparams)) > 0
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(got, want))
    assert host.run_frame(points, np.random.default_rng(0)) is not None
