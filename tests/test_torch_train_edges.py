"""Edge-list training and evaluation (``device_graph_slab: false``) in
the port against the JAX package.

The same numpy inputs go through both packages (frames, packed labels,
parameters through ``params_from_jax`` and the ``jax.random`` graph
draws injected into the port):

- the randomized training graph with capped SRC-sentinel edge lists, its
  labels and encoded boxes: integer metadata bitwise;
- one two-frame union step on those graphs (the segment path in 16
  checkpointed chunks): loss terms at rtol 1e-5, every gradient within
  1e-4 of ``(1 + max|g|)``;
- a pad slot (``src == N``, a real destination) never wins the max and
  receives no gradient;
- the routing frozen into the saved train_config, for a port run and for
  a train_config the JAX package froze.

A JAX edge-list checkpoint evaluated by the port is in
``test_torch_train_edges_eval.py`` (each file stays under 30 s).  f32 on
both sides, JAX at matmul precision "highest".
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.graph import device_labels as jdl
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.parallel import step as jstep
from pointgnn_tpu.train import device_pipeline as jdpipe
from pointgnn_tpu.train import summary as jax_summary
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.data.labels import LABEL_MAP_CAR
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.graph import device_labels as tdl
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.nn import layers as tlayers
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import device_pipeline as tdpipe
from pointgnn_tpu_torch.train import optimizers as topt
from pointgnn_tpu_torch.train import pipeline as tpipe
from pointgnn_tpu_torch.train import summary as tsummary
from pointgnn_tpu_torch.train.trainer import Trainer
from pointgnn_tpu_torch.utils import config_io, synthetic_kitti
from test_torch_configs import narrow_config
from test_torch_train import (
    NUM_POINTS, _frame, _jax_draws, _spec, _torch_draws, small_config,
)
from test_torch_train_step import _grads_tree

RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _jsonl_summaries_only(monkeypatch):
    """Scalars go to the JSONL files only (a TensorBoard writer would
    import TensorFlow, ~16 s here)."""
    for module in (tsummary, jax_summary):
        monkeypatch.setattr(module, "_tb_writer", lambda directory: None)


def _setups(cfg):
    """The JAX and the port's edge-list setup from one small spec."""
    spec = _spec(cfg)
    jset = jdpipe.resolve_device_setup(cfg, spec=spec, slab=False)
    tset = tdpipe.resolve_device_setup(cfg, tdb.DeviceGraphSpec(*spec),
                                       slab=False)
    return jset, tset


def _labeled_frames(seeds, package):
    frames = [_frame(s) for s in seeds]
    if package == "jax":
        return [jdpipe.DeviceFrame(p, jdl.pack_frame_labels(
            lb, LABEL_MAP_CAR, 4)) for p, lb in frames]
    return [tdpipe.DeviceFrame(p, tdl.pack_frame_labels(
        lb, LABEL_MAP_CAR, 4)) for p, lb in frames]


def test_edge_list_training_graph_matches_jax():
    """The randomized edge-list graph and its labels, bitwise; the
    encoded boxes at f32 rounding."""
    cfg = small_config(T=2)
    (jspec, jextra), (tspec, textra) = _setups(cfg)
    assert not (jspec.slab_level0 or jspec.slab_level1)
    assert not (tspec.slab_level0 or tspec.slab_level1)
    assert jextra == textra == {"edge_sentinel": "src"}
    jframe = _labeled_frames([0], "jax")[0]
    tframe = tdpipe.frames_to_device(_labeled_frames([0], "torch")[0], "cpu")
    key = jax.random.PRNGKey(11)
    jg = jax.device_get(jax.jit(jdpipe.make_graph_builder(jspec, 2, cfg))(
        jax.tree_util.tree_map(jnp.asarray, jframe), key))
    tg = tdpipe.make_graph_builder(tspec, 2, cfg)(
        tframe, _torch_draws(_jax_draws(key, NUM_POINTS)))
    for lvl in range(2):
        for name in ("edges_src", "edges_dst"):
            a, b = getattr(tg, name)[lvl].numpy(), np.asarray(
                getattr(jg, name)[lvl])
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, lvl)
        # capped slots in the SRC layout: every destination is a real
        # center, pad slots carry the source sentinel
        assert (tg.edges_dst[lvl] < tg.vertex_xyz[1].shape[0]).all()
        assert (tg.edges_src[lvl] == tg.vertex_xyz[lvl].shape[0]).any()
    for lvl in range(3):
        np.testing.assert_array_equal(tg.vertex_xyz[lvl].numpy(),
                                      np.asarray(jg.vertex_xyz[lvl]))
        np.testing.assert_array_equal(tg.vertex_mask[lvl].numpy(),
                                      np.asarray(jg.vertex_mask[lvl]))
    np.testing.assert_array_equal(tg.cls_labels.numpy(),
                                  np.asarray(jg.cls_labels))
    np.testing.assert_array_equal(tg.valid_boxes.numpy(),
                                  np.asarray(jg.valid_boxes))
    np.testing.assert_allclose(tg.encoded_boxes.numpy(),
                               np.asarray(jg.encoded_boxes), rtol=1e-6,
                               atol=1e-6)
    assert tg.valid_boxes.sum() > 0


def test_edge_list_union_step_matches_jax():
    """One two-frame union step on randomized edge-list graphs (T=1):
    loss terms and every parameter gradient against
    ``jax.value_and_grad``."""
    cfg = small_config(T=1)
    (jspec, jextra), (tspec, textra) = _setups(cfg)
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="train",
                         **jextra, **cfg["model_kwargs"])
    tmodel = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                      **textra, **cfg["model_kwargs"])
    assert jmodel.edge_chunks == tmodel.edge_chunks == 16
    jsums = jstep.make_union_sums_fn(
        jmodel, jax_loss_config(cfg),
        jdpipe.make_graph_builder(jspec, 2, cfg), 2)
    jbatch = jax.tree_util.tree_map(
        jnp.asarray, jdpipe.stack_frames(_labeled_frames([2, 3], "jax")))
    key = jax.random.PRNGKey(5)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1), 1))

    def lossf(p):
        acc, reg = jsums(p, jbatch, key)
        cls = acc["cls_w"] / jnp.maximum(acc["n_ep"], 1.0)
        loc = acc["loc_w"] / jnp.maximum(acc["n_val"], 1.0)
        return cls + loc + reg, (cls, loc, reg, acc["n_val"])

    with jax.default_matmul_precision("highest"):
        (jtotal, (jcls, jloc, jreg, jnval)), jgrads = jax.jit(
            jax.value_and_grad(lossf, has_aux=True))(jparams)
    draws = [_torch_draws(_jax_draws(jax.random.fold_in(key, f),
                                     NUM_POINTS)) for f in range(2)]
    tsums = tstep.make_union_sums_fn(
        tmodel, loss_config(cfg), tdpipe.make_graph_builder(tspec, 2, cfg),
        2)
    params = params_from_jax(jparams, device="cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    tbatch = tdpipe.frames_to_device(
        tdpipe.stack_frames(_labeled_frames([2, 3], "torch")), "cpu")
    acc, reg = tsums(params, tbatch, draws)
    cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
    loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
    total = cls + loc + reg
    total.backward()
    assert float(jnval) > 0 and float(acc["n_val"]) == float(jnval)
    for name, t, j in (("total", total, jtotal), ("cls", cls, jcls),
                       ("loc", loc, jloc), ("reg", reg, jreg)):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=RTOL,
                                   err_msg=name)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tleaves = jax.tree_util.tree_leaves(_grads_tree(params))
    assert len(jleaves) == len(tleaves) > 0
    for (path, jg), tg in zip(jleaves, tleaves):
        jg = np.asarray(jg)
        tol = GRAD_TOL * (1.0 + np.abs(jg).max())
        assert np.abs(tg - jg).max() <= tol, jax.tree_util.keystr(path)


def test_pad_slot_never_wins_and_gets_no_gradient():
    """The pooling layer on a blocked SRC-sentinel list whose pad slots
    clamp to the last point: that point's features are large enough to
    win every max, yet the output equals the list without pad slots
    (DST layout) and its gradient is exactly 0."""
    rng = np.random.default_rng(0)
    num_points, num_centers, slots = 64, 8, 6
    feats = rng.normal(size=(num_points, 4)).astype(np.float32)
    feats[-1] = 1e3  # the clamp target of every pad slot
    xyz = rng.normal(size=(num_points, 3)).astype(np.float32)
    # real sources avoid the last point; each center has 1-5 real slots
    src = np.full((num_centers, slots), num_points, np.int32)
    for c in range(num_centers):
        n = 1 + c % 5
        src[c, :n] = rng.choice(num_points - 1, n, replace=False)
    dst = np.repeat(np.arange(num_centers, dtype=np.int32), slots)
    params = {
        "point_mlp": [{"w": torch.from_numpy(rng.normal(size=(7, 8)).astype(
            np.float32)), "b": torch.zeros(8), "norm": None}],
        "output_mlp": [{"w": torch.eye(8), "b": torch.zeros(8),
                        "norm": None}],
    }
    real = src.reshape(-1) < num_points
    layer = tlayers.PointSetPooling()
    outs, grads = [], []
    for s, d, sentinel in ((src.reshape(-1), dst, "src"),
                           (src.reshape(-1)[real], dst[real], "dst")):
        f = torch.from_numpy(feats).requires_grad_(True)
        out = layer.apply(params, f, torch.from_numpy(xyz),
                          torch.from_numpy(xyz[:num_centers]),
                          edges_src=torch.from_numpy(s),
                          edges_dst=torch.from_numpy(d),
                          edge_sentinel=sentinel, edge_chunks=2)
        out.sum().backward()
        outs.append(out.detach())
        grads.append(f.grad)
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0].max()) < 1e2  # no pad slot won
    assert torch.equal(grads[0][-1], torch.zeros(4))
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_frozen_train_config_routes_to_edge_lists(tmp_path):
    """A port run with ``device_graph_slab: false`` freezes that choice
    (and a flag-free spec) into its saved train_config; a train_config
    the JAX package froze (nested lists, ``approx_recall`` in each level)
    routes a fresh or a resumed trainer to edge lists too."""
    root = tmp_path / "kitti"
    synthetic_kitti.main(str(root), 2, n_ground=600)
    cfg = narrow_config("car_auto_T1_train")
    jspec = _spec(cfg)
    tc = dict(configs.get_train_config("car_auto_T1_train"), batch_size=1,
              num_load_dataset_workers=0, train_dir=str(tmp_path / "train"),
              device_graph_slab=False,
              device_graph_spec=tdb.spec_from_config(
                  cfg, num_points=NUM_POINTS, num_keypoints=256,
                  runtime=False)._replace(slab_level0=True,
                                          slab_level1=True))
    split = os.path.join(root, "3DOP_splits/train.txt")
    fspec = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        str(root), split, 4), cfg, tc)
    trainer = Trainer(cfg, tc, fspec, num_frames=2, device="cpu")
    try:
        aux = trainer.train_batch([0])
        assert np.isfinite(float(aux["total_loss"]))
        trainer.save()
    finally:
        trainer.close()
    frozen = config_io.load_train_config(str(tmp_path / "train" /
                                             "train_config"))
    assert frozen["device_graph"] is True
    assert frozen["device_graph_slab"] is False
    spec = tdpipe.coerce_device_spec(frozen["device_graph_spec"])
    assert not (spec.slab_level0 or spec.slab_level1)
    # the JAX package's frozen form of the same routing
    jfrozen = dict(json_round_trip(dict(tc, device_graph_spec=None)),
                   device_graph=True,
                   device_graph_spec=json_round_trip(jspec))
    for resume in (False, True):
        t = Trainer(cfg, jfrozen, fspec, num_frames=2, device="cpu")
        try:
            if resume:
                assert t.restore() == 1
            assert t.device_graph and t.model.slab_level1 is None
            assert t.model.edge_sentinel == "src"
            assert not t.device_spec.slab_level1
        finally:
            t.close()


def json_round_trip(obj):
    return json.loads(json.dumps(obj))
