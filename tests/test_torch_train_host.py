"""The port's host-graph training and evaluation against the JAX package.

The host fetch (KITTI read, crop-paste, the shipped augmentation, the
training graph, label assignment, box encoding) bitwise for the same
seed; the label assigners and the box codec bitwise; the loss and every
gradient of a two-frame union step on a host-built graph (4 edge chunks,
a tie of three edges split two and one by a chunk boundary) against
``jax.value_and_grad``; a short ``Trainer`` run with ``"device_graph":
false`` and the host-graph ``Evaluator`` on its checkpoint.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu.data import labels as jlabels
from pointgnn_tpu.graph import builder as jbuilder
from pointgnn_tpu.graph import pad as jpad
from pointgnn_tpu.model import encodings as jenc
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.parallel import step as jstep
from pointgnn_tpu.train import pipeline as jpipe
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.data import crop_aug as tcrop
from pointgnn_tpu_torch.data import kitti as tkitti
from pointgnn_tpu_torch.data import labels as tlabels
from pointgnn_tpu_torch.graph import pad
from pointgnn_tpu_torch.model import encodings as tenc
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.train import optimizers as topt
from pointgnn_tpu_torch.train import pipeline as tpipe
from pointgnn_tpu_torch.train import summary as tsummary
from pointgnn_tpu_torch.train.evaluator import Evaluator
from pointgnn_tpu_torch.train.trainer import Trainer
from pointgnn_tpu_torch.utils import synthetic_kitti
from test_torch_augment import CLASSES, dataset
from test_torch_configs import narrow_config

NUM_FRAMES = 4
SMALL_CAP = pad.GraphCapacity(vertices=(8192, 2048, 2048),
                              edges=(65536, 131072))


@pytest.fixture(autouse=True)
def _jsonl_summaries_only(monkeypatch):
    """Scalars go to the JSONL files only (TensorBoard would import
    TensorFlow, ~16 s here)."""
    monkeypatch.setattr(tsummary, "_tb_writer", lambda directory: None)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic_kitti.main(root, NUM_FRAMES, classes=CLASSES, n_ground=600)
    lib = os.path.join(root, "crop_lib.json")
    tcrop.save_cropped_boxes(dataset(root, tkitti), lib)
    return root, lib


def _train_config(name, lib=None, **kw):
    tc = configs.get_train_config(name)
    tc.update(batch_size=2, num_load_dataset_workers=0, device_graph=False,
              **kw)
    if lib is not None:
        tc["crop_aug"] = {
            "crop_filename": lib,
            "sample_rate": {"Car": 1, "Pedestrian": 1, "Cyclist": 1},
            "parser_kwargs": {"max_overlap_rate": 0.5, "max_trails": 2},
        }
    return tc


@pytest.mark.parametrize("name", ["car_auto_T3_train",
                                  "ped_cyl_auto_T3_trainval"])
def test_host_fetch_matches_jax(tree, name):
    """``build_fetch`` without a device spec: every FrameData array,
    dtype and bytes, at two seeds of two frames."""
    root, lib = tree
    cfg = configs.get_config(name)
    tc = _train_config(name, lib)
    split = os.path.join(root, "3DOP_splits/train.txt")
    tfetch = tpipe.build_fetch(tpipe.FetchSpec(
        tpipe.DatasetSpec.from_kitti_root(root, split, cfg["num_classes"]),
        cfg, tc))
    jfetch = jpipe.build_fetch(jpipe.FetchSpec(
        jpipe.DatasetSpec.from_kitti_root(root, split, cfg["num_classes"]),
        cfg, tc))
    valid = 0
    for frame in (0, 3):
        for seed in (0, 7):
            a, b = tfetch(frame, seed), jfetch(frame, seed)
            assert type(a).__name__ == "FrameData"
            la = jax.tree_util.tree_leaves(tuple(a))
            lb = jax.tree_util.tree_leaves(tuple(b))
            assert len(la) == len(lb) == 11
            for x, y in zip(la, lb):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert x.tobytes() == y.tobytes()
            valid += int(a.valid_boxes.sum())
    assert valid > 0


def _labels(rng, n):
    names = ["Car", "Pedestrian", "Cyclist", "Van", "DontCare", "Truck"]
    out = []
    for i in range(n):
        out.append({
            "name": names[i % len(names)], "x3d": rng.uniform(-5, 5),
            "y3d": rng.uniform(0, 2), "z3d": rng.uniform(5, 20),
            "length": rng.uniform(1, 5), "width": rng.uniform(0.5, 2),
            "height": rng.uniform(1, 2), "yaw": rng.uniform(-4, 4),
        })
    return out


@pytest.mark.parametrize("method", ["yaw", "Car", "Pedestrian_and_Cyclist"])
def test_label_assigner_and_encoder_match_jax(method):
    """The three assigners (function, registry and dataset method) and
    the box codecs, bitwise.  (Its last check asserted that the voxelnet
    encoder raised while only the class-aware codec was ported; it now
    holds that encoder bitwise against JAX.)"""
    rng = np.random.default_rng(len(method))
    xyz = np.stack([rng.uniform(-6, 6, 4000), rng.uniform(-1, 3, 4000),
                    rng.uniform(4, 21, 4000)], axis=1).astype(np.float32)
    labels = _labels(rng, 18)
    expend = (1.0, 1.0, 1.0)
    want = jlabels.get_label_assigner(method)(labels, xyz, expend)
    got = tlabels.get_label_assigner(method)(labels, xyz, expend)
    fn = {"yaw": "assign_classaware_label_to_points",
          "Car": "assign_classaware_car_label_to_points",
          "Pedestrian_and_Cyclist":
              "assign_classaware_ped_and_cyc_label_to_points"}[method]
    ds = tkitti.KittiDataset.__new__(tkitti.KittiDataset)
    ds.num_classes = tlabels.LABEL_METHODS[method][1]
    by_method = getattr(ds, fn)(labels, xyz, expend)
    for a, b, c in zip(got[:3], want[:3], by_method[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert c.tobytes() == b.tobytes()
    assert got[3] == want[3]
    assert len(set(got[0].ravel())) > 2  # several classes assigned
    enc = tenc.get_box_encoding_fn("classaware_all_class_box_encoding")(
        got[0], xyz, got[1], got[3])
    jencd = jenc.get_box_encoding_fn("classaware_all_class_box_encoding")(
        want[0], xyz, want[1], want[3])
    assert enc.dtype == jencd.dtype and enc.tobytes() == jencd.tobytes()
    dec = tenc.get_box_decoding_fn("classaware_all_class_box_encoding")(
        got[0], xyz, enc, got[3])
    jdec = jenc.get_box_decoding_fn("classaware_all_class_box_encoding")(
        want[0], xyz, jencd, want[3])
    assert dec.tobytes() == jdec.tobytes()
    # the voxelnet codec raised here before it was ported: bitwise too
    vox = tenc.get_box_encoding_fn("voxelnet_box_encoding")(
        got[0], xyz, got[1][:, 0], got[3])
    jvox = jenc.get_box_encoding_fn("voxelnet_box_encoding")(
        want[0], xyz, want[1][:, 0], want[3])
    assert vox.tobytes() == jvox.tobytes()


def _union_frames(cfg):
    """Two host frames with labels; the second ends with three identical
    isolated points beyond the cloud, which become its last keypoint, so
    the last three level-0 edges of the union are one center's tied
    maxima."""
    frames = []
    for seed in (2, 3):
        pts, labels = synthetic_lidar_frame(seed=seed, n_beams=16,
                                            points_per_beam=64)
        xyz, feats = pts.xyz, pts.attr[:, :1].astype(np.float32)
        c = xyz[len(xyz) // 3]
        labels = list(labels) + [{
            "name": "Car", "x3d": float(c[0]), "y3d": float(c[1]) + 0.5,
            "z3d": float(c[2]), "length": 6.0, "width": 3.0, "height": 2.5,
            "yaw": 0.3 + seed,
        }]
        if seed == 3:
            far = xyz.max(axis=0) + np.array([0.0, 0.0, 30.0], np.float32)
            xyz = np.concatenate([xyz, np.repeat(far[None], 3, 0)], 0)
            feats = np.concatenate([feats, np.full((3, 1), 0.7, np.float32)])
        vcl, kil, el = jbuilder.gen_multi_level_local_graph_v3(
            xyz, **cfg["graph_gen_kwargs"], rng=np.random.default_rng(seed))
        cls, boxes, valid, lmap = jlabels.get_label_assigner("Car")(
            labels, vcl[-1], (1.0, 1.0, 1.0))
        enc = jenc.get_box_encoding_fn(cfg["box_encoding_method"])(
            cls, vcl[-1], boxes, lmap)
        frames.append(jpad.FrameData(
            feats, [v.astype(np.float32) for v in vcl],
            [k.astype(np.int32) for k in kil],
            [e.astype(np.int32) for e in el], cls.astype(np.int32),
            enc.astype(np.float32), valid.astype(np.float32)))
    return frames


def test_host_union_step_matches_jax():
    """Loss terms and every parameter gradient of a two-frame union step
    (car T=1, width 32, 4 edge chunks, f32), and the gradient of the
    input features: the three tied level-0 edges of the last center
    straddle a chunk boundary (two in chunk 0, one in chunk 1), so their
    features get 1/4, 1/4 and 1/2 of the cotangent, as in JAX."""
    cfg = narrow_config("car_auto_T1_train")
    frames = _union_frames(cfg)
    n0 = sum(len(f.edges_list[0]) for f in frames)
    n1 = sum(len(f.edges_list[1]) for f in frames)
    # a level-0 chunk of n0 - 1 edges: the boundary falls before the
    # last edge
    cap = jpad.GraphCapacity(vertices=(4096, 2048, 2048),
                             edges=(4 * (n0 - 1), 4 * n1))
    graph = jpad.batch_and_pad(frames, cap)
    dups = np.flatnonzero(graph.edges_dst[0][:n0] == graph.edges_dst[0][n0 - 1])
    assert len(dups) == 3 and list(dups) == [n0 - 3, n0 - 2, n0 - 1]
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="train",
                         edge_chunks=4, **cfg["model_kwargs"])
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(1), 1))
    jloss = jstep.make_loss_fn(jmodel, jax_loss_config(cfg))

    def lossf(p, feats, g):
        return jloss(p, g._replace(features=feats))

    with jax.default_matmul_precision("highest"):
        (jtotal, jaux), (jgrads, jfgrad) = jax.jit(jax.value_and_grad(
            lossf, argnums=(0, 1), has_aux=True))(
                jparams, jnp.asarray(graph.features),
                jax.tree_util.tree_map(jnp.asarray, graph))

    tmodel = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                      edge_chunks=4, **cfg["model_kwargs"])
    assert tmodel.edge_chunks == 4 and PointGNN(
        num_classes=4, box_encoding_len=7, mode="train",
        **cfg["model_kwargs"]).edge_chunks == 16
    params = params_from_jax(jparams, device="cpu")
    for t in topt.param_leaves(params):
        t.requires_grad_(True)
    tgraph = pad.to_device(pad.batch_and_pad(
        [pad.FrameData(*f) for f in frames],
        pad.GraphCapacity(cap.vertices, cap.edges)), "cpu")
    feats = tgraph.features.clone().requires_grad_(True)
    total, aux = tstep.make_loss_fn(tmodel, loss_config(cfg))(
        params, tgraph._replace(features=feats))
    total.backward()

    assert float(aux["num_valid_endpoint"]) > 0
    for key in ("total_loss", "cls_loss", "loc_loss", "reg_loss"):
        np.testing.assert_allclose(float(aux[key].detach()),
                                   float(jaux[key]), rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(aux["classwise_loc_loss"].detach().numpy(),
                               np.asarray(jaux["classwise_loc_loss"]),
                               rtol=1e-5, atol=1e-7)
    tgrads = [t.grad.numpy() for t in topt.param_leaves(params)]
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(jleaves) == len(tgrads) > 0
    for (path, jg), tg in zip(jleaves, tgrads):
        jg = np.asarray(jg)
        assert tg.shape == jg.shape, path
        # f32 sums in other orders through the chain rule: 1e-4 of the
        # leaf's own scale
        tol = 1e-4 * (1.0 + np.abs(jg).max())
        err = np.abs(tg - jg).max()
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)
    fg, jfg = feats.grad.numpy(), np.asarray(jfgrad)
    np.testing.assert_allclose(fg, jfg, rtol=1e-4,
                               atol=1e-4 * (1 + np.abs(jfg).max()))
    src = graph.edges_src[0][dups]
    tie = fg[src, 0]
    assert np.abs(tie).max() > 0
    np.testing.assert_allclose(tie / tie[2], [0.5, 0.5, 1.0], rtol=1e-5)


def _trainer(root, train_dir, max_steps=2):
    cfg = narrow_config("car_auto_T1_train")
    tc = _train_config("car_auto_T1_train", train_dir=str(train_dir),
                       max_steps=max_steps)
    split = os.path.join(root, "3DOP_splits/train.txt")
    fspec = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        root, split, cfg["num_classes"]), cfg, tc)
    return cfg, Trainer(cfg, tc, fspec, num_frames=NUM_FRAMES,
                        capacity=SMALL_CAP, device="cpu")


def test_trainer_and_evaluator_on_host_graphs(tree, tmp_path, capsys):
    """Two steps with ``"device_graph": false`` (finite losses, a
    checkpoint, the frozen train_config keeps the host route), then the
    ``Evaluator`` on host graphs over that checkpoint; a device-graph
    checkpoint evaluated on host graphs gets 4x the edge buckets."""
    root, _ = tree
    cfg, trainer = _trainer(root, tmp_path / "run")
    try:
        assert not trainer.device_graph and trainer.device_spec is None
        assert trainer.capacity == SMALL_CAP
        assert trainer.model.edge_chunks == 16
        assert trainer.model.edge_sentinel == "dst"
        graph = trainer.prepare_batch([0, 1])
        assert isinstance(graph, pad.PaddedGraph)
        assert graph.edges_src[0].dtype == torch.int32
        assert graph.vertex_mask[0].dtype == torch.float32
        trainer.train()
    finally:
        trainer.close()
    losses = trainer.step_log["total_loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert ckpt.list_checkpoint_steps(str(tmp_path / "run")) == [2]
    frozen = trainer.train_config
    assert frozen["device_graph"] is False

    ec = dict(configs.eval_config("Car"), train_dir=str(tmp_path / "run"))
    split = os.path.join(root, "3DOP_splits/val.txt")
    fspec = tpipe.FetchSpec(tpipe.DatasetSpec.from_kitti_root(
        root, split, cfg["num_classes"]), cfg, ec, is_eval=True)
    tiny = pad.GraphCapacity((1024, 256, 256), (4096, 8192))
    ev = Evaluator(cfg, ec, fspec, num_frames=2, train_config=frozen,
                   capacity=tiny, device="cpu")
    try:
        assert not ev.device_graph and ev.model.mode == "eval"
        res = ev.eval_once(str(tmp_path / "run"), str(tmp_path / "eval"), 2)
    finally:
        ev.close()
    assert np.isfinite(res["total_loss"])
    assert "eval capacity grown to" in capsys.readouterr().out
    assert ev.capacity.edges[0] > 4096 and ev.capacity.vertices[1] > 256

    frame_cap = configs.tpu_settings("Car")["frame_capacity"]
    for tc, extra in (({"device_graph": True}, {"device_graph": False}),
                      ({}, {"host_eval_of_device_checkpoint": True}),
                      ({}, {})):
        e = Evaluator(cfg, dict(ec, **extra), fspec, num_frames=2,
                      train_config=tc, device="cpu")
        e.close()
        factor = 1 if not (tc or extra.get(
            "host_eval_of_device_checkpoint")) else 4
        assert e.capacity == pad.GraphCapacity(
            frame_cap.vertices, tuple(factor * x for x in frame_cap.edges))
    with pytest.raises(ValueError, match="graph_builder"):
        tstep.make_train_step(trainer.model, trainer.optimizer,
                              loss_config(cfg), frames_per_device=2)
