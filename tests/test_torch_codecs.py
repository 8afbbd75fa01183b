"""The six box codecs and the separated predictor in the port against
the JAX package.

- every codec's host encoder and decoder (numpy, float64) bitwise, on
  random class ids over the horizontal and vertical sub-classes; the
  voxelnet codec on ``[N, 7]`` boxes, where JAX's runs (the port's also
  takes the host fetch's ``[N, 1, 7]``: the same numbers);
- every device decoder (torch) at 1e-6: a few f32 ulps where ``exp``,
  ``cos`` and ``sin`` differ;
- one host-graph union step per non-class-aware codec (direct, center,
  voxelnet targets): the losses at rtol 1e-5 and every gradient within
  1e-4 of ``(1 + max|g|)``;
- a ``classaware_separated_predictor`` model: the JAX tree's shapes and
  its forward on a host graph at rtol 1e-5 (each class's box head reads
  its own slice of the features).
"""

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
from pointgnn_tpu.train.trainer import loss_config as jax_loss_config
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch.data.labels import LABEL_METHODS
from pointgnn_tpu_torch.graph import pad
from pointgnn_tpu_torch.model import encodings as tenc
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
from pointgnn_tpu_torch.parallel import step as tstep
from pointgnn_tpu_torch.train import optimizers as topt
from test_torch_configs import narrow_config
from test_torch_train_step import _grads_tree

CODECS = (
    "direct_encoding",
    "center_box_encoding",
    "voxelnet_box_encoding",
    "classaware_voxelnet_box_encoding",
    "classaware_all_class_box_encoding",
    "classaware_all_class_box_canonical_encoding",
)
LABEL_MAP = LABEL_METHODS["yaw"][0]
CAP = jpad.GraphCapacity(vertices=(4096, 2048, 2048), edges=(32768, 65536))


def _boxes(n, seed):
    """Class ids over 0-7 (horizontal and vertical sub-classes, inactive
    ids), vertex coordinates and [N, 7] boxes with positive sizes."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 8, (n, 1)).astype(np.int32)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 10
    boxes = np.concatenate([
        xyz + rng.normal(size=(n, 3)), rng.uniform(0.5, 5, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    return cls, xyz, boxes


@pytest.mark.parametrize("name", CODECS)
def test_host_codec_matches_jax(name):
    cls, xyz, boxes = _boxes(200, len(name))
    flat = name == "voxelnet_box_encoding"  # JAX's takes [N, 7] only
    b = boxes if flat else boxes[:, None, :]
    want = jenc.get_box_encoding_fn(name)(cls, xyz, b, LABEL_MAP)
    got = tenc.get_box_encoding_fn(name)(cls, xyz, b, LABEL_MAP)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    jdec = jenc.get_box_decoding_fn(name)(cls, xyz, want, LABEL_MAP)
    tdec = tenc.get_box_decoding_fn(name)(cls, xyz, got, LABEL_MAP)
    assert tdec.tobytes() == jdec.tobytes()
    np.testing.assert_allclose(tdec.reshape(-1, 7), boxes, rtol=1e-9,
                               atol=1e-9)
    if flat:
        nested = tenc.get_box_encoding_fn(name)(cls, xyz, boxes[:, None],
                                                LABEL_MAP)
        assert nested[:, 0].tobytes() == want.tobytes()
        back = tenc.get_box_decoding_fn(name)(cls, xyz, nested, LABEL_MAP)
        assert back[:, 0].tobytes() == jdec.tobytes()
    assert tenc.get_encoding_len(name) == jenc.get_encoding_len(name) == 7


@pytest.mark.parametrize("name", CODECS)
def test_device_decoder_matches_jax(name):
    cls, xyz, boxes = _boxes(300, 7 * len(name))
    enc = jenc.get_box_encoding_fn("direct_encoding")(
        cls, xyz, boxes)  # any [N, 7] values
    enc = (enc * 0.3).astype(np.float32)
    ids = cls[:, 0]
    want = np.asarray(jenc.get_decode_jax(name, LABEL_MAP)(
        jnp.asarray(ids), jnp.asarray(xyz), jnp.asarray(enc)))
    got = tenc.get_decode(name, LABEL_MAP)(
        torch.from_numpy(ids), torch.from_numpy(xyz), torch.from_numpy(enc))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _frames(cfg, name):
    """Two host frames whose targets the codec ``name`` encodes (the JAX
    encoder; the port's gives the same bytes)."""
    frames = []
    for seed in (2, 3):
        pts, labels = synthetic_lidar_frame(seed=seed, n_beams=16,
                                            points_per_beam=64)
        c = pts.xyz[len(pts.xyz) // 3]
        labels = list(labels) + [{
            "name": "Car", "x3d": float(c[0]), "y3d": float(c[1]) + 0.5,
            "z3d": float(c[2]), "length": 6.0, "width": 3.0, "height": 2.5,
            "yaw": 0.3 + seed,
        }]
        vcl, kil, el = jbuilder.gen_multi_level_local_graph_v3(
            pts.xyz, **cfg["graph_gen_kwargs"],
            rng=np.random.default_rng(seed))
        cls, boxes, valid, lmap = jlabels.get_label_assigner("Car")(
            labels, vcl[-1], (1.0, 1.0, 1.0))
        flat = name == "voxelnet_box_encoding"
        enc = jenc.get_box_encoding_fn(name)(
            cls, vcl[-1], boxes[:, 0] if flat else boxes, lmap)
        port = tenc.get_box_encoding_fn(name)(cls, vcl[-1], boxes, lmap)
        enc = enc.reshape(port.shape)
        assert port.tobytes() == enc.tobytes()
        frames.append(jpad.FrameData(
            pts.attr[:, :1].astype(np.float32),
            [v.astype(np.float32) for v in vcl],
            [k.astype(np.int32) for k in kil],
            [e.astype(np.int32) for e in el], cls.astype(np.int32),
            enc.astype(np.float32), valid.astype(np.float32)))
    return frames


def test_host_training_step_per_codec():
    """One host-graph union step (car T=1, width 32, f32) on the targets
    of each non-class-aware codec: losses and gradients against JAX."""
    cfg = narrow_config("car_auto_T1_train")
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="train",
                         **cfg["model_kwargs"])
    tmodel = PointGNN(num_classes=4, box_encoding_len=7, mode="train",
                      **cfg["model_kwargs"])
    jparams = params_to_numpy(tmodel.init(3, 1, "cpu"))
    with jax.default_matmul_precision("highest"):
        jgrad = jax.jit(jax.value_and_grad(
            jstep.make_loss_fn(jmodel, jax_loss_config(cfg)), has_aux=True))
    loss_fn = tstep.make_loss_fn(tmodel, loss_config(cfg))
    for name in ("direct_encoding", "center_box_encoding",
                 "voxelnet_box_encoding"):
        frames = _frames(cfg, name)
        graph = jpad.batch_and_pad(frames, CAP)
        with jax.default_matmul_precision("highest"):
            (_, jaux), jgrads = jgrad(
                jparams, jax.tree_util.tree_map(jnp.asarray, graph))
        params = params_from_jax(jparams, "cpu")
        for t in topt.param_leaves(params):
            t.requires_grad_(True)
        total, aux = loss_fn(params, pad.to_device(pad.batch_and_pad(
            [pad.FrameData(*f) for f in frames],
            pad.GraphCapacity(CAP.vertices, CAP.edges)), "cpu"))
        total.backward()
        assert float(aux["num_valid_endpoint"]) > 0, name
        for key in ("total_loss", "cls_loss", "loc_loss"):
            np.testing.assert_allclose(float(aux[key].detach()),
                                       float(jaux[key]), rtol=1e-5,
                                       err_msg=(name, key))
        jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
        tleaves = jax.tree_util.tree_leaves(_grads_tree(params))
        assert len(jleaves) == len(tleaves) > 0
        for (path, jg), tg in zip(jleaves, tleaves):
            jg = np.asarray(jg)
            tol = 1e-4 * (1.0 + np.abs(jg).max())
            assert np.abs(tg - jg).max() <= tol, (
                name, jax.tree_util.keystr(path))


def test_separated_predictor_matches_jax():
    cfg = narrow_config("car_auto_T1_train")
    lcs = cfg["model_kwargs"]["layer_configs"]
    lcs[-1]["type"] = "classaware_separated_predictor"
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="test",
                         **cfg["model_kwargs"])
    tmodel = PointGNN(num_classes=4, box_encoding_len=7, mode="test",
                      **cfg["model_kwargs"])
    assert tmodel._predictor.separated
    # the box heads read 32 / 4 features each, in both trees
    tparams = tmodel.init(0, 1, "cpu")
    scope = lcs[-1]["scope"]
    for head in tparams[scope]["loc"]:
        assert head[0]["w"].shape[0] == 8
    jshapes = jax.eval_shape(lambda k: jmodel.init(k, 1),
                             jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(lambda x: x.shape, jshapes) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams,
                               is_leaf=lambda t: isinstance(t, torch.Tensor))
    graph = jpad.batch_and_pad(_frames(cfg, "classaware_all_class_box_"
                                            "encoding")[:1], CAP)
    jparams = params_to_numpy(tparams)
    with jax.default_matmul_precision("highest"):
        jl, jb = jax.jit(jmodel.apply)(jparams, graph)
    with torch.no_grad():
        tl, tb = tmodel.apply(tparams, pad.to_device(graph, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)
    # each box head depends on its own slice only
    feats = torch.randn(5, 32)
    bumped = feats.clone()
    bumped[:, 8:16] += 1.0
    _, a = tmodel._predictor.apply(tparams[scope], feats, 4)
    _, b = tmodel._predictor.apply(tparams[scope], bumped, 4)
    changed = [not torch.equal(a[:, c], b[:, c]) for c in range(4)]
    assert changed == [False, True, False, False]
