"""The port's host-graph serving path against the JAX package's.

The layers' generic segment branches (both sentinel conventions), the
model on a host-built ``PaddedGraph``, ``run_frame``
with ``on_device_graph=False`` on the same generator (graphs bitwise,
detections at ``tests/test_torch_serving.py``'s tolerance), capacity
growth and its warning, ``run_dataset`` on a 3-frame tree (KITTI text
byte-equal) and ``run_torch.py`` without ``--fast``.  Both sides run in
f32 on the CPU, JAX at matmul precision "highest"."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointgnn_tpu import infer as jax_infer
from pointgnn_tpu.data import kitti as jax_kitti
from pointgnn_tpu.graph import builder as jbuilder
from pointgnn_tpu.graph import pad as jpad
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.nn import layers as jlayers
from pointgnn_tpu.utils.synthetic import synthetic_lidar_frame
from pointgnn_tpu_torch import configs, infer
from pointgnn_tpu_torch.data import kitti
from pointgnn_tpu_torch.graph import device_builder as db, pad
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.nn import layers as tlayers
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.utils import synthetic_kitti

import run_torch

# f32 on both sides: outputs agree to ~1e-6 (other summation orders), the
# decode adds exp() of two libm versions
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL_CAP = dict(vertices=(1024, 768, 768), edges=(8192, 32768))


def _small_config(T=2):
    cfg = configs.model_config("Car", T=T)
    for lc in cfg["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    return cfg


def _frame(seed):
    return synthetic_lidar_frame(seed=seed, n_beams=16,
                                 points_per_beam=64)[0]


def _host_graph(cfg, pts, seed, capacity):
    vcl, kil, el = jbuilder.gen_multi_level_local_graph_v3(
        pts.xyz, **cfg["runtime_graph_gen_kwargs"],
        rng=np.random.default_rng(seed))
    frame = jpad.FrameData(pts.attr[:, :1].astype(np.float32), vcl, kil, el)
    return jpad.batch_and_pad([frame], capacity)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _blocked(src, dst, num_src, num_centers, slots):
    """A host edge list as the device builder's blocked "src" layout:
    slot (c, s) belongs to center c, unused slots carry src == num_src."""
    bsrc = np.full((num_centers, slots), num_src, np.int32)
    fill = np.zeros(num_centers, np.int64)
    for s, d in zip(src, dst):
        if d < num_centers and fill[d] < slots:
            bsrc[d, fill[d]] = s
            fill[d] += 1
    bdst = np.repeat(np.arange(num_centers, dtype=np.int32), slots)
    return bsrc.reshape(-1), bdst


@pytest.mark.parametrize("layout", ["dst", "src"])
@pytest.mark.parametrize("layer", ["pool", "gnn", "gnn_offset"])
def test_segment_layers_match_jax(layer, layout):
    """The layers' segment branches on a level of a host-built graph (4
    chunks): "dst" the padded list, "src" the same edges in the blocked
    layout through the sentinel mask."""
    cfg = _small_config(T=1)
    graph = _host_graph(cfg, _frame(0), 1, jpad.GraphCapacity(**SMALL_CAP))
    level = 0 if layer == "pool" else 1
    src, dst = graph.edges_src[level], graph.edges_dst[level]
    num_src = graph.vertex_xyz[level].shape[0]
    num_centers = graph.vertex_xyz[level + 1].shape[0]
    kw = dict(edge_chunks=4, edge_sentinel="dst")
    if layout != "dst":
        src, dst = _blocked(src, dst, num_src, num_centers, 16)
        kw["edge_sentinel"] = "src"
    rng = np.random.default_rng(2)
    if layer == "pool":
        lkw = dict(point_MLP_depth_list=[16, 24], output_MLP_depth_list=[24],
                   point_MLP_normalization_type="NONE",
                   output_MLP_normalization_type="NONE")
        jl, tl = jlayers.PointSetPooling(), tlayers.PointSetPooling()
        params = jax.device_get(jl.init(jax.random.PRNGKey(0), 1, **lkw))
        feats = graph.features
        args = (graph.vertex_xyz[0], graph.vertex_xyz[1])
        masks = dict(center_mask=graph.vertex_mask[1])
    else:
        lkw = dict(edge_MLP_depth_list=[24, 24], update_MLP_depth_list=[24],
                   edge_MLP_normalization_type="NONE",
                   update_MLP_normalization_type="NONE",
                   auto_offset=layer == "gnn_offset",
                   auto_offset_MLP_depth_list=[16, 3],
                   auto_offset_MLP_normalization_type="NONE")
        jl, tl = jlayers.GraphNetAutoCenter(), tlayers.GraphNetAutoCenter()
        params = jax.device_get(jl.init(jax.random.PRNGKey(0), 24, **lkw))
        feats = rng.normal(size=(num_src, 24)).astype(np.float32)
        args = (graph.vertex_xyz[1],)
        masks = dict(vertex_mask=graph.vertex_mask[1])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jl.apply(
            params, jnp.asarray(feats), *map(jnp.asarray, args),
            jnp.asarray(src), jnp.asarray(dst),
            **{k: jnp.asarray(v) for k, v in masks.items()}, **lkw, **kw))
    got = tl.apply(params_from_jax(params, "cpu"), _t(feats),
                   *map(_t, args), edges_src=_t(src), edges_dst=_t(dst),
                   **{k: _t(v) for k, v in masks.items()}, **lkw, **kw)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_layers_raise_on_normalized_mlps():
    """(Named when normalized MLPs raised here.)  The GNN layer's
    concatenating edge branch with a batch norm (batch statistics,
    padded edges masked out) and with instance norm (over every row of
    the block, padding included, as in JAX) on a host graph, each MLP
    normalized, against the JAX layer."""
    cfg = _small_config(T=1)
    graph = _host_graph(cfg, _frame(0), 1, jpad.GraphCapacity(**SMALL_CAP))
    n = graph.vertex_xyz[1].shape[0]
    feats = np.random.default_rng(3).normal(size=(n, 24)).astype(np.float32)
    for norm in ("fused_BN_center", "IN"):
        lkw = dict(edge_MLP_depth_list=[24, 24], update_MLP_depth_list=[24],
                   edge_MLP_normalization_type=norm,
                   update_MLP_normalization_type=norm,
                   auto_offset=True, auto_offset_MLP_depth_list=[16, 3],
                   auto_offset_MLP_normalization_type=norm)
        params = jax.device_get(jlayers.GraphNetAutoCenter().init(
            jax.random.PRNGKey(0), 24, **lkw))
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jlayers.GraphNetAutoCenter().apply(
                params, jnp.asarray(feats), jnp.asarray(graph.vertex_xyz[1]),
                jnp.asarray(graph.edges_src[1]),
                jnp.asarray(graph.edges_dst[1]),
                vertex_mask=jnp.asarray(graph.vertex_mask[1]), **lkw))
        got = tlayers.GraphNetAutoCenter().apply(
            params_from_jax(params, "cpu"), _t(feats),
            _t(graph.vertex_xyz[1]), edges_src=_t(graph.edges_src[1]),
            edges_dst=_t(graph.edges_dst[1]),
            vertex_mask=_t(graph.vertex_mask[1]), **lkw)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=norm)


@pytest.mark.parametrize("chunks", [1, 4])
def test_model_on_host_graph_matches_jax(chunks):
    """car T=2 at narrow widths on a host-built graph, f32: logits and
    box encodings at 1e-4 relative."""
    cfg = _small_config(T=2)
    graph = _host_graph(cfg, _frame(1), 2, jpad.GraphCapacity(**SMALL_CAP))
    jmodel = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="test",
                         edge_chunks=chunks, **cfg["model_kwargs"])
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(4), 1))
    with jax.default_matmul_precision("highest"):
        jl, jb = jax.device_get(jmodel.apply(params, graph))
    tmodel = PointGNN(num_classes=4, box_encoding_len=7, mode="test",
                      edge_chunks=chunks, **cfg["model_kwargs"])
    tl, tb = tmodel.apply(params_from_jax(params, "cpu"),
                          pad.to_device(graph, "cpu"))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pipelines():
    cfg = _small_config(T=2)
    cap = jpad.GraphCapacity(**SMALL_CAP)
    jpipe = jax_infer.InferencePipeline(cfg, capacity=cap, seed=3)
    params = jax.device_get(jpipe.params)
    # spread the class logits so hypotheses are not near-ties at the
    # 1/num_classes threshold or in the NMS score order
    head = params["output"]["cls"][-1]
    head["w"] = head["w"] * 8.0
    jpipe.params = params
    tpipe = infer.InferencePipeline(
        cfg, params=params_from_jax(params, device="cpu"),
        capacity=pad.GraphCapacity(**SMALL_CAP), device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("seed", [0, 1])
def test_run_frame_matches_jax(pipelines, seed):
    """One generator on each side: the padded graph bitwise (grown to
    the same capacity), then the detections after merge-NMS."""
    jpipe, tpipe = pipelines
    assert not tpipe.on_device_graph and tpipe.compute_dtype is None
    assert tpipe.model.edge_sentinel == "dst" and tpipe.slab is False
    pts = _frame(seed)
    tgraph = tpipe.host_graph(pts, np.random.default_rng(seed))
    jcap = jpad.grow_to_fit(jpad.GraphCapacity(**SMALL_CAP), [
        jpad.FrameData(None, *jbuilder.gen_multi_level_local_graph_v3(
            pts.xyz, **tpipe.config["runtime_graph_gen_kwargs"],
            rng=np.random.default_rng(seed)))])[0]
    jgraph = _host_graph(tpipe.config, pts, seed, jcap)
    assert tuple(tpipe.capacity) == (jcap.vertices, jcap.edges)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(tgraph)),
                    jax.tree_util.tree_leaves(tuple(jgraph))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    jcls, jboxes, jscores, jaux = jpipe.run_frame(
        pts, np.random.default_rng(seed))
    tpipe.time_dict.clear()
    tcls, tboxes, tscores, taux = tpipe.run_frame(
        pts, np.random.default_rng(seed))
    assert len(tcls) > 0
    np.testing.assert_array_equal(tcls, jcls)
    np.testing.assert_allclose(tboxes, jboxes, **TOL)
    np.testing.assert_allclose(tscores, jscores, **TOL)
    np.testing.assert_array_equal(taux["hyp_xyz"], jaux["hyp_xyz"])
    assert set(tpipe.time_dict) == {"gen graph", "gnn inference",
                                    "decode box", "nms"}
    with pytest.raises(ValueError, match="on_device_graph"):
        next(tpipe.stream(iter([pts])))


def test_host_path_auto_grows_capacity():
    """An undersized bucket grows to fit the frame, with a warning and no
    overflow, and gives what a bucket of that size gives; with
    ``auto_capacity=False`` it truncates with the overflow warning
    (JAX's ``test_host_path_auto_grows_capacity``)."""
    cfg = _small_config(T=1)
    pts = _frame(3)
    tiny = pad.GraphCapacity(vertices=(512, 128, 128), edges=(1024, 2048))
    auto = infer.InferencePipeline(cfg, capacity=tiny, seed=0, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cls_a, boxes_a, scores_a, _ = auto.run_frame(
            pts, np.random.default_rng(0))
    messages = [str(w.message) for w in caught]
    assert not any("overflow" in m for m in messages), messages
    assert any("growing" in m for m in messages), messages
    assert auto.capacity.edges[0] > tiny.edges[0]
    jauto = jax_infer.InferencePipeline(
        cfg, capacity=jpad.GraphCapacity(tiny.vertices, tiny.edges), seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jauto.run_frame(pts, np.random.default_rng(0))
    assert (tuple(auto.capacity.vertices), tuple(auto.capacity.edges)) == (
        jauto.capacity.vertices, jauto.capacity.edges)

    big = infer.InferencePipeline(cfg, params=auto.params,
                                  capacity=auto.capacity, device="cpu")
    cls_b, boxes_b, scores_b, _ = big.run_frame(pts,
                                                np.random.default_rng(0))
    assert len(cls_a) == len(cls_b)
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(boxes_a, boxes_b, rtol=1e-5, atol=1e-5)

    trunc = infer.InferencePipeline(cfg, params=auto.params, capacity=tiny,
                                    auto_capacity=False, device="cpu")
    with pytest.warns(RuntimeWarning, match="overflow"):
        trunc.run_frame(pts, np.random.default_rng(0))
    assert trunc.capacity == tiny


def test_option_resolution():
    """The host graph is the default; the device path's arguments
    without ``on_device_graph=True`` raise."""
    cfg = _small_config(T=1)
    host = infer.InferencePipeline(cfg, device="cpu")
    assert not host.on_device_graph and host.device_spec is None
    assert host.capacity == configs.tpu_settings("Car")["runtime_capacity"]
    assert host.model.edge_chunks == 1
    dev = infer.InferencePipeline(cfg, on_device_graph=True, device="cpu",
                                  slab=True)
    assert dev.on_device_graph and dev.compute_dtype == "bfloat16"
    seg = infer.InferencePipeline(cfg, device="cpu", on_device_graph=True,
                                  slab=False, pallas_tail=False)
    assert seg.model.edge_chunks == 8 and seg.model.edge_sentinel == "src"
    with pytest.raises(ValueError, match="on_device_graph"):
        infer.InferencePipeline(cfg, device="cpu", slab=True)
    with pytest.raises(ValueError, match="on_device_graph"):
        infer.InferencePipeline(cfg, device="cpu",
                                device_spec=db.spec_from_config(cfg))


def _dataset(root, module):
    return module.KittiDataset(
        os.path.join(root, "image/training/image_2"),
        os.path.join(root, "velodyne/training/velodyne"),
        os.path.join(root, "calib/training/calib"),
        os.path.join(root, "labels/training/label_2"),
        os.path.join(root, "3DOP_splits/val.txt"),
        num_classes=4,
    )


def _read_labels(out_dir):
    data = os.path.join(out_dir, "data")
    return {n: open(os.path.join(data, n), "rb").read()
            for n in sorted(os.listdir(data))}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic_kitti.main(root, 3, n_ground=100)
    return root


def _same_detections(a, b):
    assert a.keys() == b.keys()
    for name in a:
        la = [ln.split() for ln in a[name].splitlines() if ln.strip()]
        lb = [ln.split() for ln in b[name].splitlines() if ln.strip()]
        assert len(la) == len(lb), name
        for fa, fb in zip(la, lb):
            assert len(fa) == len(fb) == 16
            assert fa[0] == fb[0] and fa[1:4] == fb[1:4]
            np.testing.assert_allclose(np.float64(fa[4:]),
                                       np.float64(fb[4:]), **TOL)


def test_run_dataset_matches_jax(pipelines, tree, tmp_path, monkeypatch):
    """Three frames served in sequence on one generator.  End to end the
    detections agree at ``TOL`` (the two f32 networks sum in other
    orders); with JAX's device program run on the port's graphs, the
    KITTI text is byte-equal: the graphs, the hypothesis mask, NMS and
    the KITTI conversion add nothing."""
    jpipe, tpipe = pipelines
    jpipe.run_dataset(_dataset(tree, jax_kitti), str(tmp_path / "jax"),
                      verbose=False)
    times = tpipe.run_dataset(_dataset(tree, kitti), str(tmp_path / "port"),
                              verbose=False)
    want = _read_labels(str(tmp_path / "jax"))
    got = _read_labels(str(tmp_path / "port"))
    assert len(got) == 3
    assert sum(len(v.splitlines()) for v in got.values()) > 3
    _same_detections(got, want)
    assert {"fetch input", "gen graph", "gnn inference", "decode box",
            "nms", "total"} <= set(times)

    def jax_program(params, graph):
        host = jax.tree_util.tree_map(lambda t: t.numpy(), graph)
        return tuple(torch.from_numpy(np.array(x)) for x in
                     jax.device_get(jpipe._device_fn(jpipe.params, host)))

    monkeypatch.setattr(tpipe, "host_graph_fn", jax_program)
    tpipe.run_dataset(_dataset(tree, kitti), str(tmp_path / "port_jax"),
                      verbose=False)
    assert _read_labels(str(tmp_path / "port_jax")) == want


def test_cli_without_fast_serves_host_graphs(pipelines, tree, tmp_path,
                                             capsys, monkeypatch):
    """``run_torch.py`` without ``--fast``: the host-graph pipeline from
    the checkpoint, the files of an in-process ``run_dataset``, and no
    kernel launch.  The family's runtime capacity is cut to a CPU size
    (the frames grow it as needed)."""
    _, tpipe = pipelines
    small = dict(configs.tpu_settings("Car"),
                 runtime_capacity=pad.GraphCapacity(**SMALL_CAP))
    monkeypatch.setattr(configs, "tpu_settings", lambda name: small)
    ck = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(ck, 7, {"params": tpipe.params},
                         config=tpipe.config)
    out_dir = str(tmp_path / "cli")
    rc = run_torch.main([ck, "--device", "cpu", "--dataset_root_dir", tree,
                         "--output_dir", out_dir])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"launches": {
        "slab_edge_max": 0, "slab_edge_max_backward": 0,
        "edge_tail_max": 0, "fused_edge_max": 0}}
    direct = infer.InferencePipeline(tpipe.config, checkpoint_dir=ck,
                                     device="cpu")
    assert direct.restored_step == 7 and not direct.on_device_graph
    direct.run_dataset(_dataset(tree, kitti), str(tmp_path / "direct"),
                       verbose=False)
    assert _read_labels(out_dir) == _read_labels(str(tmp_path / "direct"))
