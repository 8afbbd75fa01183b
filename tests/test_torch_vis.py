"""The port's visualization against the JAX package's: the projected box
corners its wireframes join and the BEV polygons of box top faces equal
to the ones the JAX package hands to OpenCV and matplotlib; every writer
produces a PNG the port reads back; the interactive viewers fall back to
the headless writers; ``run_dataset(visualization_level=1, 2)`` on
device- and host-built graphs writes the vis files and the KITTI text of
a run without visualization, which is byte-equal to the JAX
``run_dataset``'s at the same level once JAX's device program runs in the
port's pipeline; ``run_torch.py -l 1`` does the same from the command
line."""

import os

import matplotlib

matplotlib.use("Agg")

import cv2
import jax
import matplotlib.axes
import numpy as np
import pytest
import torch

from pointgnn_tpu import infer as jax_infer
from pointgnn_tpu.data import kitti as jax_kitti
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.graph import pad as jpad
from pointgnn_tpu.utils import interactive as jinteractive
from pointgnn_tpu.utils import vis as jvis
from pointgnn_tpu_torch import configs, infer
from pointgnn_tpu_torch.data import kitti, png
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.graph import pad as tpad
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.utils import interactive, synthetic_kitti, vis

import run_torch

NUM_POINTS, NUM_KEYPOINTS = 2048, 256
# end to end the two f32 networks sum in other orders (the tolerance of
# tests/test_torch_run_dataset.py)
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL_CAP = dict(vertices=(1024, 768, 768), edges=(8192, 32768))


def _small_config():
    """car T=1 at narrow widths, a 0.8 m keypoint voxel (graph scale 1)
    so the tree's frames fit 2048 points and 256 keypoints."""
    cfg = configs.model_config("Car", T=1)
    for level in cfg["runtime_graph_gen_kwargs"]["level_configs"]:
        level["graph_scale"] = 1.0
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


def _dataset(root, module):
    return module.KittiDataset(
        os.path.join(root, "image/training/image_2"),
        os.path.join(root, "velodyne/training/velodyne"),
        os.path.join(root, "calib/training/calib"),
        os.path.join(root, "labels/training/label_2"),
        os.path.join(root, "3DOP_splits/val.txt"),
        num_classes=4,
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 2-frame tree and JAX parameters with spread class logits (no
    near-ties at the hypothesis threshold or in the NMS order)."""
    root = str(tmp_path_factory.mktemp("vis_tree"))
    synthetic_kitti.main(root, 2, n_ground=100)
    cfg = _small_config()
    jpipe = jax_infer.InferencePipeline(cfg, on_device_graph=True, slab=True,
                                        pallas_tail=False, seed=3)
    params = jax.device_get(jpipe.params)
    head = params["output"]["cls"][-1]
    head["w"] = head["w"] * 8.0
    return root, cfg, params


def _boxes(rng, n):
    return np.stack([
        rng.uniform(-6, 6, n), rng.uniform(1.4, 1.9, n),
        rng.uniform(6, 40, n), rng.uniform(3.5, 4.5, n),
        rng.uniform(1.4, 1.7, n), rng.uniform(1.5, 1.9, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1)


def test_box_geometry_equals_jax(setup, tmp_path, monkeypatch):
    """The corner pixels of every wireframe edge JAX draws with
    ``cv2.line``, and the polygons it plots on the BEV, equal the
    port's."""
    root, _, _ = setup
    calib = _dataset(root, kitti).get_calib(0)
    image = _dataset(root, kitti).get_image(0)
    boxes = _boxes(np.random.default_rng(0), 6)
    lines = []
    monkeypatch.setattr(cv2, "line", lambda img, a, b, *r: lines.append(
        (tuple(int(v) for v in a), tuple(int(v) for v in b))))
    jvis.draw_3d_boxes(image, boxes, calib)
    xy = vis.project_box_corners(boxes, calib)
    assert xy.dtype == np.int32 and xy.shape == (6, 8, 2)
    assert lines == [(tuple(xy[i, a]), tuple(xy[i, b]))
                     for i in range(6) for a, b in vis.BOX_EDGES]
    assert vis.BOX_EDGES == jvis.BOX_EDGES

    plotted = []
    orig = matplotlib.axes.Axes.plot

    def record(ax, x, y, *args, **kw):
        plotted.append((kw.get("color"), np.stack([x, y], axis=1)))
        return orig(ax, x, y, *args, **kw)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", record)
    gt = _boxes(np.random.default_rng(1), 3)
    jvis.plot_bev(np.zeros((4, 3)), boxes, gt, path=str(tmp_path / "j.png"))
    want = [p for c, p in plotted if c == "green"]
    want_gt = [p for c, p in plotted if c == "red"]
    np.testing.assert_array_equal(vis.bev_polygons(boxes), np.stack(want))
    np.testing.assert_array_equal(vis.bev_polygons(gt), np.stack(want_gt))


def test_bresenham_and_text():
    xs, ys = vis.bresenham(0, 0, 7, 3)
    assert list(xs) == list(range(8)) and ys[0] == 0 and ys[-1] == 3
    assert (np.abs(np.diff(ys)) <= 1).all()
    xs, ys = vis.bresenham(5, 9, 3, -4)
    assert (xs[0], ys[0], xs[-1], ys[-1]) == (5, 9, 3, -4)
    assert list(ys) == list(range(9, -5, -1))
    img = np.zeros((40, 60, 3), np.uint8)
    vis.draw_line(img, (-1e9, 20.0), (1e9, 20.0), (0, 255, 0), 2)
    assert (img[19:21, :, 1] == 255).all() and img[22:, :, 1].max() == 0
    text = vis.draw_text(np.zeros((20, 60, 3), np.uint8), "C | 0.5",
                         (2, 12), (0, 255, 0))
    assert text[5:12].any() and not text[12:].any() and not text[:5].any()


def test_every_writer_round_trips(setup, tmp_path):
    root, _, _ = setup
    ds = _dataset(root, kitti)
    image, calib = ds.get_image(0), ds.get_calib(0)
    labels = ds.get_label(0) + [dict(ds.get_label(0)[0], name="DontCare")]
    boxes = _boxes(np.random.default_rng(2), 4)
    two_d = vis.draw_2d_boxes(image, labels)
    three_d = vis.draw_3d_boxes(image, boxes, calib, scores=[0.5] * 4)
    for drawn in (two_d, three_d):
        assert drawn.shape == image.shape and drawn.dtype == np.uint8
        assert (drawn != image).any()
        path = str(tmp_path / "d.png")
        png.write_png(path, drawn)
        assert np.array_equal(png.read_png(path), drawn)
    pred = [("Car", -1, -1, 0, 300.0, 150.0, 420.0, 220.0, 1.5, 1.6, 3.9,
             *boxes[0, :3], boxes[0, 6], 0.75)]
    out = vis.save_detection_image(image, pred, calib,
                                   str(tmp_path / "det.png"))
    got = png.read_png(out)
    assert got.shape == image.shape and (got != image).any()
    pts = ds.get_cam_points(0).xyz
    bev = vis.plot_bev(pts, boxes, boxes[:2], path=str(tmp_path / "b.png"))
    got = png.read_png(bev)
    assert got.shape == (vis.BEV_SIZE, vis.BEV_SIZE, 3)
    assert (got[..., 1] == 255).any() and (got[..., 2] == 255).any()
    assert np.array_equal(vis.plot_bev(pts, boxes, boxes[:2]), got)
    edges = np.stack([np.arange(50), np.arange(50)[::-1]], axis=1)
    graph = vis.plot_graph_bev(pts[:50], edges, path=str(tmp_path / "g.png"))
    assert png.read_png(graph).shape == (vis.BEV_SIZE, vis.BEV_SIZE, 3)


def test_interactive_fallbacks_write_files(tmp_path, monkeypatch):
    """Open3D is absent: each viewer writes its headless PNG, to
    ``save_path`` or to JAX's default name in the working directory."""
    monkeypatch.chdir(tmp_path)
    assert interactive._try_open3d() is None
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (200, 3))
    box = np.array([0.0, 1.0, 5.0, 4.0, 1.5, 1.6, 0.3])
    label = {"name": "Pedestrian", "x3d": 1.0, "y3d": 1.5, "z3d": 8.0,
             "length": 0.8, "height": 1.7, "width": 0.6, "yaw": 0.1}
    got = interactive._labels_to_boxes([{"box": box}, label])
    want = jinteractive._labels_to_boxes([{"box": box}, label])
    assert got[1] == want[1] == ["Car", "Pedestrian"]
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    src, dst = rng.integers(0, 200, 50), rng.integers(0, 200, 50)
    written = [
        interactive.vis_points(xyz, label_list=[label],
                               save_path=str(tmp_path / "p.png")),
        interactive.vis_graph(xyz, src, dst),
        interactive.vis_detections(xyz, [box], names=["Car"],
                                   save_path=str(tmp_path / "d.png")),
        interactive.vis_crop_aug(xyz, xyz[:20] + 1.0, box),
        interactive.vis_points(xyz),
    ]
    assert written == [str(tmp_path / "p.png"), "vis_graph_bev.png",
                       str(tmp_path / "d.png"), "vis_crop_aug_bev.png",
                       "vis_points_bev.png"]
    for path in written:
        assert png.read_png(path).shape == (vis.BEV_SIZE, vis.BEV_SIZE, 3)


def _read_labels(out_dir):
    data = os.path.join(out_dir, "data")
    return {n: open(os.path.join(data, n), "rb").read().decode()
            for n in sorted(os.listdir(data))}


def _same_detections(a, b):
    assert a.keys() == b.keys()
    for name in a:
        la = [ln.split() for ln in a[name].splitlines() if ln.strip()]
        lb = [ln.split() for ln in b[name].splitlines() if ln.strip()]
        assert len(la) == len(lb), name
        for fa, fb in zip(la, lb):
            assert fa[:4] == fb[:4]
            np.testing.assert_allclose(np.float64(fa[4:]),
                                       np.float64(fb[4:]), **TOL)


def _vis_files(level):
    suffixes = ("", "_bev") + (("_3d",) if level >= 2 else ())
    return sorted("%06d%s.png" % (i, s) for i in range(2) for s in suffixes)


def _pipes(cfg, params, device_graph):
    if device_graph:
        kw = dict(num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS)
        jpipe = jax_infer.InferencePipeline(
            cfg, params=params, on_device_graph=True, slab=True,
            pallas_tail=False, compute_dtype=None,
            device_spec=jdb.spec_from_config(cfg, **kw))
        tpipe = infer.InferencePipeline(
            cfg, params=params_from_jax(params, device="cpu"),
            on_device_graph=True, device_spec=tdb.spec_from_config(cfg, **kw),
            compute_dtype="float32", device="cpu")
    else:
        jpipe = jax_infer.InferencePipeline(
            cfg, params=params, capacity=jpad.GraphCapacity(**SMALL_CAP))
        tpipe = infer.InferencePipeline(
            cfg, params=params_from_jax(params, device="cpu"),
            capacity=tpad.GraphCapacity(**SMALL_CAP), device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("device_graph, level", [(True, 2), (False, 1)])
def test_run_dataset_visualization(setup, tmp_path, monkeypatch,
                                   device_graph, level):
    """The port at levels 0 and ``level``: the same text; the vis files
    decode at the image's and the canvas's shapes; the detection image
    differs from the camera image.  JAX at ``level``: the same
    detections at ``TOL`` end to end, and byte-equal text with JAX's
    device program run inside the port's pipeline (the graphs, the
    hypothesis mask, NMS, the KITTI conversion and the drawing add
    nothing)."""
    root, cfg, params = setup
    jpipe, tpipe = _pipes(cfg, params, device_graph)
    jpipe.run_dataset(_dataset(root, jax_kitti), str(tmp_path / "jax"),
                      verbose=False, visualization_level=level)
    want = _read_labels(str(tmp_path / "jax"))
    assert sorted(os.listdir(str(tmp_path / "jax" / "vis"))) == \
        _vis_files(level)
    texts = {}
    for lv in (0, level):
        out = str(tmp_path / ("port%d" % lv))
        tpipe.run_dataset(_dataset(root, kitti), out, verbose=False,
                          visualization_level=lv)
        texts[lv] = _read_labels(out)
    assert texts[0] == texts[level]
    assert sum(len(t.splitlines()) for t in texts[0].values()) > 2
    _same_detections(texts[level], want)
    vis_dir = str(tmp_path / ("port%d" % level) / "vis")
    assert sorted(os.listdir(vis_dir)) == _vis_files(level)
    ds = _dataset(root, kitti)
    for i in range(2):
        image = ds.get_image(i)
        det = png.read_png(os.path.join(vis_dir, "%06d.png" % i))
        assert det.shape == image.shape and (det != image).any()
        for suffix in ("_bev", "_3d")[:level]:
            bev = png.read_png(os.path.join(vis_dir, "%06d%s.png"
                                            % (i, suffix)))
            assert bev.shape == (vis.BEV_SIZE, vis.BEV_SIZE, 3)
            # the ground truth's red top faces, on the BEV only
            assert ((bev[..., 2] == 255) & (bev[..., 1] == 0)).any() == (
                suffix == "_bev")

    if device_graph:
        def jax_program(prm, packed):
            return tuple(torch.from_numpy(np.array(x)) for x in
                         jax.device_get(jpipe._device_fn(jpipe.params,
                                                         packed.numpy())))

        monkeypatch.setattr(tpipe, "device_fn", jax_program)
    else:
        def jax_program(prm, graph):
            host = jax.tree_util.tree_map(lambda t: t.numpy(), graph)
            return tuple(torch.from_numpy(np.array(x)) for x in
                         jax.device_get(jpipe._device_fn(jpipe.params,
                                                         host)))

        monkeypatch.setattr(tpipe, "host_graph_fn", jax_program)
    tpipe.run_dataset(_dataset(root, kitti), str(tmp_path / "port_jax"),
                      verbose=False, visualization_level=level)
    assert _read_labels(str(tmp_path / "port_jax")) == want


def test_run_torch_cli_level_1(setup, tmp_path, capsys, monkeypatch):
    """``run_torch.py --device cpu -l 1`` (host graphs, the family's
    runtime capacity cut to a CPU size): the vis files and the text of
    the same run without ``-l``."""
    root, cfg, params = setup
    small = dict(configs.tpu_settings("Car"),
                 runtime_capacity=tpad.GraphCapacity(**SMALL_CAP))
    monkeypatch.setattr(configs, "tpu_settings", lambda name: small)
    ck = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(ck, 3, {"params": params_from_jax(params, "cpu")},
                         config=cfg)
    outs = {}
    for level in (0, 1):
        out = str(tmp_path / ("out%d" % level))
        assert run_torch.main([ck, "--device", "cpu", "-l", str(level),
                               "--dataset_root_dir", root,
                               "--output_dir", out]) == 0
        outs[level] = _read_labels(out)
    printed = capsys.readouterr().out
    assert printed.count("Restored step 3") == 2
    assert outs[0] == outs[1] and len(outs[0]) == 2
    assert sorted(os.listdir(str(tmp_path / "out1" / "vis"))) == \
        _vis_files(1)
    assert not os.path.isdir(str(tmp_path / "out0" / "vis"))

