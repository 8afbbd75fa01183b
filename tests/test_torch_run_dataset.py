"""The port's serving surface: ``stream`` against ``run_frame``, the KITTI
text against the JAX package's, ``run_dataset`` against the JAX
``run_dataset`` on a synthetic KITTI tree, and ``run_torch.py`` on a
checkpoint made by ``convert_jax_checkpoint.py``.

Both pipelines run in f32 on the CPU: JAX's
``InferencePipeline(on_device_graph=True, slab=True, pallas_tail=False)``
(its slab kernel in interpret mode) and the port's
``InferencePipeline(device="cpu")`` (the plain slab_edge_max)."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from pointgnn_tpu import infer as jax_infer
from pointgnn_tpu.data import kitti as jax_kitti
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.train import checkpoint as jax_ckpt
from pointgnn_tpu_torch import configs, infer
from pointgnn_tpu_torch.data import kitti
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.graph import pad as tpad
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.utils import synthetic_kitti
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

import convert_jax_checkpoint
import run_torch

NUM_POINTS, NUM_KEYPOINTS = 2048, 256
# the tolerance of tests/test_torch_serving.py: f32 model outputs agree
# to ~1e-6, the decode adds exp() of two libm versions
TOL = dict(rtol=1e-4, atol=1e-4)


def _small_config(T=2):
    """Narrow widths, and a 0.8 m keypoint voxel (runtime graph scale 1)
    so the small tree's frames fit 2048 points and 256 keypoints."""
    cfg = configs.model_config("Car", T=T)
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
    """A 3-frame synthetic KITTI tree and both pipelines on the same
    parameters."""
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic_kitti.main(root, 3, n_ground=100)
    cfg = _small_config()
    kw = dict(num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS)
    jpipe = jax_infer.InferencePipeline(
        cfg, on_device_graph=True, slab=True, pallas_tail=False,
        compute_dtype=None, device_spec=jdb.spec_from_config(cfg, **kw),
        seed=3,
    )
    params = jax.device_get(jpipe.params)
    # spread the class logits so hypotheses are not near-ties at the
    # 1/num_classes threshold or in the NMS score order
    head = params["output"]["cls"][-1]
    head["w"] = head["w"] * 8.0
    jpipe.params = params
    return root, cfg, params


def _port_pipe(cfg, params):
    return infer.InferencePipeline(
        cfg, params=params_from_jax(params, device="cpu"),
        on_device_graph=True,
        device_spec=tdb.spec_from_config(
            cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS),
        compute_dtype="float32", device="cpu",
    )


def _read_labels(out_dir):
    files = sorted(os.listdir(os.path.join(out_dir, "data")))
    return {f: open(os.path.join(out_dir, "data", f)).read() for f in files}


def _same_detections(a, b):
    assert a.keys() == b.keys()
    for name in a:
        la = [l.split() for l in a[name].splitlines() if l.strip()]
        lb = [l.split() for l in b[name].splitlines() if l.strip()]
        assert len(la) == len(lb), name
        for fa, fb in zip(la, lb):
            assert len(fa) == len(fb) == 16
            assert fa[0] == fb[0] and fa[1:4] == fb[1:4]
            np.testing.assert_allclose(np.float64(fa[4:]), np.float64(fb[4:]),
                                       **TOL)


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_equals_run_frame(setup, depth):
    """4 frames, the worker 1 or 3 frames ahead (``batch`` has no
    effect: frames run one at a time)."""
    _, cfg, params = setup
    frames = [synthetic_lidar_frame(seed=s, n_beams=16,
                                    points_per_beam=64)[0] for s in range(4)]
    ref_pipe, pipe = _port_pipe(cfg, params), _port_pipe(cfg, params)
    with pytest.warns(RuntimeWarning, match="keypoint overflow"):
        want = [ref_pipe.run_frame(p) for p in frames]
    # the stats are computed on the worker, applied (and warned) here
    with pytest.warns(RuntimeWarning, match="keypoint overflow"):
        got = list(pipe.stream(iter(frames), depth=depth, batch=3))
    assert len(got) == 4 and pipe.frames_done == 4
    assert sum(len(w[0]) for w in want) > 0
    for w, g in zip(want, got):
        for a, b in zip(w[:3], g[:3]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert w[3].keys() == g[3].keys()
        for key in w[3]:
            assert w[3][key].tobytes() == g[3][key].tobytes()
    assert pipe.overflow_counters == ref_pipe.overflow_counters
    assert pipe.overflow_counters["keypoints_dropped"] > 0
    assert set(pipe.time_dict) == {"gen graph", "gnn inference", "nms"}
    raw = list(pipe.stream(iter(frames[:2]), depth=depth, raw=True))
    assert pipe.frames_done == 6 and len(raw) == 2
    ref = ref_pipe.device_fn(ref_pipe.params, torch.from_numpy(
        tdb.pack_points(frames[1].xyz, infer.select_input_features(
            frames[1].attr, "i"), NUM_POINTS)))
    for a, b in zip(raw[1], ref):
        assert a.tobytes() == b.numpy().tobytes()
    # a real mesh is served in test_torch_stream_mesh.py
    with pytest.raises(TypeError, match="Mesh or a list of devices"):
        next(pipe.stream(iter(frames), mesh=object()))


def test_kitti_text_equals_jax(setup):
    """Given the same NMS outputs, the label tuples and the file text
    are byte-equal."""
    root, cfg, params = setup
    calib = _dataset(root, kitti).get_calib(0)
    rng = np.random.default_rng(0)
    n = 12
    boxes = np.stack([
        rng.uniform(-8, 8, n), rng.uniform(1.4, 1.9, n),
        rng.uniform(8, 50, n), rng.uniform(3.5, 4.5, n),
        rng.uniform(1.4, 1.7, n), rng.uniform(1.5, 1.9, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1)
    boxes[0, 0] = 40.0  # projects mostly outside the image: filtered
    cls = np.ones(n, np.int64)
    scores = rng.uniform(0.3, 1.0, n)
    aux = {"hyp_xyz": boxes[:, :3] + rng.normal(0, 0.5, (n, 3))}
    pipe = _port_pipe(cfg, params)
    for use_box_score in (True, False):
        pipe.use_box_score = use_box_score
        mine = pipe.detections_to_kitti(cls, boxes, scores, calib, aux)
        ref = jax_infer.detections_to_kitti_labels(
            "Car", cls, boxes, scores, calib, aux,
            use_box_score=use_box_score)
        assert 0 < len(mine) < n
        assert infer.format_kitti_lines(mine) == \
            jax_infer.format_kitti_lines(ref)
    assert infer.format_kitti_lines([]) == jax_infer.format_kitti_lines([])


def test_run_dataset_matches_jax(setup, tmp_path):
    root, cfg, params = setup
    kw = dict(num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS)
    jpipe = jax_infer.InferencePipeline(
        cfg, params=params, on_device_graph=True, slab=True,
        pallas_tail=False, compute_dtype=None,
        device_spec=jdb.spec_from_config(cfg, **kw))
    jpipe.run_dataset(_dataset(root, jax_kitti), str(tmp_path / "jax"),
                      verbose=False)
    tpipe = _port_pipe(cfg, params)
    avg = tpipe.run_dataset(_dataset(root, kitti), str(tmp_path / "torch"),
                            verbose=False)
    assert set(avg) == {"fetch input", "gen graph", "gnn inference", "nms",
                        "total"}
    assert tpipe.frames_done == 3
    assert tpipe.overflow_counters["points_dropped"] == 0
    assert tpipe.overflow_counters["keypoints_dropped"] == 0
    mine, ref = _read_labels(str(tmp_path / "torch")), _read_labels(
        str(tmp_path / "jax"))
    assert sorted(mine) == ["000000.txt", "000001.txt", "000002.txt"]
    assert sum(len(t.splitlines()) for t in mine.values()) > 3
    _same_detections(mine, ref)
    # visualization serves frame by frame and writes the same text
    tpipe.run_dataset(_dataset(root, kitti), str(tmp_path / "v"),
                      visualization_level=1, verbose=False)
    assert _read_labels(str(tmp_path / "v")) == mine
    assert sorted(os.listdir(str(tmp_path / "v" / "vis"))) == sorted(
        "%06d%s.png" % (i, s) for i in range(3) for s in ("", "_bev"))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, "%s/%s" % (path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, "%s/%d" % (path, i))
    else:
        yield path, tree


def test_converter_and_cli(setup, tmp_path, capsys):
    root, _, _ = setup
    cfg = _small_config(T=1)
    jpipe = jax_infer.InferencePipeline(cfg, on_device_graph=True,
                                        slab=True, pallas_tail=False,
                                        seed=5)
    params = jax.device_get(jpipe.params)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jax_dir, 11, {"params": params}, config=cfg,
                             train_config={"batch_size": 2})
    convert_jax_checkpoint.convert(jax_dir, port_dir)
    assert open(os.path.join(port_dir, "config")).read() == open(
        os.path.join(jax_dir, "config")).read()
    assert os.path.isfile(os.path.join(port_dir, "train_config"))
    state, step = ckpt.restore_checkpoint(port_dir, device="cpu")
    assert step == 11
    want, got = dict(_leaves(params)), dict(_leaves(state["params"]))
    assert want.keys() == got.keys()
    for key, val in want.items():
        if val is None:
            assert got[key] is None, key
            continue
        val = np.asarray(val)
        out = got[key].numpy()
        assert out.dtype == val.dtype and out.tobytes() == val.tobytes(), key

    out_dir = str(tmp_path / "out")
    rc = run_torch.main([port_dir, "--fast", "--device", "cpu",
                         "--dataset_root_dir", root, "--output_dir",
                         out_dir])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "Restored step 11" in printed and "total:" in printed
    pipe = infer.InferencePipeline(cfg, checkpoint_dir=port_dir,
                                   device="cpu", on_device_graph=True)
    assert pipe.restored_step == 11
    pipe.run_dataset(_dataset(root, kitti), str(tmp_path / "direct"),
                     verbose=False)
    cli = _read_labels(out_dir)
    assert len(cli) == 3 and cli == _read_labels(str(tmp_path / "direct"))


def test_cli_without_fast_refuses(setup, tmp_path, capsys, monkeypatch):
    """(Named when the CLI refused host graphs.)  Without ``--fast`` the
    CLI serves host-built graphs (no kernel launch) into ``<checkpoint>/eval``; a directory
    without a config still exits 2.  The family's runtime capacity is cut
    to a CPU size (the frames grow it)."""
    root, cfg, params = setup
    rc = run_torch.main([str(tmp_path), "--device", "cpu",
                         "--dataset_root_dir", root])
    assert rc == 2
    assert "No config file" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(str(tmp_path), "eval"))
    small = dict(configs.tpu_settings("Car"), runtime_capacity=(
        tpad.GraphCapacity((2048, 512, 512), (16384, 32768))))
    monkeypatch.setattr(configs, "tpu_settings", lambda name: small)
    ck = str(tmp_path / "ck")
    ckpt.save_checkpoint(ck, 3, {"params": params_from_jax(params, "cpu")},
                         config=cfg)
    rc = run_torch.main([ck, "--device", "cpu", "--dataset_root_dir", root])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(last)["launches"].values()) == {0}
    assert len(_read_labels(os.path.join(ck, "eval"))) == 3
