"""The port's tools against the JAX package's: the analytic FLOP counts
(``utils/flops.py``) equal; the reference-checkpoint converter bitwise
``params_from_jax`` of the JAX converter's tree (NONE and BN configs), its
missing-variable error, and its CLI's checkpoint served by
``run_torch.py``; ``make_splits.py`` byte-equal and the crop library
equal to the JAX tools' outputs; ``point_cloud_downsample.beam_mask``
equal to the JAX tool's (scikit-learn's k-means) on a frame of distinct
beams, its centres within 1e-6."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

import jax

from pointgnn_tpu import configs as jconfigs
from pointgnn_tpu.model.pointgnn import PointGNN as JaxPointGNN
from pointgnn_tpu.train import convert as jconvert
from pointgnn_tpu.utils import flops as jflops
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.graph import pad as tpad
from pointgnn_tpu_torch.params import params_from_jax
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.train import convert as tconvert
from pointgnn_tpu_torch.utils import config_io, flops as tflops
from pointgnn_tpu_torch.utils import synthetic_kitti

from tools_torch import build_crop_library as t_crop
from tools_torch import convert_reference_checkpoint as t_convert
from tools_torch import make_splits as t_splits
from tools_torch import point_cloud_downsample as t_downsample

from test_convert import _fake_tf_vars

import run_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CAP = dict(vertices=(1024, 768, 768), edges=(8192, 32768))


def _jax_tool(name):
    """A JAX tool module loaded from ``tools/`` under its own name."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    _jax_tool(name).main()


def _cells(rng, n, grid_g, pad=0):
    """Row offsets of ``n`` candidates sorted by cell, and the cells of
    ``n // 3`` centers (``pad`` of them the pad cell ``grid_g**2``)."""
    cells = np.sort(rng.integers(0, grid_g * grid_g, n))
    offsets = np.zeros(grid_g * grid_g + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(cells, minlength=grid_g * grid_g))
    centers = rng.integers(0, grid_g * grid_g, n // 3).astype(np.int32)
    centers[:pad] = grid_g * grid_g
    return offsets, centers


def test_flops_equal_jax():
    rng = np.random.default_rng(0)
    assert tflops.dense_chain_flops(37, [3, 64, 300]) == \
        jflops.dense_chain_flops(37, [3, 64, 300])
    ctr = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    cand = rng.uniform(-5, 5, (900, 3)).astype(np.float32)
    for radius, chunk in ((1.0, 64), (2.5, 1024)):
        got = tflops.count_inradius_pairs(ctr, cand, radius, chunk)
        assert got == jflops.count_inradius_pairs(ctr, cand, radius, chunk)
        assert got > 0
    grid_g = 8
    offsets, centers = _cells(rng, 600, grid_g, pad=5)
    for bk, tile, halo in ((32, 32, 1), (16, 8, 2)):
        got = tflops.slab_walk_pairs(offsets, centers, grid_g, bk, tile,
                                     halo)
        assert got == jflops.slab_walk_pairs(offsets, centers, grid_g, bk,
                                             tile, halo)
        assert got["walked_pairs"] > 0
    cand_xyz = rng.uniform(0, 8, (600, 3)).astype(np.float32)
    ctr_xyz = rng.uniform(0, 8, (200, 3)).astype(np.float32)
    for sub in (0, 8, 12, 32):
        args = (offsets, centers[:150], cand_xyz, ctr_xyz[:150], grid_g,
                1.0, 32, 32, sub)
        assert tflops.slab_walk_pairs_subblock(*args) == \
            jflops.slab_walk_pairs_subblock(*args)
    for label, T in (("Car", 3), ("Pedestrian_and_Cyclist", 1)):
        tcfg = configs.model_config(label, T=T)
        jcfg = jconfigs.model_config(label, T=T)
        for kw in (dict(), dict(cls_ks=(128,), loc_ks=(128, 128))):
            got = tflops.pointgnn_forward_flops(tcfg, 1, 24576, 12288,
                                                397346, 1135680, **kw)
            want = jflops.pointgnn_forward_flops(jcfg, 1, 24576, 12288,
                                                 397346, 1135680, **kw)
            assert got == want and got > 1e9
    assert tflops.__all__ == jflops.__all__


def _jax_model(norm=None, T=1):
    cfg = jconfigs.model_config("Car", T=T)
    if norm:
        for lc in cfg["model_kwargs"]["layer_configs"]:
            for k in list(lc["kwargs"]):
                if k.endswith("normalization_type"):
                    lc["kwargs"][k] = norm
    model = JaxPointGNN(
        num_classes=cfg["num_classes"], box_encoding_len=7,
        layer_configs=cfg["model_kwargs"]["layer_configs"], mode="test")
    return cfg, model, model.init(jax.random.PRNGKey(0), input_dim=1)


def _assert_same_tree(got, want, path=""):
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], path + "/" + str(k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same_tree(a, b, "%s/%d" % (path, i))
    else:
        a, b = got.numpy(), want.numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("norm", [None, "fused_BN_center", "BN"])
def test_convert_reference_weights_bitwise(norm):
    cfg, model, params = _jax_model(norm)
    tf_vars = _fake_tf_vars(model, params)
    if norm:  # random BN state, positive variances
        rng = np.random.default_rng(1)
        tf_vars = {k: ((np.abs(rng.normal(0, 1, v.shape)) + 0.5)
                       if k.endswith("moving_variance")
                       else rng.normal(0, 1, v.shape)).astype(np.float32)
                   for k, v in tf_vars.items()}
    layers = cfg["model_kwargs"]["layer_configs"]
    assert tconvert.reference_name_map(layers, 4) == \
        jconvert.reference_name_map(layers, 4)
    assert tconvert.used_variable_names(layers, 4) == \
        jconvert.used_variable_names(layers, 4)
    got = tconvert.convert_reference_weights(tf_vars, layers, 4,
                                             device="cpu")
    want = params_from_jax(
        jconvert.convert_reference_weights(tf_vars, layers, 4), "cpu")
    _assert_same_tree(got, want)
    if norm:
        assert "ema_var" in got["layer1"]["point_mlp"][0]["norm"]
    victim = next(k for k in tf_vars if k.endswith("weights"))
    del tf_vars[victim]
    with pytest.raises(KeyError, match="missing 1 expected"):
        tconvert.convert_reference_weights(tf_vars, layers, 4, device="cpu")


def _tree_paths(root):
    return (os.path.join(root, "image/training/image_2"),
            os.path.join(root, "velodyne/training/velodyne"),
            os.path.join(root, "calib/training/calib"),
            os.path.join(root, "labels/training/label_2"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools_tree"))
    synthetic_kitti.main(root, 3, classes=("Car", "Pedestrian", "Cyclist"),
                         n_ground=300)
    # a frame holding only a Car, one holding no object
    labels = _tree_paths(root)[3]
    for fid, keep in (("000001", ("Car",)), ("000002", ())):
        path = os.path.join(labels, fid + ".txt")
        lines = [ln for ln in open(path) if ln.split(" ")[0] in keep]
        open(path, "w").write("".join(lines))
    return root


def test_convert_cli_checkpoint_serves(tree, tmp_path, capsys, monkeypatch):
    """The CLI writes the port's checkpoint of the converted weights,
    which ``run_torch.py`` serves on host graphs (the family's capacity
    cut to a CPU size)."""
    cfg = configs.model_config("Car", T=1)
    for lc in cfg["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    model = JaxPointGNN(num_classes=4, box_encoding_len=7, mode="test",
                        layer_configs=cfg["model_kwargs"]["layer_configs"])
    params = model.init(jax.random.PRNGKey(2), input_dim=1)
    tf_vars = _fake_tf_vars(model, params)
    npz, cfg_path = str(tmp_path / "ref.npz"), str(tmp_path / "config")
    np.savez(npz, **tf_vars)
    config_io.save_config(cfg_path, cfg)
    out = str(tmp_path / "converted")
    assert t_convert.main([npz, cfg_path, out, "--step", "1400000"]) == 0
    assert "converted" in capsys.readouterr().out
    state, step = ckpt.restore_checkpoint(out, device="cpu")
    assert step == 1400000
    _assert_same_tree(state["params"], params_from_jax(
        jax.device_get(params), "cpu"))
    small = dict(configs.tpu_settings("Car"),
                 runtime_capacity=tpad.GraphCapacity(**SMALL_CAP))
    monkeypatch.setattr(configs, "tpu_settings", lambda name: small)
    served = str(tmp_path / "served")
    assert run_torch.main([out, "--device", "cpu", "--dataset_root_dir",
                           tree, "--output_dir", served]) == 0
    assert "Restored step 1400000" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(served, "data"))) == [
        "000000.txt", "000001.txt", "000002.txt"]


@pytest.mark.parametrize("classes, base", [
    (["Car"], None), (["Pedestrian", "Cyclist"], "3DOP_splits/val.txt"),
    (["Van"], None)])
def test_make_splits_byte_equal(tree, tmp_path, monkeypatch, capsys,
                                classes, base):
    argv = [tree, "--classes"] + classes
    if base:
        argv += ["--base-split", os.path.join(tree, base)]
    mine, ref = str(tmp_path / "t" / "s.txt"), str(tmp_path / "j" / "s.txt")
    assert t_splits.main(argv + ["--output", mine]) == 0
    _run_jax_tool("make_splits", argv + ["--output", ref], monkeypatch)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(mine, ref) == out[1]
    assert open(mine, "rb").read() == open(ref, "rb").read()
    n = len(open(mine).read().split())
    assert n == {"Car": 2, "Pedestrian": 1, "Van": 0}[classes[0]]


def test_crop_library_equal(tree, tmp_path, monkeypatch):
    argv = ["--split", "3DOP_splits/val.txt", "--min_points", "2",
            "--expand", "1.2", "1.1", "1.3"]
    mine, ref = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert t_crop.main([tree, mine] + argv) == 0
    _run_jax_tool("build_crop_library", [tree, ref] + argv, monkeypatch)
    got, want = json.load(open(mine)), json.load(open(ref))
    assert got == want
    assert sum(len(v) for v in got[0].values()) >= 3


def _beam_frame(seed, n_beams=64, per_beam=300):
    """Velodyne-frame points on ``n_beams`` elevation rings."""
    rng = np.random.default_rng(seed)
    elev = np.deg2rad(np.linspace(-24.9, 2.0, n_beams))[:, None]
    azim = rng.uniform(-np.pi, np.pi, (n_beams, per_beam))
    rng_m = rng.uniform(4.0, 70.0, (n_beams, per_beam))
    xyz = np.stack([rng_m * np.cos(elev) * np.cos(azim),
                    rng_m * np.cos(elev) * np.sin(azim),
                    rng_m * np.sin(elev) * np.ones_like(azim)], axis=-1)
    return xyz.reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("rate", [2, 3])
def test_beam_mask_equals_jax(rate):
    from sklearn.cluster import KMeans

    xyz = _beam_frame(rate)
    got = t_downsample.beam_mask(xyz, rate)
    want = _jax_tool("point_cloud_downsample").beam_mask(xyz, rate)
    assert got.dtype == want.dtype and (got == want).all()
    assert abs(got.mean() - 1.0 / rate) < 0.02
    norm = np.sqrt(np.sum(xyz * xyz, axis=1, keepdims=True))
    cos = (xyz[:, [2]] / np.maximum(norm, 1e-12)).astype(np.float64)
    mine = t_downsample.kmeans_1d(cos, 64, n_init=3, seed=0)
    ref = np.sort(np.squeeze(KMeans(n_clusters=64, n_init=3,
                                    random_state=0).fit(cos)
                             .cluster_centers_))
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
