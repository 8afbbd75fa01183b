"""The plumbing of ``smoke_train_eval_torch.py`` on the CPU.

Its recipes are the JAX tool's: host-built graphs by default, and
``--device_graph``.  The run itself goes in-process with the model
narrowed to widths 16-32, a 2048-point / 256-keypoint device spec and
small host capacities (the full-width recipe is a card's work): 2
frames, 4 steps, then ``Evaluator``, ``run_dataset`` on host-built and on
device-built graphs, and the AP evaluator.  It exits 0 and prints every
AP line of both passes, the skipped oracle and its JSON line; with the
BEV gate above what it scored it exits 1.
"""

import json

import pytest

from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.graph.pad import GraphCapacity
from pointgnn_tpu_torch.train import summary
from pointgnn_tpu_torch.utils import synthetic_kitti

import smoke_train_eval_torch as smoke


@pytest.fixture(autouse=True)
def _jsonl_summaries_only(monkeypatch):
    """Scalars go to the JSONL files only (TensorBoard would import
    TensorFlow, ~16 s here)."""
    monkeypatch.setattr(summary, "_tb_writer", lambda directory: None)


def test_recipe_is_the_jax_tools():
    args = smoke.parse_args([])
    config, tc = smoke.recipe(args)
    # the default: host-built graphs at batch 2
    assert (args.frames, args.steps, args.T) == (14, 1200, 1)
    assert (tc["batch_size"], tc["max_epoch"], tc["device_graph"]) == (
        2, 171, False)
    assert smoke.TRAIN_CAPACITY == dict(vertices=(32768, 12288, 12288),
                                        edges=(131072, 524288))
    assert smoke.EVAL_CAPACITY == dict(vertices=(32768, 12288, 12288),
                                       edges=(524288, 2097152))
    args = smoke.parse_args(["--device_graph"])
    config, tc = smoke.recipe(args)
    assert (args.frames, args.steps, args.T) == (14, 2400, 1)
    assert args.min_bev_ap == 85.0 and args.min_ap == -1.0
    assert args.device == "cuda"
    assert config["loss"] == {"cls_loss_type": "focal_sigmoid",
                              "cls_loss_weight": 1.0,
                              "loc_loss_weight": 10.0}
    assert len(config["model_kwargs"]["layer_configs"]) == 3  # T=1
    want = {"batch_size": 1, "NUM_GPU": 1, "num_load_dataset_workers": 2,
            "load_dataset_every_N_time": 4, "max_epoch": 171,
            "max_steps": 2400, "save_every_epoch": 15, "optimizer": "adam",
            "initial_lr": 1e-3, "decay_step": 2400, "data_aug_configs": [],
            "device_graph": True}
    assert {k: tc[k] for k in want} == want
    args = smoke.parse_args(["--label_method", "Pedestrian_and_Cyclist",
                             "--device_graph"])
    config, tc = smoke.recipe(args)
    assert (args.frames, args.steps) == (28, 4800)
    assert config["num_classes"] == 6
    args = smoke.parse_args(["--label_method", "Pedestrian_and_Cyclist"])
    smoke.recipe(args)
    assert (args.frames, args.steps) == (28, 2400)


def _narrow(config):
    for lc in config["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [16, 24, 32]
            kw["output_MLP_depth_list"] = [32, 32]
        else:
            kw["auto_offset_MLP_depth_list"] = [16, 3]
            kw["edge_MLP_depth_list"] = [32, 32]
            kw["update_MLP_depth_list"] = [32, 32]
    return config


SMALL_TRAIN = GraphCapacity(vertices=(8192, 2048, 2048),
                            edges=(32768, 131072))
SMALL_EVAL = GraphCapacity(vertices=(4096, 1024, 1024),
                           edges=(32768, 131072))


def _check_run(lines, steps):
    for label in ("host", "fast(on-device)"):
        ap_lines = [ln for ln in lines if ln.startswith("[%s]" % label)]
        assert len(ap_lines) == 9, label  # Car: 3 metrics x 3 difficulties
    assert any(ln.startswith("oracle: skipped") for ln in lines)
    assert any(ln.startswith("evaluator, step %d: total_loss" % steps)
               for ln in lines)
    out = json.loads(lines[-1])
    assert out["passed"] and out["steps"] == steps
    assert set(out["serve"]) == set(out["ap"]) == {"host", "fast"}
    assert set(out["serve"]["host"]["serve_ms_per_frame"]) == {
        "fetch input", "gen graph", "gnn inference", "decode box", "nms",
        "total"}
    assert set(out["serve"]["fast"]["serve_ms_per_frame"]) == {
        "fetch input", "gen graph", "gnn inference", "nms", "total"}
    assert len(out["serve"]["host"]["kitti_conversion_ms_per_frame"]) == 2
    assert set(out["launches"]) == {"train", "eval", "serve_host",
                                     "serve_fast"}
    assert "Car_bev_moderate" in out["ap"]["host"]
    assert out["bev_moderate_min"] == min(out["bev_moderate"].values())
    return out


def test_smoke_runs_and_gates(tmp_path, capsys):
    """The ``--device_graph`` recipe, then the gate."""
    synthetic_kitti.main(str(tmp_path / "kitti"), 2, n_ground=600)
    argv = [str(tmp_path), "--device_graph", "--device", "cpu", "--frames",
            "2", "--steps", "4", "--min_bev_ap", "-1"]
    args = smoke.parse_args(argv)
    config, tc = smoke.recipe(args)
    _narrow(config)
    tc["device_graph_spec"] = db.spec_from_config(
        config, num_points=2048, num_keypoints=256, runtime=False)
    tc["num_load_dataset_workers"] = 0
    serve = db.spec_from_config(config, num_points=2048, num_keypoints=256)
    kw = dict(serve_spec=serve, eval_capacity=SMALL_EVAL)
    assert smoke.run(args, config, tc, **kw) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = _check_run(lines, 4)
    assert out["recipe"] == "device_graph"
    # the gate: above what the run scored, the same run exits 1 (resumed
    # at its last checkpoint, so it trains no further step)
    args = smoke.parse_args(argv[:-1] + [
        str(out["bev_moderate_min"] + 1.0)])
    assert smoke.run(args, config, tc, **kw) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(ln.startswith("FAIL: BEV") for ln in lines)
    again = json.loads(lines[-1])
    assert not again["passed"] and again["steps"] == 0


def test_smoke_host_recipe_runs(tmp_path, capsys):
    """The default recipe: host-built graphs at batch 2, then the
    host-graph ``Evaluator`` and both passes; no kernel launch on the
    CPU."""
    synthetic_kitti.main(str(tmp_path / "kitti"), 2, n_ground=600)
    args = smoke.parse_args([str(tmp_path), "--device", "cpu", "--frames",
                             "2", "--steps", "2", "--min_bev_ap", "-1"])
    config, tc = smoke.recipe(args)
    _narrow(config)
    tc["num_load_dataset_workers"] = 0
    serve = db.spec_from_config(config, num_points=2048, num_keypoints=256)
    assert smoke.run(args, config, tc, serve_spec=serve,
                     train_capacity=SMALL_TRAIN,
                     eval_capacity=SMALL_EVAL) == 0
    out = _check_run(capsys.readouterr().out.strip().splitlines(), 2)
    assert out["recipe"] == "host"
    assert all(n == 0 for stage in out["launches"].values()
               for n in stage.values())
