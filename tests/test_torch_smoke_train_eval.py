"""The plumbing of ``smoke_train_eval_torch.py`` on the CPU.

Its recipe is the JAX tool's ``--device_graph`` mode.  The run itself
goes in-process with the model narrowed to widths 16-32 and a
2048-point / 256-keypoint training spec (the full-width recipe is a
card's work): 2 frames, 4 steps, then ``Evaluator``, ``run_dataset``
and the AP evaluator.  It exits 0 and prints every AP line, the skipped
paths and its JSON line; with the BEV gate above what it scored it
exits 1.
"""

import json

import pytest

from pointgnn_tpu_torch.graph import device_builder as db
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
    args = smoke.parse_args(["--label_method", "Pedestrian_and_Cyclist"])
    config, tc = smoke.recipe(args)
    assert (args.frames, args.steps) == (28, 4800)
    assert config["num_classes"] == 6


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


def test_smoke_runs_and_gates(tmp_path, capsys):
    synthetic_kitti.main(str(tmp_path / "kitti"), 2, n_ground=600)
    argv = [str(tmp_path), "--device", "cpu", "--frames", "2", "--steps",
            "4", "--min_bev_ap", "-1"]
    args = smoke.parse_args(argv)
    config, tc = smoke.recipe(args)
    _narrow(config)
    tc["device_graph_spec"] = db.spec_from_config(
        config, num_points=2048, num_keypoints=256, runtime=False)
    tc["num_load_dataset_workers"] = 0
    serve = db.spec_from_config(config, num_points=2048, num_keypoints=256)
    assert smoke.run(args, config, tc, serve_spec=serve) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ap_lines = [ln for ln in lines if ln.startswith("[fast(on-device)]")]
    assert len(ap_lines) == 9  # Car: 3 metrics x 3 difficulties
    for path in ("host", "oracle"):
        assert any(ln.startswith(path + ": skipped") for ln in lines)
    assert any(ln.startswith("evaluator, step 4: total_loss") for ln in lines)
    out = json.loads(lines[-1])
    assert out["passed"] and out["steps"] == 4
    assert set(out["serve_ms_per_frame"]) == {
        "fetch input", "gen graph", "gnn inference", "nms", "total"}
    assert len(out["kitti_conversion_ms_per_frame"]) == 2
    assert set(out["launches"]) == {"train", "eval", "serve"}
    assert "Car_bev_moderate" in out["ap"]
    # the gate: above what the run scored, the same run exits 1 (resumed
    # at its last checkpoint, so it trains no further step)
    args = smoke.parse_args(argv[:-1] + [
        str(out["bev_moderate_min"] + 1.0)])
    assert smoke.run(args, config, tc, serve_spec=serve) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(ln.startswith("FAIL: BEV") for ln in lines)
    again = json.loads(lines[-1])
    assert not again["passed"] and again["steps"] == 0
