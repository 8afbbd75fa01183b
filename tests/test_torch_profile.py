"""The port's three card tools on the CPU at a tiny spec (the plain kernel
versions run): ``profile_inference.profile`` and
``profile_train_step.profile`` return every key of the JAX tools, with
``cold_frame_ms = put_ms + total_ms`` and the train step's attribution
derived from its stages; ``tune_slab_kernels`` parses ``block_centers``
variants (with JAX's ``l0:`` / ``l1:`` prefixes) and refuses the tile,
sweeps two variants with bitwise-equal outputs and suggests by the 3%
rule; ``InferencePipeline(slab_tuning=...)`` reads the JAX pipeline's
dict shapes, passes ``block_centers`` to ``slab_edge_max`` and raises on
``tile`` / ``sub`` / ``zscan``."""

import numpy as np
import pytest

from pointgnn_tpu_torch import configs, infer
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.nn import slab
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

from tools_torch import profile_inference, profile_train_step
from tools_torch import tune_slab_kernels as tsk


def _tiny_config(T=1):
    cfg = configs.model_config("Car", T=T)
    for lc in cfg["model_kwargs"]["layer_configs"][:-1]:
        kw = lc["kwargs"]
        if "point_MLP_depth_list" in kw:
            kw["point_MLP_depth_list"] = [8, 16]
            kw["output_MLP_depth_list"] = [16, 16]
        else:
            kw["auto_offset_MLP_depth_list"] = [8, 3]
            kw["edge_MLP_depth_list"] = [16, 16]
            kw["update_MLP_depth_list"] = [16, 16]
    return cfg


def _spec(cfg, runtime=True):
    return db.spec_from_config(cfg, num_points=512, num_keypoints=128,
                               cell_caps=(8, 16), per_center_caps=(8, 16),
                               runtime=runtime)


def test_profile_inference_keys():
    cfg = _tiny_config()
    out = profile_inference.profile(cfg, _spec(cfg), reps=2, probe=False,
                                    device="cpu")
    assert set(out) == {"put_ms", "total_ms", "graph_ms", "gnn_ms",
                        "tail_ms", "cold_frame_ms"}
    assert out["total_ms"] > 0 and out["gnn_ms"] > 0 and out["graph_ms"] > 0
    assert out["cold_frame_ms"] == pytest.approx(
        out["put_ms"] + out["total_ms"], abs=1e-9)
    assert out["tail_ms"] == pytest.approx(
        out["total_ms"] - out["graph_ms"] - out["gnn_ms"], abs=1e-9)
    assert profile_inference.matmul_probe_tflops("cpu", n=64, reps=2) > 0
    assert profile_inference.main(
        ["--T", "0", "--num_points", "256", "--num_keypoints", "64",
         "--reps", "1", "--no-probe", "--device", "cpu"]) == 0


def test_profile_train_step_keys():
    cfg = _tiny_config()
    out = profile_train_step.profile(cfg, reps=2, probe=False, device="cpu",
                                     spec=_spec(cfg, runtime=False))
    stages = ("graph_build_ms", "forward_ms", "loss_ms", "grad_ms",
              "step_ms")
    assert set(out) == set(stages) | {"attribution", "steps",
                                      "finite_loss_steps", "first_loss"}
    assert all(out[k] > 0 for k in stages)
    assert out["steps"] == 3 and 1 <= out["finite_loss_steps"] <= 3
    assert np.isfinite(out["first_loss"])
    att = out["attribution"]
    assert att["backward"] == pytest.approx(out["grad_ms"] - out["loss_ms"])
    assert att["opt_and_fixed"] == pytest.approx(
        out["step_ms"] - out["grad_ms"] - out["graph_build_ms"])
    assert att["loss_extra"] == pytest.approx(
        out["loss_ms"] - out["forward_ms"])


def test_parse_variants():
    assert tsk.parse_variants("16, 64") == [{"block_centers": 16},
                                            {"block_centers": 64}]
    assert tsk.parse_variants("") == []
    assert tsk.parse_variants("l0:16,l1:8,32") == [
        {"level0": {"block_centers": 16}},
        {"level1": {"block_centers": 8}},
        {"block_centers": 32},
    ]
    for bad in ("l2:16", "16y", "x", "0", "l0:0", "-4", "l1:"):
        with pytest.raises(ValueError, match="bad variant"):
            tsk.parse_variants(bad)
    with pytest.raises(ValueError, match="tile"):
        tsk.parse_variants("16x32")
    assert tsk.name_of(None) == "default(32)"
    assert tsk.name_of({"level0": {"block_centers": 8},
                        "level1": {"block_centers": 64}}) == \
        "level0:8,level1:64"
    rows = [(None, 10.0), ({"block_centers": 16}, 9.6),
            ({"block_centers": 8}, 9.0), ("baseline-recheck", 1.0)]
    assert tsk.suggestion(rows) == {"block_centers": 8}
    assert tsk.suggestion([(None, 10.0), ({"block_centers": 8}, 9.8),
                           ("baseline-recheck", 10.0)]) is None


def test_sweep_outputs_bitwise(capsys):
    cfg = _tiny_config()
    frames = [synthetic_lidar_frame(seed=i, n_beams=16,
                                    points_per_beam=40)[0] for i in range(2)]
    variants = tsk.parse_variants("8,l1:64")
    rows = tsk.sweep(cfg, _spec(cfg), variants, frames, 2, device="cpu")
    assert [r[0] for r in rows] == [None] + variants + ["baseline-recheck"]
    assert all(ms > 0 for _, ms in rows)
    assert tsk.main(["--T", "0", "--num_points", "256", "--num_keypoints",
                     "64", "--variants", "16", "--frames", "1",
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "bitwise equal" in printed and "default(32)" in printed


def _pipe(cfg, **kw):
    return infer.InferencePipeline(cfg, on_device_graph=True,
                                   device_spec=_spec(cfg), device="cpu",
                                   **kw)


def test_slab_tuning_reaches_slab_edge_max(monkeypatch):
    cfg = _tiny_config()
    seen = []
    orig = slab.slab_edge_max

    def record(*args, **kw):
        seen.append(kw["block_centers"])
        return orig(*args, **kw)

    monkeypatch.setattr(slab, "slab_edge_max", record)
    pts = synthetic_lidar_frame(seed=0, n_beams=16, points_per_beam=40)[0]
    base = _pipe(cfg)
    want = base.run_frame(pts)
    for tuning, levels in (
            ({"block_centers": 8}, [8, 8]),
            ({"level0": {"block_centers": 16}}, [16, 32]),
            ({"level1": {"block_centers": 4}}, [32, 4]),
            ({"block_centers": 64, "level1": {"block_centers": 4}}, [64, 4]),
            ({"level0": {}, "level1": {"block_centers": np.int64(2)}},
             [32, 2])):
        seen.clear()
        pipe = _pipe(cfg, params=base.params, slab_tuning=tuning)
        got = pipe.run_frame(pts)
        assert seen == levels, tuning
        for a, b in zip(got[:3], want[:3]):
            assert a.tobytes() == b.tobytes()
    # slab="l1": level 0 has no slab_edge_max; a flat tuning tunes level 1
    l1 = _pipe(cfg, params=base.params, slab="l1",
               slab_tuning={"block_centers": 8})
    assert l1.model.slab_level1["block_centers"] == 8
    assert l1.model.slab_level0 is None


@pytest.mark.parametrize("tuning, match", [
    ({"tile": 32}, "tile"),
    ({"block_centers": 16, "sub": 8}, "sub"),
    ({"level1": {"zscan": "row"}}, "zscan"),
    ({"level0": {"tile": 8, "sub": 4}}, "sub, tile"),
    ({"blocks": 4}, "unknown keys blocks"),
    ({"block_centers": 0}, "positive int"),
    ({"block_centers": 8.0}, "positive int"),
    ({"block_centers": True}, "positive int"),
])
def test_slab_tuning_refuses(tuning, match):
    with pytest.raises(ValueError, match=match):
        _pipe(_tiny_config(), slab_tuning=tuning)


def test_slab_tuning_needs_the_kernel():
    cfg = _tiny_config()
    for kw, tuning in (
            (dict(slab=False, pallas_tail=False), {"block_centers": 8}),
            (dict(slab="l1"), {"level0": {"block_centers": 8}})):
        with pytest.raises(ValueError, match="does not run"):
            _pipe(cfg, slab_tuning=tuning, **kw)
    with pytest.raises(ValueError, match="slab_tuning"):
        infer.InferencePipeline(cfg, device="cpu",
                                slab_tuning={"block_centers": 8})
    # edge_chunks: 8 on device graphs unless given, one block on the host
    assert _pipe(cfg, slab=False, pallas_tail=False).model.edge_chunks == 8
    assert _pipe(cfg, slab=False, pallas_tail=False,
                 edge_chunks=3).model.edge_chunks == 3
    assert infer.InferencePipeline(cfg, device="cpu").model.edge_chunks == 1
    assert infer.InferencePipeline(cfg, device="cpu",
                                   edge_chunks=2).model.edge_chunks == 2
