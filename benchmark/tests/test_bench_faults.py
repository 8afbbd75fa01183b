"""A run with the timed path broken underneath comes out not correct,
and each control (the reference in the program's place, one precision
down) fails the limits too.  Tiny sizes on the CPU; the real limits."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.core import judge, lidar
from benchmark.loops import serve
from helpers import TINY, tiny_run

BENCH = pathlib.Path(__file__).resolve().parents[1]


def test_unbroken_run_is_correct():
    result, lines = tiny_run("car_auto_T3.stream")
    assert result["correct"], lines
    assert result["attempted"] >= 1


def _alter_device_output(monkeypatch, fn):
    from pointgnn_tpu_torch.infer import InferencePipeline

    inner = InferencePipeline.device_fn

    def broken(self, params, packed):
        return fn(*inner(self, params, packed))

    monkeypatch.setattr(InferencePipeline, "device_fn", broken)


def _score_altered(scores, cls, boxes, xyz):
    scores = scores.clone()
    scores[3] += 0.2
    return scores, cls, boxes, xyz


def _box_altered(scores, cls, boxes, xyz):
    boxes = boxes.clone()
    boxes[5, 0] += 2.0
    return scores, cls, boxes, xyz


def _class_altered(scores, cls, boxes, xyz):
    cls = cls.clone()
    cls[0] = 3 - cls[0]
    return scores, cls, boxes, xyz


@pytest.mark.parametrize("fault", [_score_altered, _box_altered,
                                   _class_altered])
def test_an_answer_altered_where_it_is_produced(monkeypatch, fault):
    _alter_device_output(monkeypatch, fault)
    result, lines = tiny_run("car_auto_T3.stream")
    assert not result["correct"], lines


def test_a_detection_altered_in_the_nms(monkeypatch):
    from pointgnn_tpu_torch.infer import InferencePipeline

    inner = InferencePipeline._nms

    def broken(self, *args):
        cls, boxes, scores, aux = inner(self, *args)
        boxes = boxes.copy()
        boxes[0, 2] += 0.1
        return cls, boxes, scores, aux

    monkeypatch.setattr(InferencePipeline, "_nms", broken)
    result, lines = tiny_run("car_auto_T3.frame")
    assert not result["correct"], lines


def test_half_of_each_frame_left_out(monkeypatch):
    """The device program served on every other point of each frame."""
    from pointgnn_tpu_torch.graph import device_builder as db

    inner = db.pack_points

    def half(xyz, attr, num_points):
        return inner(xyz[::2], attr[::2], num_points)

    monkeypatch.setattr(db, "pack_points", half)
    result, lines = tiny_run("car_auto_T3.stream")
    assert not result["correct"], lines


def test_a_frame_answered_with_the_previous_frames_output(monkeypatch):
    from pointgnn_tpu_torch.infer import InferencePipeline

    inner = InferencePipeline.device_fn
    last = {}

    def stale(self, params, packed):
        outs = inner(self, params, packed)
        prev = last.get("outs", outs)
        last["outs"] = outs
        return prev

    monkeypatch.setattr(InferencePipeline, "device_fn", stale)
    result, lines = tiny_run("car_auto_T3.frame")
    assert not result["correct"], lines


# (network precision, NMS dtype) -> the numbers of which one has to fail:
# the network in float8 as a cheaper program would run it (folded tables
# in bfloat16 and every product on float8 operands, or unfolded), the
# NMS left out, fails a number of the network; the network as the
# reference runs it with the NMS in float32 fails the NMS's number
NETWORK = ("score_err", "box_err", "score_median", "box_median")
CONTROLS = {"fp8": ("fp8", None, NETWORK),
            "fp8_unfolded": ("fp8_unfolded", None, NETWORK),
            "nms_f32": ("f32", np.float32, ("nms_err",))}


def _fails(numbers, limits, names):
    return any(not numbers[n] <= limits[n] for n in names)


def _load(name):
    cfg = json.loads((BENCH / "configs" / (name + ".json")).read_text())
    mix = json.loads((BENCH / "traffic" / "stream.json").read_text())
    limits = json.loads((BENCH / "limits" / (name + ".serve.json"))
                        .read_text())
    return cfg, mix, limits


@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("name", ["car_auto_T3", "ped_cyl_auto_T3"])
def test_control_fails_the_limits(name, control):
    """The reference in the program's place one precision down, on three
    seeds at a tiny size."""
    cfg, mix, limits = _load(name)
    mix.update(TINY["mix"])
    precision, nms_dtype, names = CONTROLS[control]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        pool = lidar.make_pool(mix, seed)
        numbers, _ = serve.control_frames(pool, cfg, seed,
                                          torch.device("cpu"),
                                          range(len(pool)), precision,
                                          nms_dtype)
        assert _fails(numbers, limits, names), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("name", ["car_auto_T3", "ped_cyl_auto_T3"])
def test_control_fails_the_limits_at_the_cells_size(name, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    cfg, mix, limits = _load(name)
    precision, nms_dtype, names = CONTROLS[control]
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        pool = lidar.make_pool(mix, seed)
        frames = serve.judge_picks(mix, seed, pool)
        numbers, _ = serve.control_frames(pool, cfg, seed,
                                          torch.device("cuda"), frames,
                                          precision, nms_dtype)
        assert _fails(numbers, limits, names), numbers
