"""The serving loop's own bookkeeping: what the tap keeps, which frames
are judged, what set-up leaves out, and the judge's nearer reference."""

import argparse
import json
import pathlib

import numpy as np

from benchmark.core import harness, judge, lidar
from benchmark.loops import serve

BENCH = pathlib.Path(__file__).resolve().parents[1]


class _Pipe:
    def device_fn(self, params, packed):
        return packed


def test_tap_keeps_two_latest_calls_of_each_pick_and_of_all():
    pipe = _Pipe()
    tap = serve._Tap(pipe, start=8, pool=64, picks=[3, 10])
    for c in range(300):
        assert pipe.device_fn(None, c) == c
        assert len(tap.kept) <= 6
        assert all(tap.kept[k] == k for k in tap.kept)
    assert sorted(tap.kept) == [195, 202, 259, 266, 298, 299]


def test_tap_keeps_nothing_before_start():
    pipe = _Pipe()
    tap = serve._Tap(pipe, start=8, pool=64, picks=[3])
    for c in range(8):
        pipe.device_fn(None, c)
    assert tap.kept == {} and tap.calls == 8


def test_judged_frames_are_drawn_from_the_seed_with_the_largest():
    mix = json.loads((BENCH / "traffic" / "stream.json").read_text())
    mix.update(pool_frames=6, points_per_beam=[20, 30])
    pool = lidar.make_pool(mix, 2 ** 31 + 9)
    picks = serve.judge_picks(mix, 2 ** 31 + 9, pool)
    assert picks == serve.judge_picks(mix, 2 ** 31 + 9, pool)
    assert int(np.argmax([len(x) for x, _ in pool])) in picks
    assert len(picks) in (mix["sample_frames"], mix["sample_frames"] + 1)


def test_set_up_leaves_out_the_benchmarks_own_seconds():
    args = argparse.Namespace(workload="w", seed=1, seconds=1.0, trace=0)
    ctx = harness.Context(args, {}, {}, None, t_start=0.0)
    ctx.mark_setup_done(excluded_s=0.0)
    whole = ctx.setup_s
    ctx.mark_setup_done(excluded_s=5.0)
    assert whole - 5.0 - 1.0 < ctx.setup_s <= whole - 5.0 + 1.0


def test_a_number_is_taken_against_the_nearer_reference(monkeypatch):
    rows = {"a": {"score_err": 0.1, "box_err": 0.0, "score_median": 0.3,
                  "box_median": 0.0},
            "b": {"score_err": 0.2, "box_err": 0.5, "score_median": 0.1,
                  "box_median": 0.4}}
    monkeypatch.setattr(judge, "judge_network",
                        lambda hyps, graph, probs, *a: rows[probs])
    monkeypatch.setattr(judge, "judge_nms", lambda *a: 0.25)
    numbers, detail = judge.judge_frames(
        [(None, "dets", None, {"a": ("a", None), "b": ("b", None)}),
         (None, None, None, {"a": ("a", None), "b": ("b", None)})], {}, 1)
    assert numbers == {"score_err": 0.1, "box_err": 0.0,
                       "score_median": 0.1, "box_median": 0.0,
                       "nms_err": 0.25}
    assert detail == rows


def test_nothing_judged_is_not_correct():
    numbers, _ = serve.check_frames([], None, None, None, None)
    limits = {n: 1.0 for n in judge.NUMBERS}
    assert not judge.verdict(numbers, limits)
    json.dumps(numbers, allow_nan=False)
