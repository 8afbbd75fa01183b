"""The traffic generator: deterministic per seed, the same work for
every seed, and the frozen frame generator equal to the program's."""

import json
import pathlib

import numpy as np
import pytest

from benchmark.core import lidar
from benchmark.frozen.synthetic import synthetic_lidar_frame

BENCH = pathlib.Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def mix(name, **kw):
    m = json.loads((BENCH / "traffic" / (name + ".json")).read_text())
    m.update(kw)
    return m


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_frames(name):
    m = mix(name, pool_frames=4, points_per_beam=[20, 30])
    a, b = lidar.make_pool(m, 2 ** 31 + 5), lidar.make_pool(m, 2 ** 31 + 5)
    for (xa, aa), (xb, ab) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(aa, ab)
    c = lidar.make_pool(m, 2 ** 31 + 6)
    assert any(len(x) != len(y) or not np.array_equal(x, y)
               for (x, _), (y, _) in zip(a, c))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_sizes(name):
    m = mix(name)
    plans = [lidar.frame_plan(m, s) for s in (0, 1, 2 ** 33 + 7)]
    sizes = [sorted((p, c) for _, p, c in plan) for plan in plans]
    assert sizes[0] == sizes[1] == sizes[2]
    assert [p for _, p, _ in plans[0]] != [p for _, p, _ in plans[1]]
    lo, hi = m["points_per_beam"]
    assert min(s[0] for s in sizes[0]) == lo
    assert max(s[0] for s in sizes[0]) == hi


def test_frozen_generator_equals_the_programs():
    from pointgnn_tpu_torch.utils.synthetic import (
        synthetic_lidar_frame as program_frame)

    for seed, ppb, cars in ((0, 380, 8), (4242, 300, 15)):
        xyz, attr, labels = synthetic_lidar_frame(seed, points_per_beam=ppb,
                                                  n_cars=cars)
        pts, want = program_frame(seed, points_per_beam=ppb, n_cars=cars)
        np.testing.assert_array_equal(xyz, pts.xyz)
        np.testing.assert_array_equal(attr, pts.attr)
        assert [lab["x3d"] for lab in labels] == [w["x3d"] for w in want]


def test_serving_frames_fit_the_spec():
    """No point and no keypoint is dropped at the serving spec."""
    from pointgnn_tpu_torch.graph import device_builder as db

    for name in ("car_auto_T3", "ped_cyl_auto_T3"):
        cfg = json.loads((BENCH / "configs" / (name + ".json")).read_text())
        serving = cfg["serving"]
        spec = db.spec_from_config(cfg["config"], serving["num_points"],
                                   serving["num_keypoints"])
        m = mix("stream")
        plan = lidar.frame_plan(m, 3)
        for s, p, c in (max(plan, key=lambda f: f[1]),
                        min(plan, key=lambda f: f[1])):
            xyz, _, _ = synthetic_lidar_frame(s, points_per_beam=p, n_cars=c)
            stats = db.host_overflow_stats(xyz, spec)
            assert stats["points_dropped"] == 0
            assert stats["keypoints_dropped"] == 0
