"""The port's KITTI AP evaluator against the JAX package's.

The port's executable is built at first use from
``pointgnn_tpu_torch/csrc/host/evaluate_object.cpp``; the reference is
``cpp/kitti_eval/evaluate_object.cpp``, compiled here into a temporary
directory with the same flags (never ``make`` into the package).  Both
run on the same label trees: perfect, shifted, a Van next to each Car,
empty results, and a random tree of three classes with DontCare regions,
occlusion, truncation and scored detections.  Their stdout must be
byte-equal, the ``stats_*`` files equal, and the port's ``evaluate()``
must give the JAX module's dict.  A failed build raises; an edited
source is rebuilt.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from pointgnn_tpu.postprocess import kitti_eval as jax_kitti_eval
from pointgnn_tpu_torch.postprocess import kitti_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "cpp", "kitti_eval", "evaluate_object.cpp")


@pytest.fixture(scope="module")
def binaries(tmp_path_factory):
    """(port executable, reference executable), built side by side."""
    ref = str(tmp_path_factory.mktemp("ref") / "evaluate_object_offline")
    cxx = os.environ.get("CXX") or "c++"
    proc = subprocess.Popen([cxx, *kitti_eval.CXX_FLAGS, "-o", ref,
                             REFERENCE])
    port = kitti_eval.binary_path()
    assert proc.wait(timeout=300) == 0
    return port, ref


def _gt_line(x, z, yaw=0.1, name="Car", occ=0, trunc=0.0, bbox_h=60,
             dims=(1.6, 1.8, 4.0)):
    y1, y2 = 150.0, 150.0 + bbox_h
    return ("%s %.2f %d -0.2 300.0 %.1f 400.0 %.1f %.2f %.2f %.2f %.2f 1.65 "
            "%.2f %.2f" % (name, trunc, occ, y1, y2, *dims, x, z, yaw))


def _det_line(x, z, score, yaw=0.1, name="Car", bbox=(300.0, 150.0, 400.0,
                                                       210.0),
              dims=(1.6, 1.8, 4.0)):
    return ("%s -1 -1 -0.2 %.1f %.1f %.1f %.1f %.2f %.2f %.2f %.2f 1.65 %.2f "
            "%.2f %.4f" % (name, *bbox, *dims, x, z, yaw, score))


def _write(root, name, gts, dets):
    gt_dir, res_dir = root / "gt", root / "res"
    os.makedirs(res_dir / "data", exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    (gt_dir / name).write_text("".join(g + "\n" for g in gts))
    (res_dir / "data" / name).write_text("".join(d + "\n" for d in dets))


def _perfect(root, shift=0.0, van=False, empty=False, seed=0):
    """The trees of ``tests/test_kitti_eval.py``: 20 frames of three
    Cars (and a far false positive), detections shifted by ``shift`` m,
    with a detected Van beside them, or no detections at all."""
    rng = np.random.default_rng(seed)
    for f in range(20):
        gts, dets = [], []
        for _ in range(3):
            x, z = float(rng.uniform(-15, 15)), float(rng.uniform(10, 50))
            gts.append(_gt_line(x, z))
            dets.append(_det_line(x + shift, z,
                                  score=float(rng.uniform(0.5, 1.0))))
        dets.append(_det_line(100.0, 100.0, score=0.01))
        if van:
            gts.append(_gt_line(0.0, 60.0, name="Van"))
            dets.append(_det_line(0.0, 60.0, score=0.95))
        _write(root, "%06d.txt" % f, gts, [] if empty else dets)


def _random_tree(root, seed=7):
    """30 frames of Cars, Pedestrians, Cyclists, Vans and DontCare
    regions at random occlusion, truncation and box height, detected
    with jitter (some missed, some spurious) and random scores."""
    rng = np.random.default_rng(seed)
    dims = {"Car": (1.6, 1.8, 4.0), "Van": (2.0, 1.9, 5.0),
            "Pedestrian": (1.75, 0.6, 0.8), "Cyclist": (1.73, 0.6, 1.76)}
    for f in range(30):
        gts, dets = [], []
        for _ in range(int(rng.integers(1, 7))):
            name = str(rng.choice(["Car", "Car", "Pedestrian", "Cyclist",
                                   "Van"]))
            x, z = float(rng.uniform(-20, 20)), float(rng.uniform(5, 60))
            yaw = float(rng.uniform(-np.pi, np.pi))
            h = float(rng.uniform(15, 120))
            gts.append(_gt_line(x, z, yaw, name, occ=int(rng.integers(0, 4)),
                                trunc=float(rng.uniform(0, 0.6)), bbox_h=h,
                                dims=dims[name]))
            if rng.random() < 0.85:
                jit = rng.normal(0, 0.3, 3)
                bbox = (300.0 + jit[0] * 10, 150.0 + jit[1] * 10,
                        400.0 + jit[2] * 10, 150.0 + h)
                dets.append(_det_line(x + jit[0], z + jit[1],
                                      float(rng.uniform(0.05, 1.0)),
                                      yaw + jit[2] * 0.3, name, bbox,
                                      dims[name]))
        for _ in range(int(rng.integers(0, 3))):
            name = str(rng.choice(["Car", "Pedestrian", "Cyclist"]))
            dets.append(_det_line(float(rng.uniform(-20, 20)),
                                  float(rng.uniform(5, 60)),
                                  float(rng.uniform(0.0, 0.6)), name=name,
                                  dims=dims[name]))
        if rng.random() < 0.3:
            gts.append("DontCare -1 -1 -10 500.0 160.0 560.0 200.0 -1 -1 -1 "
                       "-1000 -1000 -1000 -10")
        _write(root, "%06d.txt" % f, gts, dets)


CASES = {
    "perfect": _perfect,
    "shifted": lambda root: _perfect(root, shift=2.5),
    "van_next_to_car": lambda root: _perfect(root, van=True, seed=1),
    "empty_results": lambda root: _perfect(root, empty=True),
    "random_three_classes": _random_tree,
}


def _run(binary, gt_dir, res_dir):
    return subprocess.run([binary, gt_dir, res_dir], capture_output=True,
                          timeout=120)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_evaluator_equals_reference(binaries, tmp_path, monkeypatch,
                                         case):
    port, ref = binaries
    CASES[case](tmp_path)
    gt_dir = str(tmp_path / "gt")
    res = {}
    for tag in ("port", "ref"):
        res[tag] = str(tmp_path / tag)
        shutil.copytree(tmp_path / "res", res[tag])
    out_port = _run(port, gt_dir, res["port"])
    out_ref = _run(ref, gt_dir, res["ref"])
    assert out_port.returncode == out_ref.returncode == 0
    assert out_port.stdout == out_ref.stdout
    assert b"_bev_moderate AP:" in out_port.stdout
    stats = sorted(n for n in os.listdir(res["ref"]) if n.startswith("stats"))
    assert stats and stats == sorted(
        n for n in os.listdir(res["port"]) if n.startswith("stats"))
    for name in stats:
        with open(os.path.join(res["port"], name), "rb") as a, \
                open(os.path.join(res["ref"], name), "rb") as b:
            assert a.read() == b.read(), name
    # the parsed dict: the port's evaluate() against the JAX module's,
    # which runs the reference executable built above
    monkeypatch.setattr(jax_kitti_eval, "binary_path", lambda: ref)
    got = kitti_eval.evaluate(gt_dir, res["port"])
    want = jax_kitti_eval.evaluate(gt_dir, res["ref"])
    assert got == want
    assert "Car_3d_moderate" in got
    if case == "perfect":
        assert got["Car_bev_moderate"]["ap"] > 90
    if case == "shifted":
        assert got["Car_3d_moderate"]["ap"] < 10
    if case == "empty_results":
        assert got["Car_bev_moderate"]["ap"] == 0.0


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        kitti_eval.binary_path(cxx=str(tmp_path / "no-such-c++"),
                               build_dir=tmp_path / "build")
    bad = tmp_path / "bad-c++"
    bad.write_text("#!/bin/sh\n[ \"$1\" = -march=native ] && exit 0\n"
                   "echo broken compiler >&2\nexit 1\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken compiler"):
        kitti_eval.binary_path(cxx=str(bad), build_dir=tmp_path / "build")
    assert not [p for p in (tmp_path / "build").iterdir()
                if p.name.startswith("evaluate_object_offline")
                and ".tmp" not in p.name]


def test_edited_source_is_rebuilt(tmp_path, monkeypatch):
    src = tmp_path / "evaluate_object.cpp"
    src.write_text('#include <cstdio>\nint main() { std::puts("one"); }\n')
    monkeypatch.setattr(kitti_eval, "SOURCE", src)
    build = tmp_path / "build"
    first = kitti_eval.binary_path(build_dir=build)
    assert subprocess.run([first], capture_output=True,
                          text=True).stdout == "one\n"
    assert kitti_eval.binary_path(build_dir=build) == first  # found
    src.write_text('#include <cstdio>\nint main() { std::puts("two"); }\n')
    second = kitti_eval.binary_path(build_dir=build)
    assert second != first
    assert subprocess.run([second], capture_output=True,
                          text=True).stdout == "two\n"
