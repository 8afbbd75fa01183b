"""The port's native merge-NMS (``csrc/host/nms.cpp``) against the JAX
package's native NMS (bitwise: the same arithmetic in the same order,
over every pair, where the port tests only the pairs its grid finds)
and against the port's own numpy loop (the plain version); the corners
it computes against numpy's; its pair counts against a replay of the
greedy loop."""

import numpy as np
import pytest

from pointgnn_tpu.graph import _native as jax_native
from pointgnn_tpu.postprocess import nms as jax_nms
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.infer import InferencePipeline
from pointgnn_tpu_torch.postprocess import iou, native
from pointgnn_tpu_torch.postprocess import nms

VARIANTS = ("nms_boxes_3d", "nms_boxes_3d_uncertainty",
            "nms_boxes_3d_merge_only", "nms_boxes_3d_score_only")


def _random_boxes(rng, n):
    """Random boxes with forced overlap clusters, as the JAX package's
    native-NMS parity test draws them."""
    boxes = np.stack(
        [
            rng.uniform(-20, 20, n),          # x
            rng.uniform(0.5, 2.5, n),         # y
            rng.uniform(5, 60, n),            # z
            rng.uniform(2.5, 5.0, n),         # l
            rng.uniform(1.2, 2.0, n),         # h
            rng.uniform(1.4, 2.2, n),         # w
            rng.uniform(-np.pi, np.pi, n),    # yaw
        ],
        axis=1,
    )
    boxes[n // 2:, :3] = boxes[: n - n // 2, :3] + rng.normal(
        0, 0.4, (n - n // 2, 3)
    )
    return boxes


def _trials():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(5):
        n = int(rng.integers(30, 120))
        boxes = _random_boxes(rng, n)
        scores = rng.uniform(0.2, 1.0, n)
        classes = rng.integers(1, 3, n).astype(np.int64)
        out.append((classes, boxes, scores, 0.12))
    return out


def _cell_sized_boxes(rng, n, n_clusters, small):
    """``n`` hypotheses as the benchmark's cells give NMS: dense
    clusters over ~90 x 70 m, two classes, KITTI car sizes or, with
    ``small``, pedestrian and cyclist sizes; then a few boxes longer
    than 20 m (the grid's oversize list), pairs whose bounds only touch
    on one axis (still tested), zero-size boxes, some stacked, and a
    stack of boxes that differ in the sign of a zero yaw (the merge's
    median of 0.0 and -0.0)."""
    centers = np.stack([rng.uniform(-45, 45, n_clusters),
                        rng.uniform(1.2, 2.0, n_clusters),
                        rng.uniform(0, 70, n_clusters)], axis=1)
    which = rng.integers(0, n_clusters, n)
    classes = np.where(rng.uniform(size=n_clusters) < 0.5, 1, 3)[which]
    xyz = centers[which] + rng.normal(0, [0.5, 0.1, 0.5], (n, 3))
    lo, hi = (([0.5, 1.5, 0.5], [1.9, 1.9, 0.8]) if small
              else ([3.2, 1.4, 1.5], [4.6, 1.7, 1.8]))
    boxes = np.concatenate([xyz, rng.uniform(lo, hi, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    boxes[:6, 3] = rng.uniform(22, 40, 6)
    # yaw 0 and values exact in binary: a box on [8, 12] in x beside
    # one on [12, 16] (and x 100 times that, quantized), one on top of
    # another in y, one beside another in z
    touch = np.array([[10, 2.0, 30, 4, 1.5, 2, 0], [14, 2.0, 30, 4, 1.5, 2, 0],
                      [10, 0.5, 30, 4, 1.5, 2, 0], [10, 2.0, 32, 4, 1.5, 2, 0],
                      [-20, 1.0, 50, 0.5, 1.75, 0.5, 0],
                      [-19.5, 1.0, 50, 0.5, 1.75, 0.5, 0]])
    boxes[6:12] = touch
    classes[6:12] = 1
    boxes[12:20, 3:6] = 0.0
    boxes[16:20, :3] = boxes[12, :3]
    boxes[20:61] = [-30, 1.5, 60, 4, 1.5, 2, 0]
    boxes[20:61, 6] = np.where(rng.uniform(size=41) < 0.5, -0.0, 0.0)
    return classes.astype(np.int64), boxes, rng.uniform(0.2, 1.0, n)


def _cell_sized_trials():
    """Car-sized boxes at car's threshold, pedestrian-sized at
    ped_cyl's, and a negative threshold (every later box tested)."""
    rng = np.random.default_rng(17)
    return [_cell_sized_boxes(rng, 4096, 150, False) + (0.01,),
            _cell_sized_boxes(rng, 2048, 200, True) + (0.2,),
            _cell_sized_boxes(rng, 2048, 100, False) + (-0.05,)]


def _cheap_cell_sized_trials():
    """The cell-sized trials that the numpy loop runs in under a second:
    few survivors, each tested against every later box."""
    rng = np.random.default_rng(19)
    return [_cell_sized_boxes(rng, 2048, 40, False) + (0.01,),
            _cell_sized_trials()[2]]


def _python_fn(a, b):
    # the same geometry under another identity runs the numpy loop
    return iou.overlapped_boxes_3d(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_native_equals_jax_native_bitwise(variant):
    if jax_native.get_lib() is None:
        pytest.fail("the JAX package's native library is unavailable")
    for classes, boxes, scores, thres in _trials() + _cell_sized_trials():
        kw = dict(overlapped_thres=thres, appr_factor=100.0, top_k=-1)
        ct, bt, st, _ = getattr(nms, variant)(classes, boxes, scores, **kw)
        cj, bj, sj, _ = getattr(jax_nms, variant)(classes, boxes, scores,
                                                 **kw)
        assert len(ct) < len(classes)
        np.testing.assert_array_equal(ct, cj)
        assert bt.tobytes() == bj.tobytes()
        assert st.tobytes() == sj.tobytes()


@pytest.mark.parametrize("variant", VARIANTS)
def test_native_matches_python_loop(variant):
    """Tolerances of the JAX package's test: the rescoring sum runs in
    another order in numpy (pairwise) than in C++ (sequential)."""
    for classes, boxes, scores, thres in (_trials()
                                          + _cheap_cell_sized_trials()):
        kw = dict(overlapped_thres=thres, appr_factor=100.0, top_k=-1)
        fn = getattr(nms, variant)
        cn, bn, sn, _ = fn(classes, boxes, scores, **kw)
        cp, bp, sp, _ = fn(classes, boxes, scores, overlapped_fn=_python_fn,
                           **kw)
        np.testing.assert_array_equal(cn, cp)
        np.testing.assert_allclose(bn, bp, atol=1e-12)
        np.testing.assert_allclose(sn, sp, rtol=1e-7, atol=1e-9)


def test_empty_input():
    for variant in VARIANTS:
        cls, boxes, scores, attr = getattr(nms, variant)(
            np.zeros(0, np.int64), np.zeros((0, 7)), np.zeros(0),
            attributes=np.zeros((0, 2)),
        )
        assert len(cls) == 0 and boxes.shape == (0, 7) and len(scores) == 0
        assert attr.shape == (0, 2)
    for corners in (np.zeros((0, 8, 3)), None):
        keep, scores, boxes, counts = native.greedy_nms(
            np.zeros((0, 7)), corners, np.zeros(0, np.int64),
            np.zeros(0), 0.1, True, True)
        assert keep.shape == (0,) and scores.shape == (0,)
        assert counts == dict(pairs=0, candidates=0, clipped=0, boxes=0)


def _edge_boxes():
    """Boxes at yaw 0 (both signs), +-pi, +-pi/2, 2 pi and large |yaw|,
    of zero, negative, tiny and huge sizes, at centers with signed
    zeros."""
    sizes = [(0.0, 0.0, 0.0), (-0.0, -0.0, -0.0), (-1.0, -2.0, -3.0),
             (4.0, 1.5, 2.0), (1e-300, 1e-300, 1e-300), (1e300, 1e300, 1e300)]
    yaws = [0.0, -0.0, np.pi, -np.pi, np.pi / 2, -np.pi / 2, 2 * np.pi,
            123.456, 1e6, -1e6, 1e15]
    centers = [(1.5, -0.0, 0.0), (0.0, 0.0, -0.0), (-30.25, 1.75, 60.5)]
    return np.array([[*c, *size, yaw] for c in centers for size in sizes
                     for yaw in yaws])


CORNER_CASES = {
    "trials": lambda: np.concatenate([t[1] for t in _trials()]),
    "cell_sized": lambda: np.concatenate(
        [t[1] for t in _cell_sized_trials()]),
    "edge": _edge_boxes,
}


@pytest.mark.parametrize("case", sorted(CORNER_CASES))
def test_native_corners_equal_numpy_bitwise(case):
    """The corners the native loop computes equal
    ``core.boxes.boxes_to_corners`` byte for byte."""
    boxes = CORNER_CASES[case]()
    want = box_ops.boxes_to_corners(boxes)
    got = native.box_corners(boxes)
    assert got.shape == want.shape == (len(boxes), 8, 3)
    assert got.tobytes() == want.tobytes()


def _no_numpy_corners(*args, **kwargs):
    raise AssertionError("boxes_to_corners called")


@pytest.mark.parametrize("variant", VARIANTS[1:])
def test_default_overlap_computes_no_numpy_corners(variant, monkeypatch):
    """With the default overlap the unquantized variants hand the native
    loop no corners: it computes them, and counts every box in
    ``boxes``."""
    classes, boxes, scores, thres = _cell_sized_trials()[0]
    kw = dict(overlapped_thres=thres, appr_factor=100.0, top_k=-1)
    want = getattr(nms, variant)(classes, boxes, scores, **kw)
    monkeypatch.setattr(box_ops, "boxes_to_corners", _no_numpy_corners)
    counts = {}
    got = getattr(nms, variant)(classes, boxes, scores, counters=counts,
                                **kw)
    for a, b in zip(got[:3], want[:3]):
        assert a.tobytes() == b.tobytes()
    assert counts["boxes"] == len(scores)


@pytest.mark.parametrize("variant", VARIANTS)
def test_numpy_loop_and_quantized_variant_compute_numpy_corners(
        variant, monkeypatch):
    """The numpy loop (another ``overlapped_fn``) and the quantized
    variant still take their corners from ``boxes_to_corners``; the
    quantized variant's native loop then computes none."""
    classes, boxes, scores, thres = _trials()[0]
    calls = []
    inner = box_ops.boxes_to_corners

    def counted(*args, **kwargs):
        calls.append(len(args[0]))
        return inner(*args, **kwargs)

    monkeypatch.setattr(box_ops, "boxes_to_corners", counted)
    kw = dict(overlapped_thres=thres, appr_factor=100.0, top_k=-1)
    fn = getattr(nms, variant)
    fn(classes, boxes, scores, overlapped_fn=_python_fn, **kw)
    assert calls and calls[0] == len(scores)
    calls.clear()
    counts = {}
    fn(classes, boxes, scores, counters=counts, **kw)
    if variant == "nms_boxes_3d":
        assert calls == [len(scores)] and counts["boxes"] == 0
    else:
        assert calls == [] and counts["boxes"] == len(scores)


@pytest.mark.parametrize("trial", range(3))
def test_native_corners_give_the_loop_of_numpy_corners(trial):
    """The loop given no corners equals the loop given numpy's, bitwise,
    with the same pair counts; ``boxes`` reads the input size, and 0
    where the corners were given."""
    classes, boxes, scores, thres = _cell_sized_trials()[trial]
    boxes, corners, classes, scores = _sorted_native_input(
        classes, boxes, scores)
    given = native.greedy_nms(boxes, corners, classes, scores, thres,
                              True, True)
    own = native.greedy_nms(boxes, None, classes, scores, thres, True,
                            True)
    for a, b in zip(own[:3], given[:3]):
        assert a.tobytes() == b.tobytes()
    assert own[3] == dict(given[3], boxes=len(scores))
    assert given[3]["boxes"] == 0


def _sorted_native_input(classes, boxes, scores):
    order = np.argsort(-scores)
    boxes = boxes[order]
    return boxes, nms.boxes_3d_to_corners(boxes), classes[order], \
        scores[order]


def _replay(classes, corners, threshold):
    """The greedy loop in numpy: its keep flags, the kept same-class
    later boxes of each survivor (``pairs``) and those whose bounds
    meet the survivor's (``clipped``)."""
    n = len(classes)
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    keep = np.ones(n, bool)
    pairs = clipped = 0
    for i in range(n - 1):
        if not keep[i]:
            continue
        rest = i + 1 + np.flatnonzero(keep[i + 1:]
                                      & (classes[i + 1:] == classes[i]))
        pairs += len(rest)
        clipped += int(np.all((hi[i] >= lo[rest]) & (lo[i] <= hi[rest]),
                              axis=1).sum())
        if len(rest):
            overlap = iou.overlapped_boxes_3d(corners[i], corners[rest])
            keep[rest[overlap > threshold]] = False
    return keep, pairs, clipped


@pytest.mark.parametrize("trial", range(3))
def test_counts_bound_each_other(trial):
    """``clipped <= candidates <= pairs`` on the cell-sized trials; the
    grid hands on a few percent of the pairs, a negative threshold all
    of them."""
    classes, boxes, scores, thres = _cell_sized_trials()[trial]
    keep, _, _, counts = native.greedy_nms(
        *_sorted_native_input(classes, boxes, scores)[:3], scores, thres,
        True, True)
    assert 0 < counts["clipped"] <= counts["candidates"] <= counts["pairs"]
    if thres < 0:
        assert counts["candidates"] == counts["pairs"]
    else:
        assert counts["candidates"] < 0.1 * counts["pairs"]


@pytest.mark.parametrize("trial", range(3))
def test_grid_finds_every_pair_whose_bounds_meet(trial):
    """At a threshold no overlap exceeds, every box survives and is
    tested against every later box of its class: ``clipped`` equals the
    same-class pairs whose bounds meet, counted over all pairs."""
    classes, boxes, scores, _ = _cell_sized_trials()[trial]
    boxes, corners, classes, scores = _sorted_native_input(
        classes, boxes, scores)
    keep, _, _, counts = native.greedy_nms(
        boxes, corners, classes, scores, 1.5, False, False)
    assert keep.all()
    lo, hi = corners.min(axis=1), corners.max(axis=1)
    pairs = clipped = 0
    for i in range(len(classes) - 1):
        rest = i + 1 + np.flatnonzero(classes[i + 1:] == classes[i])
        pairs += len(rest)
        clipped += int(np.all((hi[i] >= lo[rest]) & (lo[i] <= hi[rest]),
                              axis=1).sum())
    assert counts["pairs"] == pairs
    assert counts["clipped"] == clipped
    assert clipped < counts["candidates"] < 0.1 * pairs


def test_counts_equal_a_replay_of_the_loop():
    """``pairs`` and ``clipped`` equal a numpy replay of the keep order,
    on a cell-sized case small enough for it (touching and zero-size
    boxes included), at a positive and a negative threshold."""
    rng = np.random.default_rng(23)
    classes, boxes, scores = _cell_sized_boxes(rng, 400, 30, False)
    boxes, corners, classes, scores = _sorted_native_input(
        classes, boxes, scores)
    for thres in (0.01, -0.05):
        keep, _, _, counts = native.greedy_nms(
            boxes, corners, classes, scores, thres, False, False)
        want_keep, pairs, clipped = _replay(classes, corners, thres)
        np.testing.assert_array_equal(keep, want_keep)
        assert counts["pairs"] == pairs
        assert counts["clipped"] == clipped
        assert clipped <= counts["candidates"] <= pairs


def test_pipeline_adds_the_nms_counts():
    """``InferencePipeline._nms`` adds the native loop's counts of each
    call to ``nms_counters``."""
    pipe = InferencePipeline(configs.model_config("Car", T=1), device="cpu")
    classes, boxes, scores, _ = _cheap_cell_sized_trials()[0]
    hyp_cls = np.where(classes == 1, 1, 2)  # car's two headings, folded
    want = {}
    nms.get_nms_fn(pipe.use_box_merge, pipe.use_box_score)(
        np.ones_like(classes), boxes, scores, appr_factor=100.0,
        overlapped_thres=pipe.config["nms_overlapped_thres"],
        counters=want)
    assert want["pairs"] > 0 and want["boxes"] == len(scores)
    for calls in (1, 2):
        pipe._nms(hyp_cls, scores, boxes, boxes[:, :3])
        assert pipe.nms_counters == {k: calls * v for k, v in want.items()}


def test_attributes_follow_the_kept_boxes():
    classes, boxes, scores, _ = _trials()[0]
    attributes = np.arange(len(scores) * 2).reshape(-1, 2)
    kw = dict(overlapped_thres=0.12, top_k=-1)
    cls, _, _, attr = nms.nms_boxes_3d_uncertainty(
        classes, boxes, scores, attributes=attributes, **kw)
    cj, _, _, attr_j = jax_nms.nms_boxes_3d_uncertainty(
        classes, boxes, scores, attributes=attributes, **kw)
    np.testing.assert_array_equal(attr, attr_j)
    assert len(attr) == len(cls) < len(classes)
    # each kept row is the row of one input box, in decreasing score order
    order = np.argsort(-scores)
    rows = [int(np.flatnonzero(order == a[0] // 2)[0]) for a in attr]
    assert rows == sorted(rows)
    # top_k caps the sorted candidates, attributes included
    c5, _, _, a5 = nms.nms_boxes_3d(classes, boxes, scores, top_k=5,
                                    attributes=attributes)
    assert len(c5) <= 5
    assert set(a5[:, 0] // 2) <= set(order[:5])


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build_library(cxx=str(tmp_path / "no-such-c++"),
                             build_dir=tmp_path / "build")
    bad = tmp_path / "bad-c++"
    bad.write_text("#!/bin/sh\necho broken compiler >&2\nexit 1\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken compiler"):
        native.build_library(cxx=str(bad), build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))
