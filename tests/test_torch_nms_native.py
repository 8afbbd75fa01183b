"""The port's native merge-NMS (``csrc/host/nms.cpp``) against the JAX
package's native NMS (bitwise: the same C++ in the same order) and
against the port's own numpy loop (the plain version)."""

import numpy as np
import pytest

from pointgnn_tpu.graph import _native as jax_native
from pointgnn_tpu.postprocess import nms as jax_nms
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
        out.append((classes, boxes, scores))
    return out


def _python_fn(a, b):
    # the same geometry under another identity runs the numpy loop
    return iou.overlapped_boxes_3d(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_native_equals_jax_native_bitwise(variant):
    if jax_native.get_lib() is None:
        pytest.fail("the JAX package's native library is unavailable")
    for classes, boxes, scores in _trials():
        kw = dict(overlapped_thres=0.12, appr_factor=100.0, top_k=-1)
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
    for classes, boxes, scores in _trials():
        kw = dict(overlapped_thres=0.12, appr_factor=100.0, top_k=-1)
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
    keep, scores, boxes = native.greedy_nms(
        np.zeros((0, 7)), np.zeros((0, 8, 3)), np.zeros(0, np.int64),
        np.zeros(0), 0.1, True, True)
    assert keep.shape == (0,) and scores.shape == (0,)


def test_attributes_follow_the_kept_boxes():
    classes, boxes, scores = _trials()[0]
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
