"""The rest of the port's ``KittiDataset`` (raw calibration, transforms,
voxel downsampling, box selection, statistics, ``__str__``) and
``format_label_line``, ``device_builder.pad_points`` and the rasterized
IoU, each against the JAX package on the same inputs: bitwise (text,
masks, the same float operations), the rasterized IoU and the NMS over
it with OpenCV blocked, which sends the JAX package down its scanline
``_fill_convex_quad`` route."""

import os
import sys
import warnings

import numpy as np
import pytest

from pointgnn_tpu.core.points import Points as JPoints
from pointgnn_tpu.data import kitti as jkitti
from pointgnn_tpu.graph import device_builder as jdb
from pointgnn_tpu.postprocess import iou as jiou
from pointgnn_tpu.postprocess import nms as jnms
from pointgnn_tpu_torch.core import boxes as tboxes
from pointgnn_tpu_torch.data import kitti as tkitti
from pointgnn_tpu_torch.graph import device_builder as tdb
from pointgnn_tpu_torch.postprocess import iou as tiou
from pointgnn_tpu_torch.postprocess import nms as tnms
from pointgnn_tpu_torch.utils import synthetic_kitti

from test_kitti_dataset import RAW_VELO_CALIB, _raw_cam_calib


def _datasets(root):
    dirs = (os.path.join(root, "image/training/image_2"),
            os.path.join(root, "velodyne/training/velodyne"),
            os.path.join(root, "calib/training/calib"),
            os.path.join(root, "labels/training/label_2"),
            os.path.join(root, "3DOP_splits/val.txt"))
    return (jkitti.KittiDataset(*dirs, num_classes=4),
            tkitti.KittiDataset(*dirs, num_classes=4))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_rest"))
    synthetic_kitti.main(root, 3, classes=("Car", "Pedestrian", "Cyclist"),
                         n_ground=400)
    return root


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_format_label_line_and_str(tree):
    jds, tds = _datasets(tree)
    assert str(tds) == str(jds)
    n = 0
    for i in range(tds.num_files):
        for label in tds.get_label(i):
            line = tkitti.format_label_line(label)
            assert line == jkitti.format_label_line(label)
            scored = dict(label, score=0.123456789)
            assert (tkitti.format_label_line(scored)
                    == jkitti.format_label_line(scored))
            assert tkitti.parse_label_line(line)["name"] == label["name"]
            n += 1
    assert n > 3


def test_raw_calib_bitwise(tmp_path):
    velo, cam = tmp_path / "velo.txt", tmp_path / "cam.txt"
    velo.write_text(RAW_VELO_CALIB)
    cam.write_text(_raw_cam_calib())
    want = jkitti.KittiDataset.get_raw_calib(str(velo), str(cam))
    got = tkitti.KittiDataset.get_raw_calib(str(velo), str(cam))
    assert want.keys() == got.keys()
    for key in want:
        _same(got[key], want[key])


def test_transforms_bitwise(tree):
    jds, tds = _datasets(tree)
    calib = tds.get_calib(1)
    velo = tds.get_velo_points(1)
    jvelo = JPoints(xyz=velo.xyz, attr=velo.attr)
    _same(tds.velo_to_cam(velo.xyz, calib), jds.velo_to_cam(velo.xyz, calib))
    cam = tds.velo_points_to_cam(velo, calib)
    _same(tds.cam_to_velo(cam.xyz, calib), jds.cam_to_velo(cam.xyz, calib))
    back, jback = (ds.cam_points_to_velo(p, calib) for ds, p in (
        (tds, cam), (jds, JPoints(xyz=cam.xyz, attr=cam.attr))))
    _same(back.xyz, jback.xyz)
    _same(back.attr, jback.attr)
    img, jimg = (tds.velo_points_to_image(velo, calib),
                 jds.velo_points_to_image(jvelo, calib))
    _same(img.xyz, jimg.xyz)
    np.testing.assert_allclose(back.xyz, velo.xyz, atol=1e-3)


def test_downsample_and_box_selection_bitwise(tree, monkeypatch):
    jds, tds = _datasets(tree)
    pts = tds.get_cam_points(0)
    jpts = JPoints(xyz=pts.xyz, attr=pts.attr)
    for size in (0.4, 1.3):
        got = tds.downsample_by_voxel(pts, size)
        want = jds.downsample_by_voxel(jpts, size)
        _same(got.xyz, want.xyz)
        _same(got.attr, want.attr)
    # RANDOM draws from an unseeded default_rng in both packages: give
    # each call the same seeded generator
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a: np.random.Generator(np.random.PCG64(7)))
    got = tds.downsample_by_voxel(pts, 0.8, method="RANDOM")
    want = jds.downsample_by_voxel(jpts, 0.8, method="RANDOM")
    _same(got.xyz, want.xyz)
    assert 0 < got.n < pts.n
    for ds in (tds, jds):
        with pytest.raises(ValueError, match="unknown downsample"):
            ds.downsample_by_voxel(pts, 0.8, method="MEDIAN")
    labels = tds.get_label(0)
    assert labels
    for label in labels:
        for expand in ((1.0, 1.0, 1.0), (1.2, 1.1, 1.3)):
            _same(tds.box3d_to_cam_points(label, expand).xyz,
                  jds.box3d_to_cam_points(label, expand).xyz)
            m3 = tds.sel_xyz_in_box3d(label, pts.xyz, expand)
            _same(m3, jds.sel_xyz_in_box3d(label, pts.xyz, expand))
            m2 = tds.sel_xyz_in_box2d(label, pts.xyz, expand)
            _same(m2, jds.sel_xyz_in_box2d(label, pts.xyz, expand))
            assert (m2 | ~m3).all()  # inside 3D implies inside BEV


def test_get_statistics_equal(tree):
    jds, tds = _datasets(tree)
    got, want = tds.get_statistics(), jds.get_statistics()
    assert set(got) == set(want) and len(got) >= 2
    for name in want:
        assert got[name] == dict(want[name])


def test_pad_points_bitwise_with_the_warning():
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 5, (300, 3)).astype(np.float32)
    attr = rng.uniform(0, 1, (300, 4)).astype(np.float32)
    for cap in (512, 300, 200):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = tdb.pad_points(xyz, attr, cap)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jdb.pad_points(xyz, attr, cap)
        for a, b in zip(got, want):
            _same(a, b)
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        assert [w.category for w in tw] == [w.category for w in jw]
        assert len(tw) == (1 if cap < 300 else 0)
    # the packed payload warns with the same text
    with pytest.warns(RuntimeWarning, match="far-field detections"):
        tdb.pack_points(xyz, attr, 100)


def _boxes(rng, n, spread=3.0):
    return np.stack([
        rng.uniform(-spread, spread, n), rng.uniform(1.0, 2.0, n),
        rng.uniform(10, 10 + spread, n), rng.uniform(3.2, 4.6, n),
        rng.uniform(1.3, 1.8, n), rng.uniform(1.4, 1.9, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1)


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.mark.parametrize("appr_factor, n", [(10.0, 24), (100.0, 8)])
def test_rasterized_iou_bitwise(no_cv2, appr_factor, n):
    rng = np.random.default_rng(int(appr_factor))
    boxes = _boxes(rng, n, spread=3.0 if n > 10 else 1.5)
    corners = np.int32(tboxes.boxes_to_corners(boxes) * appr_factor).astype(
        np.float64)
    hits = 0
    for i in range(len(corners)):
        got = tiou.overlapped_boxes_3d_rasterized(corners[i], corners)
        want = jiou.overlapped_boxes_3d_rasterized(corners[i], corners)
        _same(got, want)
        hits += int((got > 0).sum())
        exact = tiou.overlapped_boxes_3d(corners[i], corners)
        # an approximation of the exact overlap, coarser at 10 px a metre
        np.testing.assert_allclose(got, exact,
                                   atol=0.5 if appr_factor < 50 else 0.1)
    assert hits > len(corners)
    _same(tiou.overlapped_boxes_3d_rasterized(corners[0], corners[:0]),
          jiou.overlapped_boxes_3d_rasterized(corners[0], corners[:0]))
    assert tiou.overlapped_boxes_3d_fast_poly is tiou.overlapped_boxes_3d
    poly = corners[:, :4][:, :, [0, 2]]
    for a, b in zip(poly[:-1], poly[1:]):
        assert (tiou.rect_intersection_area(a, b)
                == jiou.rect_intersection_area(a, b))


def test_fill_convex_quad_bitwise():
    rng = np.random.default_rng(5)
    for _ in range(20):
        quad = np.int32(tboxes.boxes_to_corners(
            _boxes(rng, 1, 0.5))[0, :4][:, [0, 2]] * 8.0 - [-30, 60])
        got, want = (np.zeros((70, 70), np.int32) for _ in range(2))
        tiou._fill_convex_quad(got, quad)
        jiou._fill_convex_quad(want, quad)
        _same(got, want)
        assert got.sum() > 0


@pytest.mark.parametrize("variant", ["nms_boxes_3d", "nms_boxes_3d_uncertainty",
                                     "nms_boxes_3d_merge_only",
                                     "nms_boxes_3d_score_only"])
def test_nms_over_rasterized_iou_bitwise(no_cv2, variant):
    rng = np.random.default_rng(11)
    boxes = _boxes(rng, 30, spread=2.0)
    classes = rng.integers(1, 3, 30)
    scores = rng.uniform(0.2, 1.0, 30)
    kw = dict(overlapped_thres=0.1, appr_factor=20.0, top_k=-1)
    got = getattr(tnms, variant)(
        classes, boxes, scores,
        overlapped_fn=tiou.overlapped_boxes_3d_rasterized, **kw)
    want = getattr(jnms, variant)(
        classes, boxes, scores,
        overlapped_fn=jiou.overlapped_boxes_3d_rasterized, **kw)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert 0 < len(got[0]) < 30
