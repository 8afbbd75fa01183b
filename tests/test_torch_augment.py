"""The port's augmentation, crop-paste augmentation and the box and
voxel helpers they use, against the JAX package.

Frames come from a small synthetic KITTI tree with Car, Pedestrian and
Cyclist objects.  Each method runs in both packages on the same points,
labels and seed: points, attributes and labels must be bitwise equal,
and the generator must be left in the same state (the same draws in the
same order).  Tolerance: none, everything is compared exactly.
"""

import json
import os

import numpy as np
import pytest

from pointgnn_tpu import configs as jax_configs
from pointgnn_tpu.core import boxes as jboxes
from pointgnn_tpu.data import augment as jaug
from pointgnn_tpu.data import crop_aug as jcrop
from pointgnn_tpu.data import kitti as jkitti
from pointgnn_tpu.graph import voxel as jvoxel
from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.core import boxes as tboxes
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.data import augment as taug
from pointgnn_tpu_torch.data import crop_aug as tcrop
from pointgnn_tpu_torch.data import kitti as tkitti
from pointgnn_tpu_torch.graph import voxel as tvoxel
from pointgnn_tpu_torch.utils import synthetic_kitti

CLASSES = ("Car", "Pedestrian", "Cyclist")


def dataset(root, module):
    return module.KittiDataset(
        os.path.join(root, "image/training/image_2"),
        os.path.join(root, "velodyne/training/velodyne"),
        os.path.join(root, "calib/training/calib"),
        os.path.join(root, "labels/training/label_2"),
        os.path.join(root, "3DOP_splits/train.txt"),
    )


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 3-frame tree, each frame one Car, one Pedestrian, one Cyclist."""
    root = str(tmp_path_factory.mktemp("tree"))
    synthetic_kitti.main(root, 3, classes=CLASSES, n_ground=1500)
    ds = dataset(root, tkitti)
    frames = [(ds.get_cam_points_in_image_with_rgb(i), ds.get_label(i))
              for i in range(ds.num_files)]
    return root, frames


def _jpoints(points):
    from pointgnn_tpu.core.points import Points as JPoints

    return JPoints(points.xyz.copy(), None if points.attr is None
                   else points.attr.copy())


def _same(port_out, jax_out, rng_port, rng_jax):
    (tp, tl), (jp, jl) = port_out, jax_out
    assert tp.xyz.dtype == jp.xyz.dtype
    np.testing.assert_array_equal(tp.xyz, jp.xyz)
    if jp.attr is None:
        assert tp.attr is None
    else:
        np.testing.assert_array_equal(tp.attr, jp.attr)
    assert tl == jl
    assert rng_port.bit_generator.state == rng_jax.bit_generator.state


AUG_CASES = [
    ("random_jitter", {}),
    ("random_jitter", {"xyz_std": [0.05, 0.1, 0.2]}),
    ("random_drop", {"drop_prob": 0.3}),
    ("random_drop", {"drop_prob": [0.1, 0.5, 0.9],
                     "tier_prob": [0.2, 0.3, 0.5]}),
    ("random_global_drop", {}),
    ("random_voxel_downsample", {"voxel_std": 0.5}),
    ("random_rotation_all", {}),
    ("random_rotation_all", {"method_name": "uniform", "yaw_std": 0.5}),
    ("random_flip_all", {}),
    ("random_flip_all", {"flip_prob": 1.0}),
    ("random_scale_all", {}),
    ("random_scale_all", {"method_name": "uniform", "scale_std": 0.1}),
    ("random_transition", {}),
    ("random_box_rotation", {}),
    ("random_box_rotation", {"method_name": "uniform", "yaw_std": 1.0,
                             "augment_list": ["Car", "Cyclist"]}),
    ("random_box_global_rotation", {}),
    ("random_box_shift", {}),
    ("random_box_shift", {"method_name": "normal", "xyz_std": [3, 0, 3],
                          "expend_factor": [1.1, 1.1, 1.1],
                          "max_overlap_num_allowed": 100,
                          "max_overlap_rate": 0.01, "appr_factor": 10,
                          "max_trails": 100}),
    ("random_box_shift", {"shuffle": True, "max_overlap_rate": 0.1}),
    ("dilute_background", {}),
    ("dilute_background", {"dilute_voxel_base": 1.0,
                           "keep_list": ["Pedestrian"]}),
    ("remove_background", {}),
    ("remove_background", {"num_object": 2}),
    ("empty", {}),
]


def test_every_method_is_covered():
    assert sorted(taug.AUG_METHOD_MAP) == sorted(jaug.AUG_METHOD_MAP)
    covered = {name for name, _ in AUG_CASES}
    assert set(taug.AUG_METHOD_MAP) <= covered


@pytest.mark.parametrize("frame", [0, 2])
@pytest.mark.parametrize("name,kwargs", AUG_CASES)
def test_augmentation_matches_jax(tree, name, kwargs, frame):
    _, frames = tree
    points, labels = frames[frame]
    fn_t = taug.AUG_METHOD_MAP.get(name, taug.empty)
    fn_j = jaug.AUG_METHOD_MAP.get(name, jaug.empty)
    for seed in (0, 1, 7):
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        before = [dict(lb) for lb in labels]
        out_t = fn_t(points, labels, rng=rt, **kwargs)
        out_j = fn_j(_jpoints(points), [dict(lb) for lb in labels],
                     rng=rj, **kwargs)
        _same(out_t, out_j, rt, rj)
        assert labels == before  # inputs are never mutated


@pytest.mark.parametrize("seed", [0, 3, 11, 12345])
def test_shipped_data_aug_matches_jax(tree, seed):
    """get_data_aug on the shipped data_aug_configs (rotation, flip, box
    shift), over every frame, one generator threaded through them."""
    _, frames = tree
    aug_cfg = configs.get_train_config("car_auto_T3_train")[
        "data_aug_configs"]
    assert aug_cfg == jax_configs.get_train_config("car_auto_T3_train")[
        "data_aug_configs"]
    fn_t, fn_j = taug.get_data_aug(aug_cfg), jaug.get_data_aug(aug_cfg)
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for points, labels in frames:
        _same(fn_t(points, labels, rng=rt),
              fn_j(_jpoints(points), labels, rng=rj), rt, rj)
    assert taug.get_data_aug(()) is taug.empty


def test_box_helpers_match_jax(tree):
    _, frames = tree
    points, labels = frames[1]
    for label in labels:
        box = tboxes.label_to_box(label)
        np.testing.assert_array_equal(box, jboxes.label_to_box(label))
        for expand in ((1.0, 1.0, 1.0), (1.1, 1.2, 1.3)):
            np.testing.assert_array_equal(
                tboxes.box_to_corners(box, expand),
                jboxes.box_to_corners(box, expand))
            bev = tboxes.points_in_box_bev(points.xyz, box, expand)
            np.testing.assert_array_equal(
                bev, jboxes.points_in_box_bev(points.xyz, box, expand))
            # the BEV test ignores the height axis: a superset
            assert bev.sum() >= tboxes.points_in_box(
                points.xyz, box, expand).sum() > 0
        assert tboxes.box_to_label(box) == jboxes.box_to_label(box)


@pytest.mark.parametrize("add_rnd3d", [False, True])
@pytest.mark.parametrize("voxel_size", [0.2, 0.8])
def test_random_voxel_downsample_matches_jax(tree, voxel_size, add_rnd3d):
    _, frames = tree
    points = frames[0][0]
    rt, rj = np.random.default_rng(4), np.random.default_rng(4)
    it = tvoxel.voxel_downsample_random_indices(points.xyz, voxel_size, rt,
                                                add_rnd3d)
    ij = jvoxel.voxel_downsample_random_indices(points.xyz, voxel_size, rj,
                                                add_rnd3d)
    np.testing.assert_array_equal(it, ij)
    assert rt.bit_generator.state == rj.bit_generator.state
    assert 0 < len(it) < points.n
    sub = tvoxel.voxel_downsample_random(points, voxel_size,
                                         np.random.default_rng(4), add_rnd3d)
    np.testing.assert_array_equal(sub.xyz, points.xyz[it])
    np.testing.assert_array_equal(sub.attr, points.attr[it])


def test_points_concat_and_get_label_flag(tree):
    root, frames = tree
    a, b = frames[0][0], frames[1][0]
    both = a.concat(b)
    assert both.n == a.n + b.n
    np.testing.assert_array_equal(both.attr[a.n:], b.attr)
    with pytest.raises(ValueError):
        a.concat(Points(b.xyz))
    ds_t, ds_j = dataset(root, tkitti), dataset(root, jkitti)
    for flag in (False, True):
        assert ds_t.get_label(0, no_orientation=flag) == ds_j.get_label(
            0, no_orientation=flag)


def test_crop_library_round_trip_matches_jax(tree, tmp_path):
    """save_cropped_boxes writes the JAX package's JSON byte for byte;
    load_cropped_boxes reads it back to the same Points and labels."""
    root, _ = tree
    tfile, jfile = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tcrop.save_cropped_boxes(dataset(root, tkitti), tfile)
    jcrop.save_cropped_boxes(dataset(root, jkitti), jfile)
    assert open(tfile, "rb").read() == open(jfile, "rb").read()
    labels, pts = json.load(open(tfile))
    assert sorted(labels) == sorted(CLASSES)
    assert all(len(labels[c]) == 3 for c in CLASSES)
    tl, tp = tcrop.load_cropped_boxes(tfile)
    jl, jp = jcrop.load_cropped_boxes(jfile)
    assert tl == jl and sorted(tp) == sorted(jp)
    for key in tp:
        for a, b in zip(tp[key], jp[key]):
            np.testing.assert_array_equal(a.xyz, b.xyz)
            np.testing.assert_array_equal(a.attr, b.attr)


PARSER_CASES = [
    {},
    {"overlap_mode": "point", "max_overlap_num_allowed": 50},
    {"overlap_mode": "box_and_point", "auto_box_height": True,
     "max_trails": 3},
    {"auto_box_height": True, "must_have_ground": True, "max_trails": 4,
     "method_name": "uniform", "yaw_std": 1.0},
    {"max_overlap_rate": 0.5, "appr_factor": 10, "max_trails": 2},
]


@pytest.mark.parametrize("parser_kwargs", PARSER_CASES)
def test_crop_aug_matches_jax(tree, tmp_path, parser_kwargs):
    root, frames = tree
    lib = str(tmp_path / "lib.json")
    tcrop.save_cropped_boxes(dataset(root, tkitti), lib)
    st, sj = tcrop.CropAugSampler(lib), jcrop.CropAugSampler(lib)
    for seed, (points, labels) in enumerate(frames):
        for rate in (None, {"Car": 2, "Pedestrian": 3, "Cyclist": 1}):
            rt = np.random.default_rng(seed)
            rj = np.random.default_rng(seed)
            out_t = st.crop_aug(points, labels, sample_rate=rate,
                                parser_kwargs=parser_kwargs, rng=rt)
            out_j = sj.crop_aug(_jpoints(points), labels, sample_rate=rate,
                                parser_kwargs=parser_kwargs, rng=rj)
            _same(out_t, out_j, rt, rj)
