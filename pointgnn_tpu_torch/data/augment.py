"""Point-cloud and label augmentation (copy of
:mod:`pointgnn_tpu.data.augment`).

All 13 registered methods of the reference with the same names, kwargs
and semantics, each drawing from the ``numpy.random.Generator`` it is
given, in the JAX package's order, so one seed gives the same points and
labels bit for bit in both packages.  The three collision-checked box
augmentations share one per-box trial loop.  Inputs are never mutated;
each method returns new ``(Points, labels)``.

:func:`get_data_aug` composes the methods of a ``data_aug_configs``
block (a train_config entry) into one ``fn(points, labels, rng)``.
"""

import copy
from typing import Dict, List, Sequence

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.graph import voxel
from pointgnn_tpu_torch.postprocess import iou as iou_lib
from pointgnn_tpu_torch.postprocess.nms import boxes_3d_to_corners

DEFAULT_AUGMENT_LIST = (
    "Car", "Pedestrian", "Cyclist", "Van", "Truck", "Misc", "Tram",
    "Person_sitting",
)
DEFAULT_KEEP_LIST = (
    "Car", "Pedestrian", "Cyclist", "Van", "Truck", "Misc",
    "Person_sitting",
)


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def _yaw_matrix(delta_yaw: float) -> np.ndarray:
    return box_ops.yaw_rotation(np.asarray(delta_yaw))


def _rand_delta(rng, method_name: str, std):
    std = np.asarray(std, dtype=np.float64)
    if method_name == "normal":
        return rng.normal(scale=std) if std.ndim else rng.normal(scale=float(std))
    if method_name == "uniform":
        return rng.uniform(low=-std, high=std)
    raise ValueError("unknown method_name %s" % method_name)


def _in_box(label, xyz, expend_factor):
    return box_ops.points_in_box(
        xyz, box_ops.label_to_box(label), expend_factor
    )


def _split_dontcare(labels):
    keep = [l for l in labels if l["name"] != "DontCare"]
    dontcare = [l for l in labels if l["name"] == "DontCare"]
    return keep, dontcare


# ---------------------------------------------------------------------------
# global (whole-frame) methods
# ---------------------------------------------------------------------------

def random_jitter(points, labels, xyz_std=(0.1, 0.1, 0.1), rng=None):
    """Per-point gaussian jitter."""
    rng = _rng(rng)
    delta = rng.normal(scale=xyz_std, size=points.xyz.shape)
    return Points(points.xyz + delta, points.attr), labels


def random_drop(points, labels, drop_prob=0.5, tier_prob=None, rng=None):
    """Drop each point with prob p; p may be sampled from a tier list."""
    rng = _rng(rng)
    if isinstance(drop_prob, (list, tuple)):
        drop_prob = rng.choice(drop_prob, p=tier_prob)
    mask = rng.uniform(size=points.n) > drop_prob
    if not mask.any():
        mask = np.ones_like(mask)
    return points.mask(mask), labels


def random_global_drop(points, labels, drop_std=0.25, rng=None):
    """Frame-level drop rate ~ |N(0, std)|."""
    rng = _rng(rng)
    return random_drop(points, labels, abs(rng.normal(scale=drop_std)), rng=rng)


def random_voxel_downsample(
    points, labels, voxel_std=0.2, min_voxel=0.02, max_voxel=0.8, rng=None
):
    """Random-voxel downsample with random cell size."""
    rng = _rng(rng)
    voxel_size = min(abs(rng.normal(scale=voxel_std)), max_voxel)
    if voxel_size < min_voxel:
        return points, labels
    return (
        voxel.voxel_downsample_random(points, voxel_size, rng, add_rnd3d=True),
        labels,
    )


def random_rotation_all(
    points, labels, method_name="normal", yaw_std=0.3,
    expend_factor=(1.0, 1.1, 1.1), rng=None,
):
    """Rotate the whole frame around the camera y axis; box centers
    rotate and yaws shift."""
    rng = _rng(rng)
    delta_yaw = float(_rand_delta(rng, method_name, yaw_std))
    R = _yaw_matrix(delta_yaw)
    new_labels = []
    for label in labels:
        label = copy.deepcopy(label)
        if label["name"] != "DontCare":
            center = np.array([label["x3d"], label["y3d"], label["z3d"]])
            label["x3d"], label["y3d"], label["z3d"] = center @ R.T
            label["yaw"] = label["yaw"] + delta_yaw
        new_labels.append(label)
    return Points(points.xyz @ R.T, points.attr), new_labels


def random_flip_all(points, labels, flip_prob=0.5, rng=None):
    """Mirror across the x=0 plane with probability flip_prob."""
    rng = _rng(rng)
    if rng.uniform() >= flip_prob:
        return points, labels
    xyz = points.xyz.copy()
    xyz[:, 0] = -xyz[:, 0]
    new_labels = []
    for label in labels:
        label = copy.deepcopy(label)
        if label["name"] != "DontCare":
            label["x3d"] = -label["x3d"]
            label["yaw"] = np.pi - label["yaw"]
        new_labels.append(label)
    return Points(xyz, points.attr), new_labels


def random_scale_all(
    points, labels, method_name="normal", scale_std=0.05, rng=None
):
    """Uniform scale of coordinates and box sizes."""
    rng = _rng(rng)
    scale = 1.0 + float(_rand_delta(rng, method_name, scale_std))
    new_labels = []
    for label in labels:
        label = copy.deepcopy(label)
        if label["name"] != "DontCare":
            for k in ("x3d", "y3d", "z3d", "length", "width", "height"):
                label[k] *= scale
        new_labels.append(label)
    return Points(points.xyz * scale, points.attr), new_labels


def random_transition(points, labels, xyz_std=(0.1, 0.1, 0.1), rng=None):
    """One global translation applied to points and boxes."""
    rng = _rng(rng)
    delta = rng.normal(scale=np.asarray(xyz_std, dtype=np.float64))
    new_labels = []
    for label in labels:
        label = copy.deepcopy(label)
        label["x3d"] += delta[0]
        label["y3d"] += delta[1]
        label["z3d"] += delta[2]
        new_labels.append(label)
    return Points(points.xyz + delta, points.attr), new_labels


# ---------------------------------------------------------------------------
# per-box collision-checked methods (shared trial loop)
# ---------------------------------------------------------------------------

def _per_box_trials(points, labels, augment_list, max_trails, try_one):
    """Run ``try_one(label, xyz, attr, placed)`` up to max_trails times per
    augmentable box; keep the original label on failure.  ``try_one``
    returns ``None`` to reject or ``(new_label, xyz, attr)`` to accept.
    DontCare labels pass through untouched and come last, as in the
    reference."""
    xyz = points.xyz.copy()
    attr = points.attr
    keep, dontcare = _split_dontcare(labels)
    new_labels: List[Dict] = []
    for label in keep:
        if label["name"] not in augment_list:
            new_labels.append(label)
            continue
        for _ in range(max_trails):
            result = try_one(label, xyz, attr, new_labels)
            if result is not None:
                new_label, xyz, attr = result
                new_labels.append(new_label)
                break
        else:
            new_labels.append(label)
    assert len(new_labels) == len(keep)
    new_labels.extend(dontcare)
    assert len(new_labels) == len(labels)
    return Points(xyz=xyz, attr=attr), new_labels


def random_box_rotation(
    points, labels, max_overlap_num_allowed=0.1, max_trails=100,
    appr_factor=100, method_name="normal", yaw_std=0.3,
    expend_factor=(1.0, 1.1, 1.1), augment_list=DEFAULT_AUGMENT_LIST,
    rng=None,
):
    """Rotate each object's points around its own center; reject when the
    rotated (expanded) box would capture >= max_overlap_num_allowed new
    points."""
    rng = _rng(rng)

    def try_one(label, xyz, attr, placed):
        delta_yaw = float(_rand_delta(rng, method_name, yaw_std))
        new_label = copy.deepcopy(label)
        new_label["yaw"] += delta_yaw
        mask = _in_box(label, xyz, expend_factor)
        more = _in_box(new_label, xyz[~mask], expend_factor)
        if more.sum() >= max_overlap_num_allowed:
            return None
        center = np.array([label["x3d"], label["y3d"], label["z3d"]])
        R = _yaw_matrix(delta_yaw)
        xyz = xyz.copy()
        xyz[mask] = (xyz[mask] - center) @ R.T + center
        return new_label, xyz, attr

    return _per_box_trials(points, labels, augment_list, max_trails, try_one)


def random_box_global_rotation(
    points, labels, max_overlap_num_allowed=0.1, max_trails=100,
    appr_factor=100, method_name="normal", yaw_std=0.3,
    expend_factor=(1.1, 1.1, 1.1), augment_list=DEFAULT_AUGMENT_LIST,
    rng=None,
):
    """Rotate each object (points + box center) around the camera origin;
    points newly swallowed by the moved box are deleted."""
    rng = _rng(rng)

    def try_one(label, xyz, attr, placed):
        delta_yaw = float(_rand_delta(rng, method_name, yaw_std))
        R = _yaw_matrix(delta_yaw)
        new_label = copy.deepcopy(label)
        new_label["yaw"] += delta_yaw
        center = np.array([label["x3d"], label["y3d"], label["z3d"]])
        new_label["x3d"], new_label["y3d"], new_label["z3d"] = center @ R.T
        mask = _in_box(label, xyz, expend_factor)
        new_mask = _in_box(new_label, xyz, expend_factor)
        more = new_mask & ~mask
        if more.sum() >= max_overlap_num_allowed:
            return None
        xyz = xyz.copy()
        xyz[mask] = xyz[mask] @ R.T
        keep = ~more
        return new_label, xyz[keep], (attr[keep] if attr is not None else None)

    return _per_box_trials(points, labels, augment_list, max_trails, try_one)


def random_box_shift(
    points, labels, max_overlap_num_allowed=0.1, max_overlap_rate=None,
    max_trails=100, appr_factor=100, method_name="normal", xyz_std=(1, 0, 1),
    expend_factor=(1.0, 1.1, 1.1), augment_list=DEFAULT_AUGMENT_LIST,
    shuffle=False, rng=None,
):
    """Translate each object; reject on point capture or (optionally) on
    BEV overlap with already-placed boxes."""
    rng = _rng(rng)
    if shuffle:
        keep, dontcare = _split_dontcare(labels)
        keep = list(keep)
        rng.shuffle(keep)
        labels = keep + dontcare

    def try_one(label, xyz, attr, placed):
        delta = np.asarray(
            _rand_delta(rng, method_name, np.asarray(xyz_std, np.float64))
        )
        new_label = copy.deepcopy(label)
        new_label["x3d"] += delta[0]
        new_label["y3d"] += delta[1]
        new_label["z3d"] += delta[2]
        mask = _in_box(label, xyz, expend_factor)
        more = _in_box(new_label, xyz[~mask], expend_factor)
        if more.sum() >= max_overlap_num_allowed:
            return None
        if max_overlap_rate is not None and placed:
            new_corners = np.int32(
                appr_factor
                * boxes_3d_to_corners(box_ops.label_to_box(new_label)[None])
            )
            placed_corners = np.int32(
                appr_factor
                * boxes_3d_to_corners(
                    np.stack([box_ops.label_to_box(l) for l in placed])
                )
            )
            overlap = iou_lib.overlapped_boxes_3d(
                new_corners[0].astype(np.float64),
                placed_corners.astype(np.float64),
            )
            if not np.all(overlap < max_overlap_rate):
                return None
        xyz = xyz.copy()
        xyz[mask] = xyz[mask] + delta
        return new_label, xyz, attr

    return _per_box_trials(points, labels, augment_list, max_trails, try_one)


# ---------------------------------------------------------------------------
# background manipulation
# ---------------------------------------------------------------------------

def _foreground_mask(labels, xyz, expend_factor, keep_list):
    keep = [l for l in labels if l["name"] in keep_list]
    if not keep:
        keep = [l for l in labels if l["name"] != "DontCare"]
    mask = np.zeros(xyz.shape[0], dtype=bool)
    for label in keep:
        mask |= _in_box(label, xyz, expend_factor)
    if not mask.any():
        mask[0] = True
    return mask, keep


def dilute_background(
    points, labels, dilute_voxel_base=0.4, expend_factor=(4.0, 4.0, 4.0),
    keep_list=DEFAULT_KEEP_LIST, rng=None,
):
    """Voxel-downsample everything outside (expanded) object boxes;
    returns only the kept labels."""
    rng = _rng(rng)
    mask, kept_labels = _foreground_mask(
        labels, points.xyz, expend_factor, keep_list
    )
    background = points.mask(~mask)
    diluted = voxel.voxel_downsample_random(
        background, dilute_voxel_base, rng, add_rnd3d=True
    )
    return points.mask(mask).concat(diluted), kept_labels


def remove_background(
    points, labels, expend_factor=(4.0, 4.0, 4.0),
    keep_list=DEFAULT_KEEP_LIST, num_object=-1,
    mask_random_rotation_std=0, mask_random_jitter_stds=(0.0,) * 6, rng=None,
):
    """Keep only points inside (expanded) object boxes.  ``num_object >
    0`` samples that many boxes (with replacement, as the reference
    does)."""
    rng = _rng(rng)
    keep = [l for l in labels if l["name"] in keep_list]
    if not keep:
        keep = [l for l in labels if l["name"] != "DontCare"]
    selected = keep
    if num_object > 0:
        selected = [keep[i] for i in rng.choice(len(keep), num_object)]
    mask = np.zeros(points.n, dtype=bool)
    for label in selected:
        mask |= _in_box(label, points.xyz, expend_factor)
    if not mask.any():
        mask[0] = True
    return points.mask(mask), keep


def empty(points, labels, rng=None):
    return points, labels


# ---------------------------------------------------------------------------
# registry / composer
# ---------------------------------------------------------------------------

AUG_METHOD_MAP = {
    "random_jitter": random_jitter,
    "random_box_rotation": random_box_rotation,
    "random_box_shift": random_box_shift,
    "random_transition": random_transition,
    "remove_background": remove_background,
    "random_rotation_all": random_rotation_all,
    "random_flip_all": random_flip_all,
    "random_drop": random_drop,
    "random_global_drop": random_global_drop,
    "random_voxel_downsample": random_voxel_downsample,
    "random_scale_all": random_scale_all,
    "random_box_global_rotation": random_box_global_rotation,
    "dilute_background": dilute_background,
}


def get_data_aug(aug_configs: Sequence[Dict] = ()):
    """Compose configured methods into one ``fn(points, labels, rng)``."""
    if not aug_configs:
        return empty

    def multiple_aug(points, labels, rng=None):
        rng = _rng(rng)
        for aug_config in aug_configs:
            method = AUG_METHOD_MAP[aug_config["method_name"]]
            points, labels = method(
                points, labels, rng=rng, **aug_config["method_kwargs"]
            )
        return points, labels

    return multiple_aug
