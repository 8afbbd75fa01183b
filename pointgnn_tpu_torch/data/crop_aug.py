"""Crop-and-paste ground-truth augmentation (copy of
:mod:`pointgnn_tpu.data.crop_aug`).

Offline: crop per-object point clusters from a dataset into a JSON
library.  Online: sample N objects per class and paste them into a
frame with collision rejection (box overlap, point capture, or both),
optionally snapping the pasted box to the local ground height.  The JSON
schema is the JAX package's (and the reference's), so a library written
by either package loads in the other.
"""

import copy
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.postprocess import iou as iou_lib
from pointgnn_tpu_torch.postprocess.nms import boxes_3d_to_corners


def save_cropped_boxes(
    dataset,
    filename: str,
    expand_factor=(1.1, 1.1, 1.1),
    minimum_points: int = 10,
    backlist=(),
):
    """Crop all GT clusters with enough points into a JSON library."""
    cropped_labels: Dict[str, List] = {}
    cropped_points: Dict[str, List] = {}
    for frame_idx in range(dataset.num_files):
        labels = dataset.get_label(frame_idx)
        cam_points = dataset.get_cam_points_in_image_with_rgb(frame_idx)
        for label in labels:
            if label["name"] == "DontCare" or label["name"] in backlist:
                continue
            mask = box_ops.points_in_box(
                cam_points.xyz, box_ops.label_to_box(label), expand_factor
            )
            if mask.sum() > minimum_points:
                cropped_labels.setdefault(label["name"], []).append(label)
                cropped_points.setdefault(label["name"], []).append(
                    [
                        cam_points.xyz[mask].tolist(),
                        cam_points.attr[mask].tolist(),
                    ]
                )
    with open(filename, "w") as f:
        json.dump((cropped_labels, cropped_points), f)


def load_cropped_boxes(filename: str):
    """Load a JSON library back into Points."""
    with open(filename) as f:
        cropped_labels, cropped_points = json.load(f)
    for key in cropped_points:
        for i, entry in enumerate(cropped_points[key]):
            cropped_points[key][i] = Points(
                xyz=np.array(entry[0]), attr=np.array(entry[1])
            )
    return cropped_labels, cropped_points


def parser_without_collision(
    cam_rgb_points: Points,
    labels: List[Dict],
    sample_cam_points: List[Points],
    sample_labels: List[Dict],
    overlap_mode: str = "box",
    auto_box_height: bool = False,
    max_overlap_rate: float = 0.01,
    appr_factor: float = 100,
    max_overlap_num_allowed: int = 1,
    max_trails: int = 1,
    method_name: str = "normal",
    yaw_std: float = 0.3,
    expand_factor=(1.1, 1.1, 1.1),
    must_have_ground: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Points, List[Dict]]:
    """Paste sampled clusters into the frame.

    Each sample is rotated around the camera origin by a random yaw,
    optionally snapped to ground height (max y of points in the box's
    BEV footprint), then accepted if it passes the configured overlap
    test; accepted boxes evict the frame points they cover.
    """
    rng = rng or np.random.default_rng()
    xyz = cam_rgb_points.xyz
    attr = cam_rgb_points.attr
    labels = list(labels)
    placed_corners = None
    if overlap_mode in ("box", "box_and_point"):
        placed_corners = boxes_3d_to_corners(
            np.stack([box_ops.label_to_box(l) for l in labels])
        )
        placed_corners = np.int32(appr_factor * placed_corners).astype(
            np.float64
        )
    for i, label in enumerate(sample_labels):
        for _ in range(max_trails):
            if method_name == "normal":
                delta_yaw = rng.normal(scale=yaw_std)
            else:
                delta_yaw = rng.uniform(low=-yaw_std, high=yaw_std)
            new_label = copy.deepcopy(label)
            R = box_ops.yaw_rotation(np.asarray(delta_yaw))
            center = np.array(
                [new_label["x3d"], new_label["y3d"], new_label["z3d"]]
            )
            new_label["x3d"], new_label["y3d"], new_label["z3d"] = (
                center @ R.T
            )
            new_label["yaw"] += delta_yaw
            y3d_adjust = 0.0
            if auto_box_height:
                mask_2d = box_ops.points_in_box_bev(
                    xyz, box_ops.label_to_box(new_label), expand_factor
                )
                if mask_2d.sum() > 0:
                    ground_height = np.amax(xyz[mask_2d][:, 1])
                    y3d_adjust = ground_height - new_label["y3d"]
                elif must_have_ground:
                    continue
                new_label["y3d"] += y3d_adjust
            mask = box_ops.points_in_box(
                xyz, box_ops.label_to_box(new_label), expand_factor
            )
            below_overlap = True
            if overlap_mode in ("box", "box_and_point"):
                new_corners = np.int32(
                    appr_factor
                    * boxes_3d_to_corners(
                        box_ops.label_to_box(new_label)[None]
                    )
                ).astype(np.float64)
                below_overlap = np.all(
                    iou_lib.overlapped_boxes_3d(
                        new_corners[0], placed_corners
                    )
                    < max_overlap_rate
                )
            if overlap_mode in ("point", "box_and_point"):
                below_overlap = below_overlap and (
                    mask.sum() < max_overlap_num_allowed
                )
            if below_overlap:
                sample_xyz = sample_cam_points[i].xyz @ R.T
                if auto_box_height:
                    sample_xyz = sample_xyz.copy()
                    sample_xyz[:, 1] += y3d_adjust
                xyz = np.concatenate([sample_xyz, xyz[~mask]], axis=0)
                attr = np.concatenate(
                    [sample_cam_points[i].attr, attr[~mask]], axis=0
                )
                labels.append(new_label)
                if placed_corners is not None:
                    placed_corners = np.append(
                        placed_corners, new_corners, axis=0
                    )
                break
    return Points(xyz=xyz, attr=attr), labels


class CropAugSampler:
    """Samples from a cropped-object library and pastes into frames."""

    def __init__(self, crop_filename: str):
        self._cropped_labels, self._cropped_points = load_cropped_boxes(
            crop_filename
        )

    def crop_aug(
        self,
        cam_rgb_points: Points,
        labels: List[Dict],
        sample_rate: Optional[Dict[str, int]] = None,
        parser_kwargs: Optional[Dict] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[Points, List[Dict]]:
        rng = rng or np.random.default_rng()
        sample_rate = sample_rate or {"Car": 1, "Pedestrian": 1, "Cyclist": 1}
        sample_labels: List[Dict] = []
        sample_points: List[Points] = []
        for key, count in sample_rate.items():
            idx = rng.choice(
                len(self._cropped_labels[key]), size=count, replace=False
            )
            sample_labels.extend(
                copy.deepcopy([self._cropped_labels[key][i] for i in idx])
            )
            sample_points.extend(
                Points(
                    self._cropped_points[key][i].xyz.copy(),
                    self._cropped_points[key][i].attr.copy(),
                )
                for i in idx
            )
        return parser_without_collision(
            cam_rgb_points,
            labels,
            sample_points,
            sample_labels,
            rng=rng,
            **(parser_kwargs or {}),
        )
