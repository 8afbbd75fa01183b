"""On-device label assignment and box-target encoding for training
(counterpart of :mod:`pointgnn_tpu.graph.device_labels`).

Targets attach to keypoints, and on-device graphs choose their keypoints
inside the train step, so labels are assigned there too.  The host packs
each frame's objects into fixed-size arrays (box face normals and
projection bounds, :func:`pack_frame_labels`, numpy); the device
projects every keypoint against every box:

- later labels overwrite earlier ones (last match wins);
- foreground classes split horizontal/vertical by normalized yaw;
- unmapped non-DontCare objects mark their points with the DontCare id
  and ``valid = 0``;
- everything else is Background (0) with ``valid = 0``.
"""

import functools
import warnings
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.model import encodings


class PackedLabels(NamedTuple):
    """Fixed-size per-frame ground truth (numpy on the host, tensors on
    the device)."""

    normals: np.ndarray     # [M, 3, 3] f32 box face normals
    lower: np.ndarray       # [M, 3] f32 projection lower bounds
    upper: np.ndarray       # [M, 3] f32 projection upper bounds
    box_cls: np.ndarray     # [M] i32 assigned class id (incl. vertical)
    target_box: np.ndarray  # [M, 7] f32 target box (normalized yaw)
    has_target: np.ndarray  # [M] f32 1 = localization target valid
    active: np.ndarray      # [M] f32 1 = slot holds a real object


def pack_frame_labels(
    labels: List[Dict],
    label_map: Dict[str, int],
    num_classes: int,
    expend_factor: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    max_boxes: int = 64,
) -> PackedLabels:
    """Host side: KITTI label dicts -> fixed-size arrays."""
    dontcare_cls = num_classes - 1
    normals = np.zeros((max_boxes, 3, 3), np.float32)
    lower = np.zeros((max_boxes, 3), np.float32)
    upper = np.full((max_boxes, 3), -1.0, np.float32)  # empty test fails
    box_cls = np.zeros((max_boxes,), np.int32)
    target_box = np.zeros((max_boxes, 7), np.float32)
    has_target = np.zeros((max_boxes,), np.float32)
    active = np.zeros((max_boxes,), np.float32)
    slot = 0
    for label in labels:
        obj_cls = label_map.get(label["name"], dontcare_cls)
        is_fg = 1 <= obj_cls <= num_classes - 2
        if not is_fg and label["name"] == "DontCare":
            continue
        if slot >= max_boxes:
            warnings.warn(
                "pack_frame_labels: more than %d objects; extra labels "
                "dropped" % max_boxes,
                RuntimeWarning,
                stacklevel=2,
            )
            break
        box = box_ops.label_to_box(label)
        n, lo, up = box_ops.boxes_to_normals(box[None], expend_factor)
        normals[slot] = n[0]
        lower[slot] = lo[0]
        upper[slot] = up[0]
        if is_fg:
            yaw = box_ops.normalize_yaw(label["yaw"])
            box_cls[slot] = obj_cls + (yaw >= 0.25 * np.pi)
            tb = box.copy()
            tb[6] = yaw
            target_box[slot] = tb
            has_target[slot] = 1.0
        else:
            box_cls[slot] = obj_cls  # dontcare id, valid = 0
        active[slot] = 1.0
        slot += 1
    return PackedLabels(
        normals, lower, upper, box_cls, target_box, has_target, active
    )


def stack_packed_labels(packed: List[PackedLabels]) -> PackedLabels:
    """Stack per-frame PackedLabels along a leading batch axis."""
    return PackedLabels(*[np.stack(f) for f in zip(*packed)])


def assign_labels(kp_xyz, kp_mask, packed: PackedLabels):
    """Device-side assignment for one frame's keypoints (``packed``
    holds tensors on the keypoints' device).

    Returns ``(cls_labels [K] i32, target_boxes [K, 7] f32, valid_boxes
    [K] f32)``; padded keypoints get background and ``valid = 0``."""
    proj = torch.einsum(
        "mij,kj->mki", packed.normals.to(torch.float32),
        kp_xyz.to(torch.float32),
    )  # [M, K, 3]
    inside = torch.all(
        (proj > packed.lower[:, None, :]) & (proj < packed.upper[:, None, :]),
        dim=-1,
    ) & (packed.active[:, None] > 0)  # [M, K]
    m = inside.shape[0]
    # last match wins: the first hit scanning the boxes backwards
    midx = (m - 1) - torch.argmax(inside.flip(0).to(torch.int32), dim=0)
    hit = torch.any(inside, dim=0) & kp_mask.to(torch.bool)
    zero = torch.zeros((), device=kp_xyz.device)
    cls_labels = torch.where(hit, packed.box_cls[midx].to(torch.int32),
                             torch.zeros((), dtype=torch.int32,
                                         device=kp_xyz.device))
    target = torch.where(hit[:, None], packed.target_box[midx], zero)
    valid = torch.where(hit, packed.has_target[midx], zero)
    return cls_labels, target.to(torch.float32), valid.to(torch.float32)


def get_encode(name, label_map):
    """Device encoder for the config's ``box_encoding_method``."""
    if name == "classaware_all_class_box_encoding":
        return functools.partial(
            encodings.classaware_encode,
            tables=encodings.build_class_tables(label_map),
        )
    raise KeyError(
        "no device encoder for box encoding %r — train on host graphs "
        "for this config" % name
    )
