"""Class label maps and the host label assigners (copy of
:mod:`pointgnn_tpu.data.labels`).

Every class splits into a horizontal id ``c`` and a vertical id
``c + 1``; 0 is background and ``num_classes - 1`` is DontCare.  The
device pipeline assigns labels in ``graph/device_labels.py``; the
host-built graph's fetch assigns them here, per point of the last level.
"""

from typing import Dict, List, Tuple

import numpy as np

from pointgnn_tpu_torch.core import boxes as box_ops

LABEL_MAP_YAW: Dict[str, int] = {
    "Background": 0,
    "Car": 1,
    "Pedestrian": 3,
    "Cyclist": 5,
    "DontCare": 7,
}
LABEL_MAP_CAR: Dict[str, int] = {"Background": 0, "Car": 1, "DontCare": 3}
LABEL_MAP_PED_CYC: Dict[str, int] = {
    "Background": 0,
    "Pedestrian": 1,
    "Cyclist": 3,
    "DontCare": 5,
}

# label_method name (config "label_method") -> (label_map, num_classes)
LABEL_METHODS = {
    "yaw": (LABEL_MAP_YAW, 8),
    "Car": (LABEL_MAP_CAR, 4),
    "Pedestrian_and_Cyclist": (LABEL_MAP_PED_CYC, 6),
}


def assign_classaware_labels(
    labels: List[Dict],
    xyz: np.ndarray,
    expend_factor: Tuple[float, float, float],
    label_map: Dict[str, int],
    num_classes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict[str, int]]:
    """A class id and a target 7-DoF box for every point (host copy of
    :func:`pointgnn_tpu.data.labels.assign_classaware_labels`).

    Points inside an object of the label map get its horizontal id, or
    the vertical id ``+ 1`` when the folded yaw is at least pi/4, its box
    (yaw normalized) and ``valid = 1``; points inside another object that
    is not DontCare get the DontCare id with ``valid = 0``.  Returns
    ``(cls_labels [N,1] int64, boxes_3d [N,1,7] float64, valid_boxes
    [N,1,1] float32, label_map)``."""
    xyz = np.asarray(xyz)
    num_points = xyz.shape[0]
    if num_points == 0:
        raise ValueError("no points to label")
    if xyz.shape[1] != 3:
        raise ValueError("xyz must be [N, 3], got %s" % (xyz.shape,))
    dontcare_cls = num_classes - 1
    cls_labels = np.zeros((num_points, 1), dtype=np.int64)
    boxes_3d = np.zeros((num_points, 1, 7))
    valid_boxes = np.zeros((num_points, 1, 1), dtype=np.float32)
    for label in labels:
        obj_cls = label_map.get(label["name"], dontcare_cls)
        if 1 <= obj_cls <= num_classes - 2:
            box = box_ops.label_to_box(label)
            mask = box_ops.points_in_box(xyz, box, expend_factor)
            yaw = box_ops.normalize_yaw(label["yaw"])
            cls_labels[mask, :] = obj_cls + (yaw >= 0.25 * np.pi)
            box[6] = yaw
            boxes_3d[mask, 0, :] = box
            valid_boxes[mask, 0, :] = 1.0
        elif label["name"] != "DontCare":
            box = box_ops.label_to_box(label)
            mask = box_ops.points_in_box(xyz, box, expend_factor)
            cls_labels[mask, :] = obj_cls
            valid_boxes[mask, 0, :] = 0.0
    return cls_labels, boxes_3d, valid_boxes, label_map


def assign_classaware_label_to_points(labels, xyz, expend_factor):
    """The 8-class variant."""
    return assign_classaware_labels(labels, xyz, expend_factor,
                                    LABEL_MAP_YAW, 8)


def assign_classaware_car_label_to_points(labels, xyz, expend_factor):
    """The 4-class Car variant."""
    return assign_classaware_labels(labels, xyz, expend_factor,
                                    LABEL_MAP_CAR, 4)


def assign_classaware_ped_and_cyc_label_to_points(labels, xyz, expend_factor):
    """The 6-class Pedestrian and Cyclist variant."""
    return assign_classaware_labels(labels, xyz, expend_factor,
                                    LABEL_MAP_PED_CYC, 6)


def get_label_assigner(label_method: str):
    """The assigner of a config's ``label_method``."""
    label_map, num_classes = LABEL_METHODS[label_method]

    def assign(labels, xyz, expend_factor):
        return assign_classaware_labels(labels, xyz, expend_factor,
                                        label_map, num_classes)

    return assign
