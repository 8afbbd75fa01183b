"""Box encoding and decoding on the device (counterpart of the
class-aware part of :mod:`pointgnn_tpu.model.encodings` and of
``classaware_encode_jax`` in :mod:`pointgnn_tpu.graph.device_labels`).

Class-aware encodings are driven by per-class-id tables ``(sizes [C,3],
yaw_offset [C], active [C])``, so encoding and decoding are gathers.
Only ``classaware_all_class_box_encoding`` (every shipped config) is
ported.
"""

import functools
from typing import Dict, Tuple

import numpy as np
import torch

HALF_PI = 0.5 * np.pi
QUARTER_PI = 0.25 * np.pi

# Median KITTI object dimensions (l, h, w)
MEDIAN_OBJECT_SIZE = {
    "Cyclist": (1.76, 1.75, 0.6),
    "Van": (4.98, 2.13, 1.88),
    "Tram": (14.66, 3.61, 2.6),
    "Car": (3.88, 1.5, 1.63),
    "Misc": (2.52, 1.65, 1.51),
    "Pedestrian": (0.88, 1.77, 0.65),
    "Truck": (10.81, 3.34, 2.63),
    "Person_sitting": (0.75, 1.26, 0.59),
}

_ENCODINGS = (
    "direct_encoding",
    "center_box_encoding",
    "voxelnet_box_encoding",
    "classaware_voxelnet_box_encoding",
    "classaware_all_class_box_encoding",
    "classaware_all_class_box_canonical_encoding",
)


def build_class_tables(
    label_map: Dict[str, int], num_ids: int = None, size_map: Dict = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class-id lookup tables from a name->id label map; the
    vertical sub-class of id ``c`` is ``c + 1`` (yaw offset pi/2).
    Returns ``(sizes [C,3], yaw_offset [C], active [C] bool)``."""
    if size_map is None:
        size_map = MEDIAN_OBJECT_SIZE
    if num_ids is None:
        num_ids = max(label_map.values()) + 1
    sizes = np.ones((num_ids, 3), dtype=np.float64)
    yaw_offset = np.zeros((num_ids,), dtype=np.float64)
    active = np.zeros((num_ids,), dtype=bool)
    for name, cls_id in label_map.items():
        if name in ("Background", "DontCare") or name not in size_map:
            continue
        for offset, yoff in ((0, 0.0), (1, HALF_PI)):
            idx = cls_id + offset
            if idx < num_ids:
                sizes[idx] = size_map[name]
                yaw_offset[idx] = yoff
                active[idx] = True
    return sizes, yaw_offset, active


def get_encoding_len(name):
    if name not in _ENCODINGS:
        raise KeyError(name)
    return 7


def classaware_decode(cls_ids, points_xyz, encoded, tables):
    """Decode [N, 7] encoded boxes (one class column selected) given
    [N] class ids and [N, 3] vertex coordinates; float32 throughout."""
    sz, yoff, act = _class_lookup(cls_ids, tables, encoded.device)
    xyz = torch.where(act[:, None], encoded[:, 0:3] * sz, encoded[:, 0:3])
    xyz = xyz + points_xyz
    lhw = torch.where(
        act[:, None], torch.exp(encoded[:, 3:6]) * sz, encoded[:, 3:6]
    )
    yaw = torch.where(act, encoded[:, 6] * QUARTER_PI + yoff, encoded[:, 6])
    return torch.cat([xyz, lhw, yaw[:, None]], dim=-1)


def _class_lookup(cls_ids, tables, device):
    sizes, yaw_offset, active = tables
    sizes = torch.as_tensor(sizes, dtype=torch.float32, device=device)
    yaw_offset = torch.as_tensor(yaw_offset, dtype=torch.float32,
                                 device=device)
    active = torch.as_tensor(active, device=device)
    ids = torch.clamp(cls_ids.to(torch.int64), 0, sizes.shape[0] - 1)
    return sizes[ids], yaw_offset[ids], active[ids]


def classaware_encode(cls_ids, points_xyz, boxes, tables):
    """Encode [N, 7] target boxes against [N, 3] vertex coordinates for
    [N] class ids (the inverse of :func:`classaware_decode`)."""
    sz, yoff, act = _class_lookup(cls_ids, tables, boxes.device)
    off = boxes[:, 0:3] - points_xyz
    xyz = torch.where(act[:, None], off / sz, off)
    lhw = torch.where(
        act[:, None], torch.log(torch.clamp(boxes[:, 3:6], min=1e-12) / sz),
        boxes[:, 3:6],
    )
    yaw = torch.where(act, (boxes[:, 6] - yoff) / QUARTER_PI, boxes[:, 6])
    return torch.cat([xyz, lhw, yaw[:, None]], dim=-1)


def get_decode(name, label_map):
    """Device decoder ``fn(cls_ids, points_xyz, encoded) -> [N, 7]``."""
    if name == "classaware_all_class_box_encoding":
        return functools.partial(
            classaware_decode, tables=build_class_tables(label_map)
        )
    raise NotImplementedError(
        "no ported device decoder for box encoding %r" % name
    )
