"""Box encoding and decoding (counterpart of the class-aware part of
:mod:`pointgnn_tpu.model.encodings` and of ``classaware_encode_jax`` in
:mod:`pointgnn_tpu.graph.device_labels`): on the device (torch, the
serving decode and the device pipeline's labels) and on the host (numpy,
float64, the host-built graph's fetch).

Class-aware encodings are driven by per-class-id tables ``(sizes [C,3],
yaw_offset [C], active [C])``, so encoding and decoding are gathers.
Only ``classaware_all_class_box_encoding`` (every shipped config) is
ported; the other codecs raise (``ROADMAP.md`` Queue 1 item 6).
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
        "no ported device decoder for box encoding %r (ROADMAP.md Queue 1 "
        "item 6)" % name
    )


# --------------------------------------------------------------------------
# host (numpy) encoding of the host-built graph's fetch
# --------------------------------------------------------------------------

def _lookup(cls_labels, sizes, yaw_offset, active):
    raw = np.asarray(cls_labels).reshape(-1)
    in_range = (raw >= 0) & (raw < len(active))
    ids = np.clip(raw, 0, len(active) - 1)
    return sizes[ids], yaw_offset[ids], active[ids] & in_range


def _broadcast_points(points_xyz, boxes):
    """[N, 3] vertex coordinates against [N, 7] or [N, C, 7] boxes."""
    pts = np.asarray(points_xyz)
    return pts[:, None, :] if boxes.ndim == 3 else pts


def _classaware_encode_np(cls_labels, points_xyz, boxes_3d, tables):
    sizes, yaw_offset, active = tables
    boxes = np.asarray(boxes_3d, dtype=np.float64)
    out = np.array(boxes, copy=True)
    out[..., 0:3] = boxes[..., 0:3] - _broadcast_points(points_xyz, out)
    sz, yoff, act = _lookup(cls_labels, sizes, yaw_offset, active)
    b = boxes[:, 0, :]
    o = out[:, 0, :]
    enc_xyz = o[:, 0:3] / sz
    enc_lhw = np.log(np.maximum(b[:, 3:6], 1e-12) / sz)
    enc_yaw = (b[:, 6] - yoff) / QUARTER_PI
    out[:, 0, 0:3] = np.where(act[:, None], enc_xyz, o[:, 0:3])
    out[:, 0, 3:6] = np.where(act[:, None], enc_lhw, o[:, 3:6])
    out[:, 0, 6] = np.where(act, enc_yaw, o[:, 6])
    return out


def _classaware_decode_np(cls_labels, points_xyz, encoded_boxes, tables):
    sizes, yaw_offset, active = tables
    enc = np.asarray(encoded_boxes, dtype=np.float64)
    out = np.array(enc, copy=True)
    sz, yoff, act = _lookup(cls_labels, sizes, yaw_offset, active)
    e = enc[:, 0, :]
    out[:, 0, 0:3] = np.where(act[:, None], e[:, 0:3] * sz, e[:, 0:3])
    out[:, 0, 3:6] = np.where(act[:, None], np.exp(e[:, 3:6]) * sz,
                              e[:, 3:6])
    out[:, 0, 6] = np.where(act, e[:, 6] * QUARTER_PI + yoff, e[:, 6])
    out[..., 0:3] = out[..., 0:3] + _broadcast_points(points_xyz, out)
    return out


def classaware_all_class_box_encoding(cls_labels, points_xyz, boxes_3d,
                                      label_map):
    """[N, 1, 7] target boxes -> [N, 1, 7] encodings (float64), for the
    [N, 1] class ids of the points."""
    return _classaware_encode_np(cls_labels, points_xyz, boxes_3d,
                                 build_class_tables(label_map))


def classaware_all_class_box_decoding(cls_labels, points_xyz, encoded_boxes,
                                      label_map):
    """The inverse of :func:`classaware_all_class_box_encoding`."""
    return _classaware_decode_np(cls_labels, points_xyz, encoded_boxes,
                                 build_class_tables(label_map))


def get_box_encoding_fn(name):
    """The host encoder ``fn(cls_labels, points_xyz, boxes_3d,
    label_map)`` of a config's box encoding."""
    if name == "classaware_all_class_box_encoding":
        return classaware_all_class_box_encoding
    raise NotImplementedError(
        "no ported host encoder for box encoding %r (ROADMAP.md Queue 1 "
        "item 6)" % name
    )


def get_box_decoding_fn(name):
    """The host decoder of a config's box encoding."""
    if name == "classaware_all_class_box_encoding":
        return classaware_all_class_box_decoding
    raise NotImplementedError(
        "no ported host decoder for box encoding %r (ROADMAP.md Queue 1 "
        "item 6)" % name
    )
