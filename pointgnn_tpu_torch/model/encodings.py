"""Box encoding and decoding (counterpart of
:mod:`pointgnn_tpu.model.encodings` and of ``classaware_encode_jax`` in
:mod:`pointgnn_tpu.graph.device_labels`): on the device (torch, the
serving decode and the device pipeline's labels) and on the host (numpy,
float64, the host-built graph's fetch).

The six codecs of the reference: ``direct_encoding``,
``center_box_encoding``, ``voxelnet_box_encoding`` (4 flat ids, one yaw
normalizer pi/2), ``classaware_voxelnet_box_encoding`` (a fixed 8-id
table), ``classaware_all_class_box_encoding`` (every shipped config) and
``classaware_all_class_box_canonical_encoding`` (the horizontal offset
rotated into the box frame).  Class-aware codecs are driven by per-class-id
tables ``(sizes [C,3], yaw_offset [C], active [C])``, so encoding and
decoding are gathers.  Every codec has a host encoder and decoder and a
device decoder (:func:`get_decode`); the device encoder of the device
pipeline is :func:`classaware_encode`, the only one the JAX package has
too.
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


# the anchor sizes of the (class-aware) voxelnet codecs
_VOXELNET_SIZES = {
    "Car": (3.9, 1.56, 1.6),
    "Pedestrian": (0.8, 1.73, 0.6),
    "Cyclist": (1.76, 1.73, 0.6),
}
# voxelnet: 4 flat ids (the reference's Pedestrian id 3 is its cyclist
# slot, sized as a pedestrian)
_VOXELNET_FLAT_SIZES = np.ones((4, 3), dtype=np.float64)
_VOXELNET_FLAT_ACTIVE = np.zeros((4,), dtype=bool)
for _id, _name in ((2, "Car"), (1, "Pedestrian"), (3, "Pedestrian")):
    _VOXELNET_FLAT_SIZES[_id] = _VOXELNET_SIZES[_name]
    _VOXELNET_FLAT_ACTIVE[_id] = True
_VOXELNET_FLAT_TABLES = (_VOXELNET_FLAT_SIZES, np.zeros(4),
                         _VOXELNET_FLAT_ACTIVE)


# classaware voxelnet: a fixed 8-id table
_CA_VOXELNET_TABLES = build_class_tables(
    {"Background": 0, "Car": 1, "Pedestrian": 3, "Cyclist": 5, "DontCare": 7},
    num_ids=8,
    size_map=_VOXELNET_SIZES,
)


def get_encoding_len(name):
    if name not in _ENCODERS:
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


# (id of a class table, device) -> (the table, its tensors there): each
# table is copied to a device once, not on every decode (a host sync)
_device_tables = {}


def _class_lookup(cls_ids, tables, device):
    key = (id(tables), str(device))
    if key not in _device_tables:
        sizes, yaw_offset, active = tables
        _device_tables[key] = (tables, (
            torch.as_tensor(sizes, dtype=torch.float32, device=device),
            torch.as_tensor(yaw_offset, dtype=torch.float32, device=device),
            torch.as_tensor(active, device=device)))
    sizes, yaw_offset, active = _device_tables[key][1]
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


def classaware_canonical_decode(cls_ids, points_xyz, encoded, tables):
    """Decode [N, 7] canonical encodings: the horizontal offset comes
    back out of the box frame (vertical sub-classes swap the l / w
    normalizers)."""
    sz, yoff, act = _class_lookup(cls_ids, tables, encoded.device)
    e = encoded
    angle = e[:, 6] * QUARTER_PI
    ca, sa = torch.cos(angle), torch.sin(angle)
    vert = yoff > 0.0
    norm0 = torch.where(vert, sz[:, 2], sz[:, 0])
    norm2 = torch.where(vert, sz[:, 0], sz[:, 2])
    dec0 = e[:, 0] * norm0 * ca + e[:, 2] * norm2 * sa
    dec2 = -e[:, 0] * norm0 * sa + e[:, 2] * norm2 * ca
    x = torch.where(act, dec0, e[:, 0])
    y = torch.where(act, e[:, 1] * sz[:, 1], e[:, 1])
    z = torch.where(act, dec2, e[:, 2])
    xyz = torch.stack([x, y, z], dim=-1) + points_xyz
    lhw = torch.where(act[:, None], torch.exp(e[:, 3:6]) * sz, e[:, 3:6])
    yaw = torch.where(act, angle + yoff, e[:, 6])
    return torch.cat([xyz, lhw, yaw[:, None]], dim=-1)


def direct_decode(cls_ids, points_xyz, encoded):
    return encoded


def center_decode(cls_ids, points_xyz, encoded):
    return torch.cat([encoded[:, 0:3] + points_xyz, encoded[:, 3:]], dim=-1)


def voxelnet_decode(cls_ids, points_xyz, encoded):
    """Decode [N, 7] voxelnet encodings (4 flat ids, yaw times pi/2)."""
    sz, _, act = _class_lookup(cls_ids, _VOXELNET_FLAT_TABLES,
                               encoded.device)
    xyz = torch.where(act[:, None], encoded[:, 0:3] * sz, encoded[:, 0:3])
    xyz = xyz + points_xyz
    lhw = torch.where(
        act[:, None], torch.exp(encoded[:, 3:6]) * sz, encoded[:, 3:6]
    )
    yaw = encoded[:, 6] * HALF_PI
    return torch.cat([xyz, lhw, yaw[:, None]], dim=-1)


def get_decode(name, label_map):
    """Device decoder ``fn(cls_ids, points_xyz, encoded) -> [N, 7]`` of
    any of the six codecs."""
    if name == "classaware_all_class_box_encoding":
        return functools.partial(
            classaware_decode, tables=build_class_tables(label_map)
        )
    if name == "classaware_voxelnet_box_encoding":
        return functools.partial(classaware_decode,
                                 tables=_CA_VOXELNET_TABLES)
    if name == "classaware_all_class_box_canonical_encoding":
        return functools.partial(classaware_canonical_decode,
                                 tables=build_class_tables(label_map))
    decoders = {"direct_encoding": direct_decode,
                "center_box_encoding": center_decode,
                "voxelnet_box_encoding": voxelnet_decode}
    if name not in decoders:
        raise KeyError("no device decoder for box encoding %r" % name)
    return decoders[name]


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


def classaware_voxelnet_box_encoding(cls_labels, points_xyz, boxes_3d,
                                     label_map=None):
    return _classaware_encode_np(cls_labels, points_xyz, boxes_3d,
                                 _CA_VOXELNET_TABLES)


def classaware_voxelnet_box_decoding(cls_labels, points_xyz, encoded_boxes,
                                     label_map=None):
    return _classaware_decode_np(cls_labels, points_xyz, encoded_boxes,
                                 _CA_VOXELNET_TABLES)


def direct_box_encoding(cls_labels, points_xyz, boxes_3d, label_map=None):
    return np.array(boxes_3d, copy=True)


def direct_box_decoding(cls_labels, points_xyz, encoded_boxes,
                        label_map=None):
    return np.array(encoded_boxes, copy=True)


def center_box_encoding(cls_labels, points_xyz, boxes_3d, label_map=None):
    out = np.array(boxes_3d, copy=True)
    out[..., 0:3] = out[..., 0:3] - _broadcast_points(points_xyz, out)
    return out


def center_box_decoding(cls_labels, points_xyz, encoded_boxes,
                        label_map=None):
    out = np.array(encoded_boxes, copy=True)
    out[..., 0:3] = out[..., 0:3] + _broadcast_points(points_xyz, out)
    return out


def _voxelnet_lookup(cls_labels):
    return _lookup(cls_labels, _VOXELNET_FLAT_SIZES, np.zeros(4),
                   _VOXELNET_FLAT_ACTIVE)


def _voxelnet_lookup(cls_labels, ndim):
    """The flat voxelnet sizes and activity per row, shaped for [N, 7]
    or [N, 1, 7] boxes."""
    sz, _, act = _lookup(cls_labels, _VOXELNET_FLAT_SIZES, np.zeros(4),
                         _VOXELNET_FLAT_ACTIVE)
    return (sz[:, None], act[:, None]) if ndim == 3 else (sz, act)


def voxelnet_box_encoding(cls_labels, points_xyz, boxes_3d, label_map=None):
    """[N, 7] boxes: car / ped / cyc anchor-normalized, every yaw over
    pi/2.  Also the host fetch's [N, 1, 7] boxes, where the JAX function
    raises a broadcast error."""
    out = np.array(boxes_3d, dtype=np.float64, copy=True)
    out[..., 0:3] -= _broadcast_points(points_xyz, out)
    sz, act = _voxelnet_lookup(cls_labels, out.ndim)
    out[..., 0:3] = np.where(act[..., None], out[..., 0:3] / sz,
                             out[..., 0:3])
    out[..., 3:6] = np.where(
        act[..., None], np.log(np.maximum(out[..., 3:6], 1e-12) / sz),
        out[..., 3:6])
    out[..., 6] = out[..., 6] / HALF_PI
    return out


def voxelnet_box_decoding(cls_labels, points_xyz, encoded_boxes,
                          label_map=None):
    out = np.array(encoded_boxes, dtype=np.float64, copy=True)
    sz, act = _voxelnet_lookup(cls_labels, out.ndim)
    out[..., 0:3] = np.where(act[..., None], out[..., 0:3] * sz,
                             out[..., 0:3])
    out[..., 3:6] = np.where(act[..., None], np.exp(out[..., 3:6]) * sz,
                             out[..., 3:6])
    out[..., 0:3] += _broadcast_points(points_xyz, out)
    out[..., 6] = out[..., 6] * HALF_PI
    return out


def _canonical_norms(sz, yoff):
    """The l / w normalizers of the rotated offset: swapped for the
    vertical sub-classes."""
    vert = yoff > 0.0
    return (np.where(vert, sz[:, 2], sz[:, 0]),
            np.where(vert, sz[:, 0], sz[:, 2]))


def classaware_all_class_box_canonical_encoding(cls_labels, points_xyz,
                                                boxes_3d, label_map):
    """As :func:`classaware_all_class_box_encoding`, with the horizontal
    offset rotated into the box frame."""
    sizes, yaw_offset, active = build_class_tables(label_map)
    boxes = np.asarray(boxes_3d, dtype=np.float64)
    out = np.array(boxes, copy=True)
    out[..., 0:3] = boxes[..., 0:3] - _broadcast_points(points_xyz, out)
    sz, yoff, act = _lookup(cls_labels, sizes, yaw_offset, active)
    b = boxes[:, 0, :]
    d = out[:, 0, :].copy()
    angle = b[:, 6] - yoff
    ca, sa = np.cos(angle), np.sin(angle)
    norm0, norm2 = _canonical_norms(sz, yoff)
    enc0 = (d[:, 0] * ca - d[:, 2] * sa) / norm0
    enc1 = d[:, 1] / sz[:, 1]
    enc2 = (d[:, 0] * sa + d[:, 2] * ca) / norm2
    out[:, 0, 0] = np.where(act, enc0, d[:, 0])
    out[:, 0, 1] = np.where(act, enc1, d[:, 1])
    out[:, 0, 2] = np.where(act, enc2, d[:, 2])
    out[:, 0, 3:6] = np.where(act[:, None],
                              np.log(np.maximum(b[:, 3:6], 1e-12) / sz),
                              d[:, 3:6])
    out[:, 0, 6] = np.where(act, angle / QUARTER_PI, d[:, 6])
    return out


def classaware_all_class_box_canonical_decoding(cls_labels, points_xyz,
                                                encoded_boxes, label_map):
    """The inverse of
    :func:`classaware_all_class_box_canonical_encoding`."""
    sizes, yaw_offset, active = build_class_tables(label_map)
    enc = np.asarray(encoded_boxes, dtype=np.float64)
    out = np.array(enc, copy=True)
    sz, yoff, act = _lookup(cls_labels, sizes, yaw_offset, active)
    e = enc[:, 0, :]
    angle = e[:, 6] * QUARTER_PI
    ca, sa = np.cos(angle), np.sin(angle)
    norm0, norm2 = _canonical_norms(sz, yoff)
    dec0 = e[:, 0] * norm0 * ca + e[:, 2] * norm2 * sa
    dec2 = -e[:, 0] * norm0 * sa + e[:, 2] * norm2 * ca
    out[:, 0, 0] = np.where(act, dec0, e[:, 0])
    out[:, 0, 1] = np.where(act, e[:, 1] * sz[:, 1], e[:, 1])
    out[:, 0, 2] = np.where(act, dec2, e[:, 2])
    out[:, 0, 3:6] = np.where(act[:, None], np.exp(e[:, 3:6]) * sz,
                              e[:, 3:6])
    out[:, 0, 6] = np.where(act, angle + yoff, e[:, 6])
    out[..., 0:3] = out[..., 0:3] + _broadcast_points(points_xyz, out)
    return out


_ENCODERS = {
    "direct_encoding": direct_box_encoding,
    "center_box_encoding": center_box_encoding,
    "voxelnet_box_encoding": voxelnet_box_encoding,
    "classaware_voxelnet_box_encoding": classaware_voxelnet_box_encoding,
    "classaware_all_class_box_encoding": classaware_all_class_box_encoding,
    "classaware_all_class_box_canonical_encoding":
        classaware_all_class_box_canonical_encoding,
}
_DECODERS = {
    "direct_encoding": direct_box_decoding,
    "center_box_encoding": center_box_decoding,
    "voxelnet_box_encoding": voxelnet_box_decoding,
    "classaware_voxelnet_box_encoding": classaware_voxelnet_box_decoding,
    "classaware_all_class_box_encoding": classaware_all_class_box_decoding,
    "classaware_all_class_box_canonical_encoding":
        classaware_all_class_box_canonical_decoding,
}


def get_box_encoding_fn(name):
    """The host encoder ``fn(cls_labels, points_xyz, boxes_3d,
    label_map)`` of a config's box encoding."""
    return _ENCODERS[name]


def get_box_decoding_fn(name):
    """The host decoder of a config's box encoding."""
    return _DECODERS[name]
