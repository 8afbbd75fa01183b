"""On-device training pipeline (counterpart of
:mod:`pointgnn_tpu.train.device_pipeline`): the host packs points and
labels; the train step builds the graph, assigns labels and encodes the
box targets on the device.

    host:   frame -> pack points (+ labels) -> DeviceFrame
    device: voxel select -> slab metadata -> label assignment ->
            box encoding -> loss and gradients

The port trains on the two-level slab graph only (the exact uncapped
radius graph, the serving semantics).  The data side of the JAX
pipeline (KITTI reader, augmentation, the prefetching fetch closure) is
not ported yet.
"""

from typing import NamedTuple

import numpy as np
import torch

from pointgnn_tpu_torch import configs as cfg_mod
from pointgnn_tpu_torch.data.labels import LABEL_METHODS
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.graph import device_labels as dl


class DeviceFrame(NamedTuple):
    """One frame (or a stack of frames, leading axis), ready for the
    on-device train step: numpy on the host, tensors on the device."""

    packed_points: np.ndarray   # [P, 3 + C] (device_builder.pack_points)
    labels: dl.PackedLabels


def make_graph_builder(dspec, out_level: int, config):
    """``build(frame, rnd=None)``: one DeviceFrame -> labeled
    PaddedGraph on the frame's device.  ``rnd``, the ``(shift, perm)``
    draws of ``device_builder.draw_randomization``, randomizes the
    keypoint selection, as training must: a model fit to one frozen
    keypoint set per frame fails under any other graph construction."""
    label_map, _ = LABEL_METHODS[config["label_method"]]
    encode_fn = dl.get_encode(config["box_encoding_method"], label_map)

    def build(frame: DeviceFrame, rnd=None):
        pxyz, feats, mask = db.unpack_points(frame.packed_points)
        graph = db.build_padded_graph(pxyz, feats, mask, dspec, rnd=rnd)
        kp_xyz = graph.vertex_xyz[out_level]
        kp_mask = graph.vertex_mask[out_level]
        cls, target, valid = dl.assign_labels(kp_xyz, kp_mask, frame.labels)
        enc = encode_fn(cls, kp_xyz, target)
        return graph._replace(
            cls_labels=cls, encoded_boxes=enc, valid_boxes=valid
        )

    return build


def stack_frames(frames) -> DeviceFrame:
    """Stack host DeviceFrames along a leading frame axis."""
    return DeviceFrame(
        np.stack([f.packed_points for f in frames]),
        dl.stack_packed_labels([f.labels for f in frames]),
    )


def frames_to_device(frame: DeviceFrame, device) -> DeviceFrame:
    """Copy a host DeviceFrame (or stack) to ``device``."""
    def put(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    return DeviceFrame(
        put(frame.packed_points), dl.PackedLabels(*map(put, frame.labels))
    )


def device_spec_for_training(config, tpu_settings: dict):
    """Training DeviceGraphSpec: the graph kwargs of the TRAIN section
    (coarser voxels than serving), capacities from the family's frame
    capacity."""
    cap = tpu_settings["frame_capacity"]
    return db.spec_from_config(
        config,
        num_points=cap.vertices[0],
        num_keypoints=cap.vertices[1],
        runtime=False,
    )


def resolve_device_setup(config, spec=None):
    """``(dspec, model_extra)`` for device-graph training: the spec (the
    family's training spec unless given) with both slab levels on, and
    the model's slab wiring and compute dtype (the family's setting,
    None = f32, unless the config's model_kwargs name one)."""
    tpu = cfg_mod.tpu_settings(config["label_method"])
    dspec = spec or device_spec_for_training(config, tpu)
    dspec = dspec._replace(slab_level1=True, slab_level0=True)
    model_extra = {
        "slab_level1": db.slab_kernel_wiring(dspec.level1),
        "slab_level0": db.slab_kernel_wiring(dspec.level0),
    }
    cd = tpu.get("compute_dtype")
    if cd and "compute_dtype" not in config.get("model_kwargs", {}):
        model_extra["compute_dtype"] = cd
    return dspec, model_extra
