"""On-device training pipeline (counterpart of
:mod:`pointgnn_tpu.train.device_pipeline`): the host packs points and
labels; the train step builds the graph, assigns labels and encodes the
box targets on the device.

    host:   frame -> pack points (+ labels) -> DeviceFrame
    device: voxel select -> slab metadata -> label assignment ->
            box encoding -> loss and gradients

The host side is :func:`build_device_fetch`: KITTI read, crop-paste
and the augmentation chain, then packing, with every random draw from
the request's own seed.  The graph is the two-level slab graph (the
exact uncapped radius graph, the serving semantics; the kernels K1 and
K2) or, with ``device_graph_slab: false``, capped radius edge lists in
the SRC-sentinel layout, which the model reduces on the generic segment
path (the JAX package's choice on every backend but a TPU).
"""

from typing import NamedTuple, Optional

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


def build_device_fetch(spec):
    """Host fetch closure for the device pipeline (a ``FetchSpec`` with
    ``device_spec`` set): ``fetch(frame_idx, seed) -> DeviceFrame``.
    Reads the frame's points (with RGB) and labels, pastes crop-aug
    samples, runs the augmentation chain, and packs points and labels;
    every draw comes from ``np.random.default_rng(seed)`` in the JAX
    package's order."""
    from pointgnn_tpu_torch.data import augment
    from pointgnn_tpu_torch.infer import select_input_features

    dataset = spec.dataset.build()
    config, train_config = spec.config, spec.train_config
    dspec = spec.device_spec
    aug_fn = augment.get_data_aug(
        () if spec.is_eval else train_config.get("data_aug_configs", ())
    )
    sampler = None
    if not spec.is_eval and "crop_aug" in train_config:
        from pointgnn_tpu_torch.data.crop_aug import CropAugSampler

        sampler = CropAugSampler(train_config["crop_aug"]["crop_filename"])
    label_map, num_classes = LABEL_METHODS[config["label_method"]]
    expend_factor = tuple(train_config.get("expend_factor", (1.0, 1.0, 1.0)))

    def fetch(frame_idx: int, seed: Optional[int] = None) -> DeviceFrame:
        rng = np.random.default_rng(seed)
        points = dataset.get_cam_points_in_image_with_rgb(
            frame_idx, config.get("downsample_by_voxel_size")
        )
        labels = dataset.get_label(frame_idx)
        if sampler is not None:
            points, labels = sampler.crop_aug(
                points,
                labels,
                sample_rate=train_config["crop_aug"]["sample_rate"],
                parser_kwargs=train_config["crop_aug"]["parser_kwargs"],
                rng=rng,
            )
        points, labels = aug_fn(points, labels, rng=rng)
        features = select_input_features(
            points.attr, config["input_features"]
        )
        packed = db.pack_points(points.xyz, features, dspec.num_points)
        plabels = dl.pack_frame_labels(
            labels, label_map, num_classes, expend_factor
        )
        return DeviceFrame(packed, plabels)

    return fetch


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


def coerce_device_spec(obj):
    """A DeviceGraphSpec from a config value: the spec itself, None, or
    its JSON round trip (nested lists: JSON has no tuples).  The Trainer
    freezes the resolved spec into the train_config saved beside every
    checkpoint, so a resumed run or an evaluator reads it back in this
    form.  A level frozen by the JAX package carries one more field,
    ``approx_recall``, the recall of its approximate compaction on the
    TPU; the port compacts exactly, so the field is dropped."""
    if obj is None or isinstance(obj, db.DeviceGraphSpec):
        return obj
    if isinstance(obj, (list, tuple)):
        p, k, voxel, l0, l1, *flags = obj
        n = len(db.LevelSpec._fields)

        def level(lv):
            if len(lv) == n + 1:  # the JAX LevelSpec's approx_recall
                lv = lv[:n]
            return db.LevelSpec(*lv)

        return db.DeviceGraphSpec(
            int(p), int(k), float(voxel), level(l0), level(l1),
            *[bool(f) for f in flags],
        )
    raise TypeError(
        "device_graph_spec must be a DeviceGraphSpec or its JSON "
        "round-trip (nested lists), got %r" % (type(obj),)
    )


def resolve_device_setup(config, spec=None, slab="auto"):
    """``(dspec, model_extra)`` for device-graph training and evaluation:
    the spec (the family's training spec unless given, as a spec or its
    JSON round trip) with both slab flags set to the resolved ``slab``,
    and the model's edge sentinel, slab wiring and compute dtype (the
    family's setting, None = f32, unless the config's model_kwargs name
    one).  ``slab`` is the train_config's ``device_graph_slab``: True
    trains on the slab graph (K1, K2), False on capped edge lists
    through the segment path.  "auto" means the slab graph, the path
    with the kernels; the JAX package resolves it to edge lists on every
    backend but a TPU, and freezes the choice into the saved
    train_config, which is how its checkpoints reach here."""
    slab = True if slab == "auto" else bool(slab)
    tpu = cfg_mod.tpu_settings(config["label_method"])
    dspec = coerce_device_spec(spec) or device_spec_for_training(config, tpu)
    # the flags follow the resolved choice both ways: a frozen spec may
    # arrive with them set, and a slab graph has no edge list to reduce
    dspec = dspec._replace(slab_level1=slab, slab_level0=slab)
    model_extra = {"edge_sentinel": "src"}
    if slab:
        model_extra["slab_level1"] = db.slab_kernel_wiring(dspec.level1)
        model_extra["slab_level0"] = db.slab_kernel_wiring(dspec.level0)
    cd = tpu.get("compute_dtype")
    if cd and "compute_dtype" not in config.get("model_kwargs", {}):
        model_extra["compute_dtype"] = cd
    return dspec, model_extra
