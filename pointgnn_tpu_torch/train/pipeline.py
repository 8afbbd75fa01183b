"""Host input pipeline: the per-frame fetch and the prefetching frame
cache (counterpart of :mod:`pointgnn_tpu.train.pipeline`).

``build_fetch`` turns a picklable :class:`FetchSpec` into
``fetch(frame_idx, seed)``: with a ``device_spec``, the on-device
pipeline's fetch
(:func:`~pointgnn_tpu_torch.train.device_pipeline.build_device_fetch`:
KITTI read, crop-paste, augmentation, packing); without one, the
host-built graph's (:func:`build_host_fetch`: the same read, crop-paste
and augmentation, then the multi-level graph, the input features, label
assignment and box encoding on the host, as a
:class:`~pointgnn_tpu_torch.graph.pad.FrameData`).

``DataProvider`` is the asynchronous in-memory cache of the reference's
trainer: a worker pool refreshes cached frames in the background, a
``capacity``-way randomized slot per frame stores independently
augmented variants, and ``load_dataset_every_N_time`` sets how often a
cached variant is reused before it is refreshed.  Every request carries
its own seed, drawn from the provider's generator in the JAX package's
order, so the frames do not depend on which process fetched them.
"""

import multiprocessing
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from pointgnn_tpu_torch.data.kitti import KittiDataset
from pointgnn_tpu_torch.graph.pad import FrameData


class DatasetSpec(NamedTuple):
    """Picklable KittiDataset constructor arguments."""

    image_dir: str
    point_dir: str
    calib_dir: str
    label_dir: str
    index_filename: Optional[str] = None
    num_classes: int = 8
    difficulty: int = -100

    def build(self) -> KittiDataset:
        return KittiDataset(
            self.image_dir,
            self.point_dir,
            self.calib_dir,
            self.label_dir,
            index_filename=self.index_filename,
            num_classes=self.num_classes,
            difficulty=self.difficulty,
        )

    @staticmethod
    def from_kitti_root(root: str, split_file: str = "", num_classes: int = 8):
        """The KITTI tree layout that ``train.py`` and ``run.py`` read."""
        return DatasetSpec(
            os.path.join(root, "image/training/image_2"),
            os.path.join(root, "velodyne/training/velodyne"),
            os.path.join(root, "calib/training/calib"),
            os.path.join(root, "labels/training/label_2"),
            split_file or None,
            num_classes=num_classes,
        )


class FetchSpec(NamedTuple):
    """Everything a worker needs to build the fetch, picklable."""

    dataset: DatasetSpec
    config: Dict
    train_config: Dict
    is_eval: bool = False  # eval skips crop_aug and augmentation
    # a graph.device_builder.DeviceGraphSpec: the fetch returns packed
    # points and packed GT boxes, and the train step builds the graph,
    # assigns labels and encodes boxes on the device; None: the fetch
    # builds the graph on the host
    device_spec: Optional[object] = None


def build_fetch(spec: FetchSpec):
    """Instantiate the fetch closure from a spec (worker-side)."""
    if spec.device_spec is None:
        return build_host_fetch(spec)
    from pointgnn_tpu_torch.train.device_pipeline import build_device_fetch

    return build_device_fetch(spec)


def build_host_fetch(spec: FetchSpec):
    """``fetch(frame_idx, seed) -> FrameData`` of the host-built graph:
    points (with RGB) and labels, crop-aug samples pasted, the
    augmentation chain, the training graph (``graph_gen_kwargs``), the
    input features, a label per last-level vertex and its encoded box.
    Every draw comes from ``np.random.default_rng(seed)`` in the JAX
    package's order; the arrays have the JAX fetch's dtypes."""
    from pointgnn_tpu_torch.data import augment
    from pointgnn_tpu_torch.data.labels import get_label_assigner
    from pointgnn_tpu_torch.graph import builder
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.model import encodings

    dataset = spec.dataset.build()
    config, train_config = spec.config, spec.train_config
    aug_fn = augment.get_data_aug(
        () if spec.is_eval else train_config.get("data_aug_configs", ())
    )
    sampler = None
    if not spec.is_eval and "crop_aug" in train_config:
        from pointgnn_tpu_torch.data.crop_aug import CropAugSampler

        sampler = CropAugSampler(train_config["crop_aug"]["crop_filename"])
    assigner = get_label_assigner(config["label_method"])
    box_encoding_fn = encodings.get_box_encoding_fn(
        config["box_encoding_method"]
    )
    expend_factor = tuple(train_config.get("expend_factor", (1.0, 1.0, 1.0)))
    last_level = config["model_kwargs"]["layer_configs"][-1]["graph_level"]

    def fetch(frame_idx: int, seed: Optional[int] = None) -> FrameData:
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
        vcl, kil, el = builder.gen_multi_level_local_graph_v3(
            points.xyz, **config["graph_gen_kwargs"], rng=rng
        )
        features = select_input_features(
            points.attr, config["input_features"]
        )
        last_xyz = vcl[last_level + 1]
        cls_labels, boxes_3d, valid_boxes, label_map = assigner(
            labels, last_xyz, expend_factor
        )
        encoded = box_encoding_fn(cls_labels, last_xyz, boxes_3d, label_map)
        return FrameData(
            features=features.astype(np.float32),
            vertex_coord_list=[v.astype(np.float32) for v in vcl],
            keypoint_indices_list=[k.astype(np.int32) for k in kil],
            edges_list=[e.astype(np.int32) for e in el],
            cls_labels=cls_labels.astype(np.int32),
            encoded_boxes=encoded.astype(np.float32),
            valid_boxes=valid_boxes.astype(np.float32),
        )

    return fetch


# ---------------------------------------------------------------------------
# worker-pool plumbing (module-level for picklability)
# ---------------------------------------------------------------------------

_WORKER_FETCH = None


def _init_worker(spec: FetchSpec):
    global _WORKER_FETCH
    _WORKER_FETCH = build_fetch(spec)


def _worker_fetch(frame_idx: int, seed: Optional[int]):
    return _WORKER_FETCH(frame_idx, seed)


class DataProvider:
    """Async prefetching frame cache (the reference trainer's
    semantics)."""

    def __init__(
        self,
        spec: FetchSpec,
        load_dataset_to_mem: bool = True,
        load_dataset_every_N_time: int = 1,
        capacity: int = 1,
        num_workers: int = 1,
        preload_list: Sequence[int] = (),
        async_load_rate: float = 1.0,
        result_pool_limit: int = 10000,
        num_frames: Optional[int] = None,
        seed: int = 0,
    ):
        self._fetch = build_fetch(spec)
        self._buffer: Dict[int, tuple] = {}
        self._results: Dict[int, object] = {}
        self._load_to_mem = load_dataset_to_mem
        self._load_every_n = load_dataset_every_N_time
        self._capacity = capacity
        self._num_frames = num_frames
        self._async_load_rate = async_load_rate
        self._result_pool_limit = result_pool_limit
        self._rng = np.random.default_rng(seed)
        self._pool = None
        if num_workers > 0:
            # spawn, not fork: the Trainer opens the provider with a CUDA
            # context and a prefetch thread alive, and neither survives a
            # fork.  Workers start from a fresh import and rebuild the
            # fetch from the picklable spec; each request carries its
            # seed, so the frames are the same under any start method.
            self._pool = multiprocessing.get_context("spawn").Pool(
                processes=num_workers,
                initializer=_init_worker,
                initargs=(spec,),
            )
        if preload_list:
            self.preload(preload_list)

    def _seed(self) -> int:
        return int(self._rng.integers(0, 2**31 - 1))

    def preload(self, frame_idx_list: Sequence[int]):
        if self._pool is None:
            return
        for frame_idx in frame_idx_list:
            self._results[frame_idx] = self._pool.apply_async(
                _worker_fetch, (frame_idx, self._seed())
            )

    def async_load(self, frame_idx: int):
        """Take the prefetched result (or fetch inline) and requeue."""
        if frame_idx in self._results:
            data = self._results.pop(frame_idx).get()
        else:
            data = self._fetch(frame_idx, self._seed())
        if self._pool is not None:
            if self._rng.random() < self._async_load_rate:
                if len(self._results) < self._result_pool_limit:
                    self._results[frame_idx] = self._pool.apply_async(
                        _worker_fetch, (frame_idx, self._seed())
                    )
        return data

    def provide(self, frame_idx: int):
        if not self._load_to_mem:
            return self._fetch(frame_idx, self._seed())
        if self._load_every_n >= 1:
            if self._num_frames is None:
                raise ValueError("num_frames is required for the slotted "
                                 "cache (load_dataset_every_N_time >= 1)")
            slot = frame_idx + int(
                self._rng.integers(self._capacity)
            ) * self._num_frames
            if slot not in self._buffer:
                self._buffer[slot] = (self.async_load(frame_idx), 0)
            data, ctr = self._buffer[slot]
            if ctr == self._load_every_n:
                self._buffer[slot] = (self.async_load(frame_idx), 0)
            data, ctr = self._buffer[slot]
            self._buffer[slot] = (data, ctr + 1)
            return data
        return self.async_load(frame_idx)

    def provide_batch(self, frame_idx_list: Sequence[int]) -> List:
        return [self.provide(i) for i in frame_idx_list]

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
