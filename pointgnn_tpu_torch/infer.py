"""Serving pipeline: points -> detections -> KITTI text.

Counterpart of :class:`pointgnn_tpu.infer.InferencePipeline`, with its
serving surface: ``run_frame``, the pipelined ``stream`` and
``run_dataset`` over a KITTI tree (``run_torch.py`` drives it).

Host-built graphs (``on_device_graph=False``, ``run.py``'s default):
per frame the host builds the runtime graph (voxel downsampling and the
native radius search, ``graph/builder.py``), grows the capacity to fit
it, pads it (``graph/pad.py``) and copies it to the card; the card runs
the network on the generic segment path in f32, the softmax and the box
decode of every (vertex, class) pair; the host masks the hypotheses,
folds the vertical classes and runs merge-NMS.  No hand-written kernel
runs on this path.

Device-built graphs (``on_device_graph=True``): ``slab=True`` (both
levels through ``slab_edge_max``), ``slab="l1"`` (level 0 on the capped
edge list through ``fused_edge_max``, level 1 through ``slab_edge_max``),
``slab=False`` with ``pallas_tail`` (both levels on capped edge lists
through ``fused_edge_max``) or without it (the segment path).  Per frame
the host packs the points into one array; the device unpacks it, builds
the two-level graph, runs the network, softmax, the hypothesis mask,
top-k and the box decode; the host then folds the vertical classes and
runs merge-NMS.

On the card the device program of device-built graphs has no host sync
(K1's pair lists have a capacity and keep their counts on the card) and
is replayed as one CUDA graph (``InferencePipeline.device_fn``).

Stage times go into ``time_dict`` under the JAX pipeline's bucket names;
the native NMS loop's counts (its pairs, its boxes) go into
``nms_counters``, K1's pairs per call into ``k1_counters``.
"""

import collections
import concurrent.futures
import contextlib
import copy
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pointgnn_tpu_torch.core import boxes as box_ops
from pointgnn_tpu_torch.core.points import Points
from pointgnn_tpu_torch.data.kitti import KittiDataset
from pointgnn_tpu_torch.data.labels import LABEL_METHODS
from pointgnn_tpu_torch.graph import builder
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.graph import pad
from pointgnn_tpu_torch.model import encodings
from pointgnn_tpu_torch.model.pointgnn import get_model
from pointgnn_tpu_torch.nn import cuda_build
from pointgnn_tpu_torch.nn import slab as slab_ops
from pointgnn_tpu_torch.parallel import mesh as mesh_lib
from pointgnn_tpu_torch.postprocess import iou as iou_lib
from pointgnn_tpu_torch.postprocess import nms as nms_lib
from pointgnn_tpu_torch.train import checkpoint as ckpt
from pointgnn_tpu_torch.utils.device import resolve_device

# class-id -> KITTI name, folding horizontal/vertical pairs
ALL_CLASS_NAMES = {
    "yaw": [
        "Background", "Car", "Car", "Pedestrian", "Pedestrian",
        "Cyclist", "Cyclist", "DontCare",
    ],
    "Car": ["Background", "Car", "Car", "DontCare"],
    "Pedestrian_and_Cyclist": [
        "Background", "Pedestrian", "Pedestrian", "Cyclist", "Cyclist",
        "DontCare",
    ],
}

IMG_CLIP_W = 1242.0
IMG_CLIP_H = 375.0


def select_input_features(attr: np.ndarray, mode: str) -> np.ndarray:
    """Input-feature selection ('irgb'|'0rgb'|'0000'|'i000'|'rgb'|'i'|'0');
    ``attr`` is [N, 4] = intensity+rgb (or [N, 1] for 'i'/'0')."""
    if mode == "irgb":
        return attr.astype(np.float32)
    if mode == "rgb":
        return attr[:, 1:4].astype(np.float32)
    if mode == "0rgb":
        return np.hstack(
            [np.zeros((attr.shape[0], 1), np.float32), attr[:, 1:4]]
        ).astype(np.float32)
    if mode == "0000":
        return np.zeros_like(attr[:, :4], dtype=np.float32)
    if mode == "i000":
        return np.hstack(
            [attr[:, [0]], np.zeros((attr.shape[0], 3), np.float32)]
        ).astype(np.float32)
    if mode == "i":
        return attr[:, [0]].astype(np.float32)
    if mode == "0":
        return np.zeros((attr.shape[0], 1), dtype=np.float32)
    raise ValueError("unknown input_features mode: %s" % mode)


def input_feature_dim(mode: str) -> int:
    return {"irgb": 4, "rgb": 3, "0rgb": 4, "0000": 4, "i000": 4,
            "i": 1, "0": 1}[mode]


def occlusion_score(box: np.ndarray, xyz: np.ndarray) -> float:
    """Projected-extent coverage product: how much of the box's three
    axis extents the inlier points span."""
    if xyz.shape[0] == 0:
        return 0.0
    normals, lower, upper = box_ops.boxes_to_normals(box[None, :])
    normals, lower, upper = normals[0], lower[0], upper[0]
    projected = xyz @ normals.T
    spans = projected.max(axis=0) - projected.min(axis=0)
    return float(np.prod(spans / (upper - lower)))


def detections_to_kitti_labels(
    label_method: str,
    class_labels: np.ndarray,
    boxes_3d: np.ndarray,
    scores: np.ndarray,
    calib: Dict,
    aux: Dict,
    use_box_score: bool = True,
) -> List[Tuple]:
    """Project NMS survivors to 2D, clip, truncation-filter and
    occlusion-rescore; returns KITTI label tuples.  ``aux["hyp_xyz"]``
    holds all masked hypothesis coordinates."""
    names = ALL_CLASS_NAMES[label_method]
    pred_labels: List[Tuple] = []
    if len(class_labels) == 0:
        return pred_labels
    corners = nms_lib.boxes_3d_to_corners(boxes_3d)
    for i in range(len(corners)):
        xy = KittiDataset.cam_points_to_image(
            Points(xyz=corners[i]), calib
        ).xyz[:, :2]
        xmin, ymin = np.amin(xy, axis=0)
        xmax, ymax = np.amax(xy, axis=0)
        clip_xmin, clip_ymin = max(xmin, 0.0), max(ymin, 0.0)
        clip_xmax = min(xmax, IMG_CLIP_W)
        clip_ymax = min(ymax, IMG_CLIP_H)
        truncation_rate = 1.0 - (clip_ymax - clip_ymin) * (
            clip_xmax - clip_xmin
        ) / ((ymax - ymin) * (xmax - xmin))
        if truncation_rate > 0.4:
            continue
        x3d, y3d, z3d, l, h, w, yaw = boxes_3d[i]
        if not l > 0:
            raise ValueError("box %d has non-positive length %r" % (i, l))
        score = scores[i]
        if use_box_score:
            inside = box_ops.points_in_box(aux["hyp_xyz"], boxes_3d[i])
            score = (
                1.0 + occlusion_score(boxes_3d[i], aux["hyp_xyz"][inside])
            ) * score
        pred_labels.append(
            (
                names[int(class_labels[i])], -1, -1, 0,
                clip_xmin, clip_ymin, clip_xmax, clip_ymax,
                h, w, l, x3d, y3d, z3d, yaw, score,
            )
        )
    return pred_labels


def format_kitti_lines(pred_labels: List[Tuple]) -> str:
    """KITTI label file text: every field ``str()``-ed with a trailing
    space, a newline per label, one final blank line."""
    return (
        "".join(
            " ".join(str(v) for v in pred) + " \n" for pred in pred_labels
        )
        + "\n"
    )


def _mesh_devices(mesh) -> List[torch.device]:
    """The serving devices of ``stream(mesh=...)``."""
    if isinstance(mesh, mesh_lib.Mesh):
        return list(mesh.devices)
    if (isinstance(mesh, (list, tuple)) and mesh
            and all(isinstance(d, (str, torch.device)) for d in mesh)):
        return [resolve_device(d) for d in mesh]
    raise TypeError(
        "stream(mesh=...) takes a pointgnn_tpu_torch.parallel.mesh.Mesh or "
        "a list of devices, got %s" % type(mesh).__name__)


class _Staging:
    """Two pinned host buffers that carry packed frames to one CUDA
    device: a frame is copied into the next buffer (once the copy to the
    card that last read it has finished, two frames ago) and from there
    to the card without waiting for it.  Pinning a buffer per frame costs
    milliseconds of the host's time; torch's CPU copy into the buffer
    would wake its intra-op threads, which then spin on the host's cores,
    so numpy copies, in the calling thread.  One thread uses it."""

    def __init__(self, like, device):
        self.device = device
        self.bufs = [torch.empty_like(like, pin_memory=True) for _ in (0, 1)]
        self.copied = [None, None]  # the event after each buffer's copy
        self.turn = 0

    def __call__(self, host):
        i, self.turn = self.turn, 1 - self.turn
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        np.copyto(self.bufs[i].numpy(), host.numpy())
        packed = self.bufs[i].to(self.device, non_blocking=True)
        self.copied[i] = torch.cuda.Event()
        self.copied[i].record()
        return packed


def _tree_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return None if tree is None else tree.to(device, copy=True)


# the JAX pipeline's slab_tuning keys that shape the Pallas kernel's walk
# (tile rows, MLP sub-blocks, the z-scan): the CUDA kernel has no such knob
PALLAS_ONLY_TUNING = ("tile", "sub", "zscan")


def slab_tuning_levels(slab_tuning: Optional[Dict]):
    """``(level 0, level 1)`` kernel options of a ``slab_tuning`` dict,
    read as the JAX pipeline reads it: flat (``{"block_centers": 16}``,
    both levels) or per level (``{"level0": {...}, "level1": {...}}``; a
    level without its key takes the flat keys).  Only ``block_centers``
    (a positive int) reaches ``slab_edge_max``; ``tile``, ``sub`` and
    ``zscan`` and any unknown key raise ``ValueError``."""
    tuning = dict(slab_tuning or {})

    def pick(t, where, levels=False):
        allowed = ("block_centers",) + (("level0", "level1") if levels
                                        else ())
        pallas = sorted(k for k in t if k in PALLAS_ONLY_TUNING)
        if pallas:
            raise ValueError(
                "slab_tuning%s: %s: options of the Pallas kernel's walk, "
                "with no CUDA counterpart; only block_centers tunes "
                "slab_edge_max" % (where, ", ".join(pallas)))
        unknown = sorted(str(k) for k in t if k not in allowed
                         and k not in PALLAS_ONLY_TUNING)
        if unknown:
            raise ValueError("slab_tuning%s: unknown keys %s"
                             % (where, ", ".join(unknown)))
        if "block_centers" not in t:
            return {}
        bk = t["block_centers"]
        if isinstance(bk, bool) or not isinstance(bk, (int, np.integer)) \
                or bk < 1:
            raise ValueError("slab_tuning%s: block_centers must be a "
                             "positive int, got %r" % (where, bk))
        return {"block_centers": int(bk)}

    flat = pick(tuning, "", levels=True)
    return tuple(
        pick(tuning[key], "[%r]" % key) if key in tuning else flat
        for key in ("level0", "level1"))


class _GraphedProgram:
    """A device program captured as one CUDA graph, following PyTorch's
    recipe: after an eager warm-up call, captured on a side stream from a
    fixed input buffer into fixed output buffers.  A call copies a frame
    into the input, replays the graph on the current stream and returns
    copies of the outputs, so a later replay cannot overwrite what a
    caller holds.  Each replay adds the captured kernel launches to their
    wrappers' launch counters."""

    def __init__(self, program, params, packed):
        dev = packed.device
        self.params = params  # the graph reads them where they are
        self.packed = packed.clone()
        self.graph = torch.cuda.CUDAGraph()
        with cuda_build.capture_tally() as self.launches, \
                torch.cuda.device(dev), torch.cuda.graph(
                    self.graph, stream=torch.cuda.Stream(dev),
                    capture_error_mode="thread_local"):
            self.outs, self.k1 = program(params, self.packed)

    def fits(self, packed):
        return (packed.shape == self.packed.shape
                and packed.dtype == self.packed.dtype
                and packed.device == self.packed.device)

    def __call__(self, packed):
        self.packed.copy_(packed, non_blocking=True)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        outs = tuple(o.clone() for o in self.outs)
        k1 = None if self.k1 is None else (self.k1[0].clone(), self.k1[1])
        return outs, k1


class InferencePipeline:
    """Drives one config + parameter set over frames.

    ``on_device_graph`` chooses where the graph is built: on the host
    (False, the JAX pipeline's default) or on the card.  ``device_spec``
    and a ``slab`` other than ``"auto"`` configure the device-built
    graph and raise without ``on_device_graph=True``.

    Host-built graphs are padded to ``capacity`` (default: the config
    family's ``runtime_capacity``, ``configs.tpu_settings``), grown to
    fit each frame with a warning when ``auto_capacity`` (edge
    truncation shifts the aggregated features of a model trained on
    uncapped neighborhoods), and served in f32 (``compute_dtype="auto"``)
    with TF32 off, on the segment path in one block.

    On device-built graphs ``compute_dtype="auto"`` means bf16, a level
    on the segment path streams its edges in 8 blocks, ``slab`` is
    ``True`` (both levels), ``"l1"`` (level 1 only), ``False`` or
    ``"auto"`` and ``pallas_tail`` a bool or ``"auto"``.  They resolve as
    in the JAX pipeline, except that ``"auto"`` means on for both, on the
    card and on the CPU (where the kernels' plain versions run), so the
    default is the slab path.  The device spec's slab flags are set both
    ways: a spec passed in with flags set has them cleared where slab
    resolves off.  ``edge_chunks`` is the segment path's edge blocks
    (default 8 on device-built graphs, else one block, as in JAX).
    ``slab_tuning`` (:func:`slab_tuning_levels`) sets ``slab_edge_max``'s
    ``block_centers`` (the center blocks of its pair-list windows) per
    level; the pair list is exact, so every accepted value gives the
    same detections.  It raises on host-built graphs and for a level
    that does not run ``slab_edge_max``.

    ``params`` are restored from ``checkpoint_dir`` (the port's format,
    :mod:`train.checkpoint`) when given, else drawn from ``seed``;
    ``restored_step`` records the checkpoint's step (0 otherwise)."""

    def __init__(
        self,
        config: Dict,
        params=None,
        checkpoint_dir: Optional[str] = None,
        capacity: Optional[pad.GraphCapacity] = None,
        device_spec: Optional[db.DeviceGraphSpec] = None,
        compute_dtype="auto",
        seed: int = 0,
        device=None,
        use_box_merge: bool = True,
        use_box_score: bool = True,
        max_hypotheses: int = 4096,
        pallas_tail="auto",
        slab="auto",
        on_device_graph: bool = False,
        auto_capacity: bool = True,
        edge_chunks: Optional[int] = None,
        slab_tuning: Optional[Dict] = None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.max_hypotheses = max_hypotheses
        self.label_method = config["label_method"]
        self.num_classes = config["num_classes"]
        self.use_box_merge = use_box_merge
        self.use_box_score = use_box_score
        label_map, n_cls = LABEL_METHODS[self.label_method]
        if n_cls != self.num_classes:
            raise ValueError("config num_classes disagrees with its labels")
        self.decode = encodings.get_decode(
            config["box_encoding_method"], label_map
        )
        self.enc_len = encodings.get_encoding_len(
            config["box_encoding_method"]
        )
        if not on_device_graph and (device_spec is not None
                                    or slab != "auto" or slab_tuning):
            raise ValueError(
                "device_spec, slab and slab_tuning configure device-built "
                "graphs; "
                "on_device_graph=False builds the graph on the host"
            )
        self.on_device_graph = on_device_graph
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.on_device_graph else None
        self.compute_dtype = compute_dtype
        self.device_spec = None
        slab_level1 = slab_level0 = None
        if self.on_device_graph:
            fast_ok = all(
                lc.get("kwargs", {}).get(key, "NONE") == "NONE"
                for lc in config["model_kwargs"]["layer_configs"][:-1]
                for key in ("point_MLP_normalization_type",
                            "edge_MLP_normalization_type")
            )
            if pallas_tail == "auto":
                pallas_tail = fast_ok
            self.pallas_tail = bool(pallas_tail)
            if slab == "auto":
                slab = self.pallas_tail and fast_ok
            self.slab = "l1" if slab == "l1" else bool(slab)
            spec = device_spec or db.spec_from_config(config)
            # two-way: also clear flags set on a spec passed in
            self.device_spec = spec._replace(
                slab_level1=bool(self.slab),
                slab_level0=bool(self.slab) and self.slab != "l1",
            )
            t_l0, t_l1 = slab_tuning_levels(slab_tuning)
            runs = (self.device_spec.slab_level0,
                    self.device_spec.slab_level1)
            if slab_tuning and (not any(runs) or any(
                    "level%d" % lv in slab_tuning and not runs[lv]
                    for lv in (0, 1))):
                raise ValueError(
                    "slab_tuning %r tunes slab_edge_max at a level this "
                    "pipeline does not run it on (slab=%r)"
                    % (slab_tuning, self.slab))
            # K1's pair lists at a capacity: no host sync in device_fn
            cap0, cap1 = db.k1_pair_capacities(self.device_spec)
            if runs[1]:
                slab_level1 = dict(
                    db.slab_kernel_wiring(self.device_spec.level1), **t_l1,
                    pair_capacity=cap1)
            if runs[0]:
                slab_level0 = dict(
                    db.slab_kernel_wiring(self.device_spec.level0), **t_l0,
                    pair_capacity=cap0)
            if edge_chunks is None:
                edge_chunks = 8  # bound the segment path's edge rows
        else:
            self.pallas_tail = False
            self.slab = False
            # f32 serving: the dense layers must not drop to TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if capacity is None:
            from pointgnn_tpu_torch import configs as cfg_mod

            capacity = cfg_mod.tpu_settings(self.label_method)[
                "runtime_capacity"]
        self.capacity = capacity
        self.auto_capacity = auto_capacity
        self.model = get_model(config["model_name"])(
            num_classes=self.num_classes,
            box_encoding_len=self.enc_len,
            mode="test",
            compute_dtype=compute_dtype,
            slab_level1=slab_level1,
            slab_level0=slab_level0,
            edge_sentinel="src" if self.on_device_graph else "dst",
            pallas_tail=self.pallas_tail,
            edge_chunks=edge_chunks,
            **config["model_kwargs"],
        )
        self.input_features = config["input_features"]
        self.restored_step = 0
        if params is None and checkpoint_dir is not None:
            state, self.restored_step = ckpt.restore_checkpoint(
                checkpoint_dir, device=self.device
            )
            if state is None:
                raise FileNotFoundError(
                    "no checkpoint found in %s" % checkpoint_dir
                )
            params = state["params"] if "params" in state else state
        elif params is None:
            params = self.model.init(
                seed, input_feature_dim(self.input_features), self.device
            )
        self.params = params
        self.time_dict: Dict[str, float] = {}
        self._time_lock = threading.Lock()  # stream() times off-thread
        self.overflow_counters: Dict[str, int] = {}
        if slab_level0 or slab_level1:
            # frames recomputed on exact K1 pair lists (past a capacity)
            self.overflow_counters["k1_pairs"] = 0
        # the native NMS loop's pair and box counts (native.greedy_nms)
        self.nms_counters: Dict[str, int] = {}
        # K1's pairs per call of the device program, read a frame late
        # (:meth:`_count_k1`)
        self.k1_counters: Dict[str, int] = {}
        self.frames_done = 0
        # the CUDA graph of the device program by (device, id(params)),
        # under the lock: None before the second call, False where
        # capture failed; and each thread's pinned staging buffers
        self._graphs: Dict[Tuple[str, int], object] = {}
        self._graph_lock = threading.Lock()
        self._staging = threading.local()
        self._last_k1 = threading.local()  # device_fn's K1 counts, per thread

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def device_fn(self, params, packed):
        """Fused: unpack -> graph build -> GNN -> softmax -> hypothesis
        mask -> top-k -> box decode.  Returns ``(scores, classes,
        boxes, xyz)`` of the top ``max_hypotheses`` hypotheses; masked
        ones carry score -1.

        Nothing in it waits for the card: K1 builds its pair lists at
        the capacities of :func:`~pointgnn_tpu_torch.graph.device_builder.
        k1_pair_capacities` and leaves their counts on the card.  The
        call's counts (or None where no K1 call runs) are left for
        :meth:`_take_k1` in this thread.  So the outputs are valid only
        once those counts, read to the host, show no call past its
        capacity (:meth:`_count_k1` returns False); otherwise a pair list
        was cut, and :meth:`_exact_outputs` gives the frame's outputs, as
        ``run_frame`` and ``stream`` do.  On a CUDA device the slab and edge-list programs run
        as one CUDA graph per device and params, captured after the
        first call (which runs eagerly, as on the CPU): a call copies
        ``packed`` into the graph's input, replays it and returns copies
        of its outputs."""
        runner = self._graph_for(params, packed)
        if runner is None:
            outs, k1 = self._program(params, packed)
        else:
            outs, k1 = runner(packed)
        self._last_k1.value = k1
        return outs

    def _take_k1(self):
        """The K1 counts of this thread's last :meth:`device_fn` call."""
        k1, self._last_k1.value = getattr(self._last_k1, "value", None), None
        return k1

    def _program(self, params, packed):
        """The device program, eagerly: ``(outputs, k1)``, ``k1`` being
        ``(counts [calls] int32 on the device, capacities)`` of the K1
        calls, or None where none ran at a capacity."""
        with slab_ops.pair_counts() as log:
            outs = self._device_outputs(self.model, params, packed)
        if not log:
            return outs, None
        return outs, (torch.cat([c for c, _ in log]),
                      tuple(cap for _, cap in log))

    def _graph_for(self, params, packed):
        """The CUDA graph of the program on ``packed``'s device with
        ``params``, captured here at the second call for them; None where
        the program runs eagerly: the first call, off the card, on the
        segment path (whose ops sync), or where capture failed."""
        if (packed.device.type != "cuda" or not self.on_device_graph
                or not (self.slab or self.pallas_tail)):
            return None
        key = (str(packed.device), id(params))
        with self._graph_lock:
            if key not in self._graphs:
                self._graphs[key] = None  # the first call: eager
                return None
            runner = self._graphs[key]
            if runner is None:
                try:
                    runner = _GraphedProgram(self._program, params, packed)
                except RuntimeError as e:
                    warnings.warn("the device program runs eagerly on %s: "
                                  "CUDA graph capture failed (%s)"
                                  % (packed.device, e), RuntimeWarning)
                    runner = False
                self._graphs[key] = runner
        return runner if runner and runner.fits(packed) else None

    def _to_device(self, host, device):
        """A packed host frame on ``device``: on a CUDA device through
        this thread's :class:`_Staging` for it, with no wait for the
        card."""
        if device.type != "cuda":
            return host.to(device)
        by_device = self._staging.__dict__.setdefault("by_device", {})
        if str(device) not in by_device:
            by_device[str(device)] = _Staging(host, device)
        return by_device[str(device)](host)

    def _drop_graphs(self, params_list):
        """Forget the CUDA graphs captured for ``params_list``."""
        ids = {id(p) for p in params_list}
        with self._graph_lock:
            for key in [k for k in self._graphs if k[1] in ids]:
                del self._graphs[key]

    def _count_k1(self, k1) -> bool:
        """Adds one frame's K1 counts (``k1`` as :meth:`_program` gives
        it, the counts read to the host) to ``k1_counters`` (per call:
        ``call<i>_pairs`` summed over frames, ``call<i>_peak`` the most
        in a frame, ``call<i>_capacity``); True where a call's count
        passed its capacity, so its pair list was cut."""
        if k1 is None:
            return False
        counts, caps = k1
        c = self.k1_counters
        c["frames"] = c.get("frames", 0) + 1
        over = False
        for i, (n, cap) in enumerate(zip(counts.tolist(), caps)):
            c["call%d_pairs" % i] = c.get("call%d_pairs" % i, 0) + n
            c["call%d_peak" % i] = max(c.get("call%d_peak" % i, 0), n)
            c["call%d_capacity" % i] = cap
            over |= n > cap
        return over

    @torch.inference_mode()
    def _exact_outputs(self, params, packed):
        """The device program of a frame whose K1 pair list passed its
        capacity, run by a copy of the model whose K1 wiring has no
        capacity (exact pair lists, a host sync per call), read to the
        host; counted in ``overflow_counters["k1_pairs"]``."""
        exact = copy.copy(self.model)
        for attr in ("slab_level0", "slab_level1"):
            wiring = getattr(exact, attr)
            if wiring is not None:
                setattr(exact, attr, {k: v for k, v in wiring.items()
                                      if k != "pair_capacity"})
        outs = self._device_outputs(exact, params, packed)
        self.overflow_counters["k1_pairs"] += 1
        return tuple(o.cpu() for o in outs)

    def _device_outputs(self, model, params, packed):
        """The body of :meth:`device_fn`, with ``model``."""
        num_classes = self.num_classes
        points_xyz, features, mask = db.unpack_points(packed)
        graph = db.build_padded_graph(
            points_xyz, features, mask, self.device_spec
        )
        logits, box_enc = model.apply(params, graph)
        probs = model.postprocess(logits)
        out_level = model.output_graph_level
        kp_xyz = graph.vertex_xyz[out_level]
        kp_mask = graph.vertex_mask[out_level]
        k = probs.shape[0]
        flat_probs = probs.reshape(-1)
        cls_ids = torch.arange(
            num_classes, dtype=torch.int32, device=probs.device
        ).repeat(k)
        valid = kp_mask.to(torch.bool).repeat_interleave(num_classes)
        fg = (cls_ids > 0) & (cls_ids < num_classes - 1)
        score = torch.where(
            valid & fg & (flat_probs > 1.0 / num_classes),
            flat_probs,
            torch.full((), -1.0, device=probs.device),
        )
        topv, topi = torch.topk(score, min(self.max_hypotheses, score.numel()))
        sel_cls = cls_ids[topi]
        sel_xyz = kp_xyz[topi // num_classes]
        sel_enc = box_enc.reshape(-1, model.box_encoding_len)[topi]
        decoded = self.decode(sel_cls, sel_xyz, sel_enc)
        return topv, sel_cls, decoded, sel_xyz

    @torch.inference_mode()
    def host_graph_fn(self, params, graph: pad.PaddedGraph):
        """The device program of a host-built graph: forward -> softmax ->
        box decode of every (vertex, class) pair.  Returns ``(probs [K,
        C], decoded [K * C, 7])``."""
        model, num_classes = self.model, self.num_classes
        logits, box_enc = model.apply(params, graph)
        probs = model.postprocess(logits)
        k = probs.shape[0]
        cls_ids = torch.arange(
            num_classes, dtype=torch.int32, device=probs.device
        ).repeat(k)
        xyz = graph.vertex_xyz[model.output_graph_level].repeat_interleave(
            num_classes, dim=0)
        decoded = self.decode(cls_ids, xyz,
                              box_enc.reshape(-1, model.box_encoding_len))
        return probs, decoded

    def host_graph(self, points: Points, rng: np.random.Generator):
        """The padded runtime graph of one frame, on the host: the graph
        build, the capacity growth (with its warning) and the padding."""
        gen_kwargs = self.config.get(
            "runtime_graph_gen_kwargs", self.config["graph_gen_kwargs"]
        )
        vcl, kil, el = builder.gen_multi_level_local_graph_v3(
            points.xyz, **gen_kwargs, rng=rng
        )
        features = select_input_features(points.attr, self.input_features)
        frame = pad.FrameData(features, vcl, kil, el)
        if self.auto_capacity:
            self.capacity, grew = pad.grow_to_fit(self.capacity, [frame])
            if grew:
                warnings.warn(
                    "graph exceeds the padded capacity; growing to %r "
                    "instead of truncating" % (self.capacity,),
                    RuntimeWarning,
                    stacklevel=4,  # run_frame's caller
                )
        return pad.pad_frame(frame, self.capacity)

    # ------------------------------------------------------------------
    def _pack(self, points: Points):
        """A frame's host side before the card: its capacity-overflow
        stats (``db.host_overflow_stats``) added to ``overflow_counters``,
        with a warning on keypoint drop that points at the caller of
        ``run_frame`` (or of ``next`` on ``stream``), and the packed
        frame as a CPU tensor."""
        stats = db.host_overflow_stats(points.xyz, self.device_spec)
        for key, val in stats.items():
            self.overflow_counters[key] = (
                self.overflow_counters.get(key, 0) + int(val)
            )
        if stats["keypoints_dropped"] > 0:
            warnings.warn(
                "keypoint overflow: %d occupied voxels > capacity %d;"
                " %d keypoints dropped (raise num_keypoints in the "
                "DeviceGraphSpec)"
                % (stats["voxels_occupied"], self.device_spec.num_keypoints,
                   stats["keypoints_dropped"]),
                RuntimeWarning,
                stacklevel=3,
            )
        return torch.from_numpy(db.pack_points(
            points.xyz,
            select_input_features(points.attr, self.input_features),
            self.device_spec.num_points,
        ))

    def _add_time(self, bucket, seconds):
        with self._time_lock:
            self.time_dict[bucket] = self.time_dict.get(bucket, 0) + seconds

    def run_frame(
        self, points: Points, rng: Optional[np.random.Generator] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
        """One frame: returns ``(class_labels, boxes_3d, scores, aux)``;
        ``aux`` carries the masked hypothesis coordinates and scores.
        ``rng`` draws the host-built graph's randomness (a fresh
        ``default_rng(0)`` when None, as in JAX); the device path takes
        none."""
        if not self.on_device_graph:
            return self._run_host_frame(
                points, rng or np.random.default_rng(0))
        t0 = time.time()
        packed = self._to_device(self._pack(points), self.device)
        t1 = time.time()
        self._add_time("gen graph", t1 - t0)
        outs = tuple(t.cpu() for t in self.device_fn(self.params, packed))
        k1 = self._take_k1()
        if k1 is not None and self._count_k1((k1[0].cpu(), k1[1])):
            outs = self._exact_outputs(self.params, packed)
        scores, sel_cls, sel_boxes, sel_xyz = (t.numpy() for t in outs)
        t2 = time.time()
        self._add_time("gnn inference", t2 - t1)
        result = self._finish_frame(scores, sel_cls, sel_boxes, sel_xyz)
        self._add_time("nms", time.time() - t2)
        return result

    def _run_host_frame(self, points, rng):
        t0 = time.time()
        graph = pad.to_device(self.host_graph(points, rng), self.device)
        t1 = time.time()
        self._add_time("gen graph", t1 - t0)
        probs, decoded = (t.cpu().numpy()
                          for t in self.host_graph_fn(self.params, graph))
        out_level = self.model.output_graph_level
        out_xyz = graph.vertex_xyz[out_level].cpu().numpy()
        vertex_valid = graph.vertex_mask[out_level].cpu().numpy().astype(
            bool)
        t2 = time.time()
        self._add_time("gnn inference", t2 - t1)
        # the hypothesis mask, in vertex-major order
        k = probs.shape[0]
        box_labels = np.tile(np.arange(self.num_classes)[None, :],
                             (k, 1)).reshape(-1)
        box_probs = probs.reshape(-1)
        hyp_xyz = np.repeat(out_xyz, self.num_classes, 0)
        hyp_valid = np.repeat(vertex_valid, self.num_classes)
        box_mask = (
            hyp_valid
            & (box_labels > 0)
            & (box_labels < self.num_classes - 1)
            & (box_probs > 1.0 / self.num_classes)
        )
        box_indices = np.flatnonzero(box_mask)
        t3 = time.time()
        self._add_time("decode box", t3 - t2)
        result = self._nms(box_labels[box_indices], box_probs[box_indices],
                           decoded[box_indices], hyp_xyz[box_indices])
        self._add_time("nms", time.time() - t3)
        return result

    def _finish_frame(self, scores, sel_cls, sel_boxes, sel_xyz):
        """Host tail of the device path: threshold, class fold,
        merge-NMS."""
        keep = scores > 0
        return self._nms(sel_cls[keep], scores[keep], sel_boxes[keep],
                         sel_xyz[keep])

    def _nms(self, sel_cls, sel_probs, sel_boxes, sel_xyz):
        """Class fold and merge-NMS of the kept hypotheses."""
        self.frames_done += 1
        sel_labels = sel_cls.astype(np.int64)
        sel_probs = sel_probs.astype(np.float64)
        aux = {"hyp_xyz": sel_xyz, "probs_ori": sel_probs}
        if sel_labels.size == 0:
            return np.zeros(0, np.int64), np.zeros((0, 7)), np.zeros(0), aux
        for v in range(2, self.num_classes - 1, 2):
            sel_labels[sel_labels == v] = v - 1
        nms_fn = nms_lib.get_nms_fn(self.use_box_merge, self.use_box_score)
        counts: Dict[str, int] = {}
        # the boxes are gathered in the sort as they come and converted
        # to float64 once, by the NMS
        class_labels, boxes_3d, out_scores, _ = nms_fn(
            sel_labels,
            sel_boxes,
            sel_probs,
            overlapped_fn=iou_lib.overlapped_boxes_3d,
            overlapped_thres=self.config["nms_overlapped_thres"],
            appr_factor=100.0,
            top_k=-1,
            counters=counts,
        )
        with self._time_lock:
            for key, val in counts.items():
                self.nms_counters[key] = self.nms_counters.get(key, 0) + val
        return class_labels, boxes_3d, out_scores, aux

    # ------------------------------------------------------------------
    def stream(self, frames, depth: int = 2, raw: bool = False,
               batch: int = 4, mesh=None):
        """Pipelined serving over an iterable of :class:`Points`.

        Yields ``(class_labels, boxes_3d, scores, aux)`` per frame, in
        order (with ``raw=True``: the device outputs as numpy arrays,
        without the host NMS tail).

        One background worker advances ``frames`` (the dataset IO),
        ``depth`` frames ahead.  The main thread computes each frame's
        overflow stats and packs it (on the worker, its numpy work and
        the main thread's took turns at the interpreter lock and slowed
        both), starts copying the packed frame to the device through
        pinned memory, runs
        ``device_fn`` (a CUDA graph replay on the card), starts copying
        its outputs and K1's pair counts back, and runs the host NMS of
        the previous frame while the card runs the current one: nothing
        before the NMS waits for the card, so the card computes frame i
        while the host finishes frame i - 1.  Frame i's counts are read
        with its outputs; a frame whose K1 pair list passed its capacity
        is computed again on exact pair lists (``_exact_outputs``)
        before its NMS.

        ``mesh`` (a :class:`~pointgnn_tpu_torch.parallel.mesh.Mesh`, whose
        ``devices`` serve, or a list of devices) serves data-parallel, as
        the JAX pipeline's ``stream(mesh=...)`` does: every device gets
        its own copy of the params (so a CUDA graph of its own, captured
        in its thread) and a thread that copies frames in, runs
        ``device_fn`` and starts copying outputs back; each serving
        batch of ``batch`` frames is dealt out as ``batch / len(mesh)``
        consecutive frames per device (``batch`` must divide), with no
        communication between devices.  The main thread runs the host
        NMS in input order.  Without ``mesh``, ``batch`` has no effect:
        the JAX pipeline batches frames to amortize its host-to-TPU put,
        while ``device_fn`` here runs one frame at a time and a packed
        frame's copy to the card is small.

        Buckets: ``gen graph`` (stats, packing and the copy to the
        device), ``gnn inference`` (``device_fn`` and the wait for
        its outputs), ``nms``.  Device-built graphs only, as in JAX."""
        if not self.on_device_graph:
            raise ValueError("stream() needs on_device_graph")
        devices = None if mesh is None else _mesh_devices(mesh)
        if devices is not None and batch % len(devices):
            raise ValueError("batch %d must divide over the %d-device mesh"
                             % (batch, len(devices)))
        it = iter(frames)

        def pull():
            # the background worker: the next frame (the dataset IO)
            for p in it:
                return p
            return None

        def run(params, host, device):
            """Copy one frame in, run ``device_fn`` and start copying its
            outputs and K1 counts to the host."""
            with torch.cuda.device(device) if device.type == "cuda" \
                    else contextlib.nullcontext():
                t0 = time.time()
                packed = self._to_device(host, device)
                t1 = time.time()
                self._add_time("gen graph", t1 - t0)
                outs = self.device_fn(params, packed)
                k1 = self._take_k1()
                done = None
                if device.type == "cuda":
                    outs = tuple(o.to("cpu", non_blocking=True)
                                 for o in outs)
                    if k1 is not None:
                        k1 = (k1[0].to("cpu", non_blocking=True), k1[1])
                    done = torch.cuda.Event()
                    done.record()
                self._add_time("gnn inference", time.time() - t1)
            return outs, k1, done, (params, packed)

        def finish(entry):
            t0 = time.time()
            if isinstance(entry, concurrent.futures.Future):
                entry = entry.result()
            outs, k1, done, (params, packed) = entry
            if done is not None:
                done.synchronize()
            if self._count_k1(k1):
                outs = self._exact_outputs(params, packed)
            row = tuple(o.numpy() for o in outs)
            t1 = time.time()
            self._add_time("gnn inference", t1 - t0)
            if raw:
                self.frames_done += 1
                return row
            result = self._finish_frame(*row)
            self._add_time("nms", time.time() - t1)
            return result

        with contextlib.ExitStack() as stack:
            pool = stack.enter_context(
                concurrent.futures.ThreadPoolExecutor(1))
            if devices is None:
                lag = 1  # frames whose outputs are in flight

                def submit(i, host):
                    return run(self.params, host, self.device)
            else:
                lag = batch
                per = batch // len(devices)
                copies = [_tree_to(self.params, d) for d in devices]
                # their CUDA graphs go with them, once the workers are done
                stack.callback(self._drop_graphs, copies)
                replicas = [
                    (params, d, stack.enter_context(
                        concurrent.futures.ThreadPoolExecutor(1)))
                    for params, d in zip(copies, devices)
                ]

                def submit(i, host):
                    params, device, worker = replicas[(i % batch) // per]
                    return worker.submit(run, params, host, device)

            pulls = collections.deque(
                pool.submit(pull) for _ in range(max(1, depth) + 1)
            )
            pending = collections.deque()
            count = 0
            while pulls:
                p = pulls.popleft().result()
                if p is None:
                    continue
                pulls.append(pool.submit(pull))
                t0 = time.time()
                host = self._pack(p)
                self._add_time("gen graph", time.time() - t0)
                pending.append(submit(count, host))
                count += 1
                while len(pending) > lag:
                    yield finish(pending.popleft())
            while pending:
                yield finish(pending.popleft())

    # ------------------------------------------------------------------
    def detections_to_kitti(self, class_labels, boxes_3d, scores, calib,
                            aux) -> List[Tuple]:
        """Project to 2D, clip, truncation-filter, occlusion-rescore;
        KITTI label tuples."""
        return detections_to_kitti_labels(
            self.label_method, class_labels, boxes_3d, scores, calib,
            aux, use_box_score=self.use_box_score,
        )

    def _write_kitti_txt(self, dataset, frame_idx, output_dir, pred_labels):
        filename = os.path.join(
            output_dir, "data", dataset.get_filename(frame_idx) + ".txt"
        )
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        with open(filename, "w") as f:
            f.write(format_kitti_lines(pred_labels))

    def _write_vis(self, dataset, frame_idx, output_dir, points, calib,
                   class_labels, boxes, pred_labels, is_test, level):
        """The visualization files of one frame (see :meth:`run_dataset`)."""
        from pointgnn_tpu_torch.utils import interactive, vis

        vis_dir = os.path.join(output_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        name = dataset.get_filename(frame_idx)
        vis.save_detection_image(
            dataset.get_image(frame_idx), pred_labels, calib,
            os.path.join(vis_dir, name + ".png"),
        )
        gt_boxes = None
        if not is_test:
            gt_boxes = [box_ops.label_to_box(label)
                        for label in dataset.get_label(frame_idx)
                        if label["name"] != "DontCare"]
        vis.plot_bev(points.xyz, boxes, gt_boxes,
                     path=os.path.join(vis_dir, name + "_bev.png"))
        if level >= 2:
            # one class name per box (the truncation filter may have
            # dropped some of them from pred_labels)
            names = ALL_CLASS_NAMES[self.label_method]
            interactive.vis_detections(
                points.xyz, boxes,
                names=[names[int(c)] for c in class_labels],
                save_path=os.path.join(vis_dir, name + "_3d.png"),
            )

    def run_dataset(
        self,
        dataset,
        output_dir: str,
        num_frames: int = -1,
        is_test: bool = False,
        verbose: bool = True,
        visualization_level: int = 0,
    ) -> Dict[str, float]:
        """Serve a :class:`KittiDataset` and write
        ``<output_dir>/data/<frame>.txt`` per frame: through
        :meth:`stream` on device-built graphs, else frame by frame with
        one ``default_rng(0)`` for the whole run, as in JAX.  Returns
        each bucket's time per frame: ``fetch input`` (reading the frame;
        on the stream's worker), ``gen graph``, ``gnn inference``,
        ``decode box`` (host graphs), ``nms`` and ``total`` (the wall
        time of the loop).

        ``visualization_level >= 1`` runs frame by frame through
        :meth:`run_frame` on either graph kind, as JAX does, and also
        writes ``<output_dir>/vis/<frame>.png`` (detections over the
        camera image) and ``<frame>_bev.png`` (the bird's-eye view with
        the detections, and the ground truth unless ``is_test``); level 2
        adds ``<frame>_3d.png`` (:func:`utils.interactive.vis_detections`:
        an Open3D render when it imports, else the headless view)."""
        n = dataset.num_files if num_frames < 0 else num_frames
        calibs, clouds = [], []

        def fetch(i):
            start = time.time()
            points = dataset.get_cam_points_in_image_with_rgb(
                i, self.config.get("downsample_by_voxel_size")
            )
            calibs.append(dataset.get_calib(i))
            if visualization_level >= 1:
                clouds.append(points)
            self._add_time("fetch input", time.time() - start)
            return points

        t_all = time.time()
        if self.on_device_graph and visualization_level == 0:
            results = self.stream(fetch(i) for i in range(n))
        else:
            rng = np.random.default_rng(0)
            results = (self.run_frame(fetch(i), rng) for i in range(n))
        for frame_idx, (cls, boxes, scores, aux) in enumerate(results):
            pred_labels = self.detections_to_kitti(
                cls, boxes, scores, calibs[frame_idx], aux
            )
            self._write_kitti_txt(dataset, frame_idx, output_dir, pred_labels)
            if visualization_level >= 1:
                self._write_vis(dataset, frame_idx, output_dir,
                                clouds[frame_idx], calibs[frame_idx], cls,
                                boxes, pred_labels, is_test,
                                visualization_level)
                clouds[frame_idx] = None
        self._add_time("total", time.time() - t_all)
        averages = {
            k: v / max(self.frames_done, 1) for k, v in self.time_dict.items()
        }
        if verbose:
            for k, v in averages.items():
                print("%s: %.3f ms/frame" % (k, 1e3 * v))
            for k, v in self.nms_counters.items():
                print("nms %s: %.1f/frame" % (k, v / max(self.frames_done, 1)))
            k1_frames = max(self.k1_counters.get("frames", 0), 1)
            for k, v in self.k1_counters.items():
                if k.endswith("_pairs"):
                    print("k1 %s: %.1f/frame" % (k, v / k1_frames))
                elif k != "frames":
                    print("k1 %s: %d" % (k, v))
            if "k1_pairs" in self.overflow_counters:
                print("k1 overflow redos: %d"
                      % self.overflow_counters["k1_pairs"])
        return averages
