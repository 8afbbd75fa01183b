"""A data-parallel dry run on tiny shapes (counterpart of
``__graft_entry__.dryrun_multichip``), and the rank bodies that it, the
CPU tests and ``chip_smoke.py`` launch.

A rank body is a module-level function ``fn(mesh, ...)`` that
:func:`~pointgnn_tpu_torch.parallel.mesh.launch` runs in every spawned
rank.  The bodies live here, in the package, so that a spawned rank
imports the port and nothing else.

A *case* is one data-parallel training run written down as a tree
(:func:`~pointgnn_tpu_torch.train.checkpoint.save_tree`): the model's
keyword arguments, the loss and optimizer configs, the parameters (the
JAX package's tree layout, numpy), the step's options, each rank's batch
(a padded graph's fields, or a stack of DeviceFrames with the device
graph's config and spec) and the number of steps.  :func:`replay` runs
it on one rank, or in one process without a mesh.
"""

import copy
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pointgnn_tpu_torch import configs
from pointgnn_tpu_torch.data.labels import LABEL_METHODS
from pointgnn_tpu_torch.graph import builder, pad
from pointgnn_tpu_torch.graph import device_builder as db
from pointgnn_tpu_torch.graph import device_labels as dl
from pointgnn_tpu_torch.infer import select_input_features
from pointgnn_tpu_torch.model.losses import loss_config
from pointgnn_tpu_torch.model.pointgnn import PointGNN
from pointgnn_tpu_torch.nn import mlp
from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
from pointgnn_tpu_torch.parallel import mesh as mesh_lib
from pointgnn_tpu_torch.parallel import step as step_lib
from pointgnn_tpu_torch.train import checkpoint as ckpt_lib
from pointgnn_tpu_torch.train import device_pipeline as dpipe
from pointgnn_tpu_torch.train import optimizers as opt_lib
from pointgnn_tpu_torch.utils.device import resolve_device
from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

SGD = {"initial_lr": 0.125, "decay_step": 400000, "decay_factor": 0.1,
       "optimizer": "sgd"}


def _to_numpy(tree):
    """Tensors and arrays of an aux dict as numpy (nested dicts kept)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _batch(entry, device, device_graph: bool):
    """One rank's batch of a case on ``device``."""
    if device_graph:
        packed, labels = entry
        return dpipe.frames_to_device(
            dpipe.DeviceFrame(packed, dl.PackedLabels(*labels)), device)
    return pad.to_device(pad.PaddedGraph(*entry), device)


def replay(mesh: Optional[mesh_lib.Mesh], case: Dict, device=None) -> Dict:
    """Run a case's steps: rank ``r`` of ``mesh`` on ``case["inputs"][r]``
    (without a mesh, one process on ``case["inputs"][0]``).  Returns the
    final parameters (numpy, the JAX tree layout) and every step's aux
    dict (numpy)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    model_kw = dict(case["model"])
    graph_builder = None
    gb = case.get("graph_builder")
    if gb is not None:
        dspec, extra = dpipe.resolve_device_setup(
            gb["config"], spec=gb["spec"], slab=gb["slab"])
        model_kw.update(extra)
    model = PointGNN(**model_kw)
    if gb is not None:
        graph_builder = dpipe.make_graph_builder(
            dspec, model.output_graph_level, gb["config"])
    params = params_from_jax(case["params"], device)
    for key, t in mlp.named_leaves(params):
        t.requires_grad_(key not in mlp.EMA_KEYS)
    optimizer, _ = opt_lib.build_from_train_config(case["optimizer"])
    state = step_lib.init_train_state(params, optimizer)
    step = step_lib.make_train_step(
        model, optimizer, case["loss"], graph_builder, mesh=mesh,
        **case["step"])
    batch = _batch(case["inputs"][0 if mesh is None else mesh.rank],
                   device, gb is not None)
    auxes = []
    for _ in range(case["steps"]):
        state, aux = step(state, batch)
        auxes.append(_to_numpy(aux))
    return {"params": params_to_numpy(state.params), "aux": auxes}


def run_cases(mesh: Optional[mesh_lib.Mesh], paths: List[str],
              device=None) -> List[Dict]:
    """:func:`replay` of each case saved at ``paths``, in order (a rank
    body)."""
    return [replay(mesh, ckpt_lib.load_tree(p), device) for p in paths]


def train_jobs(mesh: Optional[mesh_lib.Mesh], jobs: List[Dict],
               device=None) -> List[Dict]:
    """A rank body: each job builds a ``Trainer`` on this rank from its
    ``config``, ``train_config``, ``fetch_spec`` and ``num_frames``,
    restores the latest checkpoint when ``restore`` is set, trains its
    global ``batches`` (lists of frame indices) with ``train_batch``,
    and saves when ``save`` is set; a job with ``run`` set is
    ``train_torch.py``'s run instead (``trainer.run_training``, whose
    result it returns).  Returns per job: each step's total
    loss, valid endpoints (summed over the ranks) and wall time in ms
    (the card synchronized), the K1/K2 launches of every step, the
    parameters after the steps listed in ``snapshots`` and at the end
    (numpy), the step directory this rank wrote (None but on rank 0),
    and the peak device memory in bytes (on a card)."""
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.train.trainer import Trainer, run_training

    counters = (slab.slab_edge_max, slab.slab_edge_max_backward)
    out = []
    for job in jobs:
        if job.get("run"):
            out.append(run_training(mesh, job["config"], job["train_config"],
                                    job["fetch_spec"], job["num_frames"],
                                    device))
            continue
        trainer = Trainer(job["config"], job["train_config"],
                          job["fetch_spec"], num_frames=job["num_frames"],
                          device=device, mesh=mesh)
        cuda = trainer.device.type == "cuda"
        res = {"total_loss": [], "valid": [], "step_ms": [], "launches": [],
               "snapshots": {}, "saved": None}
        try:
            if job.get("restore"):
                trainer.restore()
            if cuda:
                torch.cuda.reset_peak_memory_stats(trainer.device)
            for i, batch in enumerate(job["batches"]):
                before = [fn.launches for fn in counters]
                t0 = time.perf_counter()
                aux = trainer.train_batch(list(batch))
                if cuda:
                    torch.cuda.synchronize(trainer.device)
                res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                res["launches"].append([fn.launches - b for fn, b in
                                        zip(counters, before)])
                res["total_loss"].append(float(aux["total_loss"]))
                res["valid"].append(float(aux["num_valid_endpoint"].sum()))
                if i + 1 in job.get("snapshots", ()):
                    res["snapshots"][i + 1] = copy.deepcopy(
                        params_to_numpy(trainer.state.params))
            if job.get("save"):
                res["saved"] = trainer.save()
            res["params"] = params_to_numpy(trainer.state.params)
            res["step"] = trainer.global_step
            res["peak_bytes"] = (torch.cuda.max_memory_allocated(
                trainer.device) if cuda else None)
        finally:
            trainer.close()
        out.append(res)
    return out


def same_params(results: List[Dict]) -> bool:
    """True when every rank ended with the same parameters, bit for
    bit."""
    first = opt_lib.param_leaves(params_from_jax(results[0]["params"],
                                                 "cpu"))
    for res in results[1:]:
        other = opt_lib.param_leaves(params_from_jax(res["params"], "cpu"))
        if len(other) != len(first) or not all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(first, other)):
            return False
    return True


def _host_case(rank: int) -> Dict:
    """The dry run's first phase, as JAX's: car T=1 with an l1
    regularizer on host-built graphs of synthetic frame ``rank`` (400
    points), random labels, sgd at lr 0.125, 3 steps."""
    cfg = configs.model_config("Car", T=1)
    cap = pad.GraphCapacity(vertices=(512, 256, 256), edges=(2048, 4096))
    points, _ = synthetic_lidar_frame(seed=rank, n_beams=8,
                                      points_per_beam=80)
    pts = points.xyz[:400]
    vcl, kil, el = builder.gen_multi_level_local_graph_v3(
        pts, **cfg["graph_gen_kwargs"], rng=np.random.default_rng(rank))
    rng = np.random.RandomState(rank)
    k = len(vcl[-1])
    labels = rng.randint(0, 4, (k, 1))
    frame = pad.FrameData(
        points.attr[:len(pts), :1].astype(np.float32), vcl, kil, el,
        cls_labels=labels,
        encoded_boxes=rng.rand(k, 1, 7).astype(np.float32),
        valid_boxes=(labels[:, :, None] == 1).astype(np.float32),
    )
    model = dict(num_classes=cfg["num_classes"], box_encoding_len=7,
                 layer_configs=cfg["model_kwargs"]["layer_configs"],
                 regularizer_type="l1", regularizer_kwargs={"scale": 5e-7},
                 mode="train")
    params = PointGNN(**model).init(0, 1, "cpu")
    inputs = [None] * (rank + 1)
    inputs[rank] = tuple(pad.pad_frame(frame, cap))
    return dict(model=model, loss=loss_config(cfg), optimizer=SGD, steps=3,
                params=params_to_numpy(params), inputs=inputs,
                step=dict(unify_copies=True))


def _device_case(rank: int) -> Dict:
    """The second phase: the device-graph pipeline (graph build, labels
    and box encoding inside the step; slab graphs, the kernels on a
    card) at 2048 points and 512 keypoints, one synthetic frame per
    rank, per-step graph randomization folded with the rank."""
    cfg = configs.model_config("Car", T=1)
    spec = db.spec_from_config(cfg, num_points=2048, num_keypoints=512,
                               runtime=False)
    label_map, num_classes = LABEL_METHODS[cfg["label_method"]]
    points, labels = synthetic_lidar_frame(seed=rank, n_beams=8,
                                           points_per_beam=80)
    packed = db.pack_points(
        points.xyz, select_input_features(points.attr,
                                          cfg["input_features"]),
        spec.num_points)
    frame = dpipe.stack_frames([dpipe.DeviceFrame(
        packed, dl.pack_frame_labels(labels, label_map, num_classes))])
    model = dict(num_classes=num_classes, box_encoding_len=7, mode="train",
                 **cfg["model_kwargs"])
    params = PointGNN(**model).init(0, 1, "cpu")
    inputs = [None] * (rank + 1)
    inputs[rank] = (frame.packed_points, tuple(frame.labels))
    return dict(model=model, loss=loss_config(cfg), optimizer=SGD, steps=3,
                params=params_to_numpy(params), inputs=inputs,
                graph_builder=dict(config=cfg, spec=spec, slab="auto"),
                step=dict(unify_copies=True, graph_rng_seed=0))


def dryrun_rank(mesh: mesh_lib.Mesh) -> Dict:
    """The dry run on one rank: each rank builds its own frame and
    replays both phases."""
    return {"host": replay(mesh, _host_case(mesh.rank)),
            "device": replay(mesh, _device_case(mesh.rank))}


def dryrun_multichip(n_devices: int, devices=None,
                     timeout: float = 600.0) -> Dict:
    """Data-parallel training steps over ``n_devices`` ranks on tiny
    shapes: 3 sgd steps on host-built graphs, then 3 through the
    device-graph pipeline, each rank on its own frame.  Checks that
    every loss is finite, that the loss moved (the optimizer state
    threads through), and that the ranks ended with the same parameters
    bit for bit.  ``devices`` as in ``launch`` (``cuda:r`` for rank r by
    default).  Returns the phases' losses and endpoint counts."""
    results = mesh_lib.launch(dryrun_rank, n_devices, devices=devices,
                              timeout=timeout, join_timeout=timeout)
    summary = {}
    for phase in ("host", "device"):
        runs = [r[phase] for r in results]
        losses = [float(a["total_loss"]) for a in runs[0]["aux"]]
        if not all(np.isfinite(losses)):
            raise FloatingPointError("dry run %s losses %s" % (phase,
                                                               losses))
        if losses[2] == losses[0]:
            raise AssertionError("dry run %s: the loss did not move: %s"
                                 % (phase, losses))
        if not same_params(runs):
            raise AssertionError("dry run %s: the ranks' parameters differ"
                                 % phase)
        endpoints = runs[0]["aux"][-1]["num_endpoint"]
        summary[phase] = {"losses": losses,
                          "endpoints": np.asarray(endpoints).tolist()}
        print("dryrun_multichip(%d) %s OK: losses=%s endpoints=%s"
              % (n_devices, phase, ["%.4f" % v for v in losses],
                 summary[phase]["endpoints"]))
    return summary
