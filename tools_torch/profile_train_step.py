#!/usr/bin/env python3
"""Stage-level latency attribution of the device-graph train step.

The counterpart of ``tools/profile_train_step.py`` for the port: where
does a car_auto_T3 device-graph step (one frame) go?  Stages, each
``reps`` calls between two CUDA events after a warm-up (the wall clock
on the CPU):

- ``chip_probe_tflops``: the bf16 matmul rate stamp of
  ``profile_inference.py``;
- ``graph_build_ms``: the randomized on-device graph build and label
  assignment (``train.device_pipeline.make_graph_builder``);
- ``forward_ms``: ``model.apply`` on a built graph without gradients
  (``slab_edge_max`` forward and the predictor);
- ``loss_ms``: forward and loss value;
- ``grad_ms``: loss and its gradients (adds the backward,
  ``slab_edge_max_backward`` among it);
- ``step_ms``: the whole step of ``parallel.step.make_train_step``
  (graph build, loss, backward, optimizer), chained as the loop chains
  it.

``attribution`` derives: graph_build, forward, loss_extra = loss -
forward, backward = grad - loss, opt_and_fixed = step - grad -
graph_build.  The settings are the JAX tool's: sgd, lr 0.125, weights
and graph randomization from seed 0.  Car's lr 0.125 diverges on this
synthetic frame within a few steps, so the later steps may carry NaNs:
``finite_loss_steps`` of ``steps`` counts the steps whose loss stayed
finite.

Usage:
    python tools_torch/profile_train_step.py [--label_method Car] \\
        [--T 3] [--reps 12] [--no_probe] [--json out.json] [--device cuda]
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def profile(cfg, reps=12, probe=True, device=None, spec=None):
    """The stage dict (see the module docstring) of ``cfg`` on one
    synthetic frame (``synthetic_lidar_frame(seed=0,
    points_per_beam=380)``); ``spec`` overrides the training graph spec
    that ``resolve_device_setup`` derives."""
    import warnings

    import torch

    from tools_torch.profile_inference import (device_rate_ms,
                                               matmul_probe_tflops)

    from pointgnn_tpu_torch.data.labels import LABEL_METHODS
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.graph import device_labels as dl
    from pointgnn_tpu_torch.infer import (input_feature_dim,
                                          select_input_features)
    from pointgnn_tpu_torch.model import encodings
    from pointgnn_tpu_torch.model.losses import loss_config
    from pointgnn_tpu_torch.model.pointgnn import get_model
    from pointgnn_tpu_torch.nn import mlp
    from pointgnn_tpu_torch.parallel import step as step_lib
    from pointgnn_tpu_torch.train import device_pipeline as dpipe
    from pointgnn_tpu_torch.train import optimizers
    from pointgnn_tpu_torch.utils.device import resolve_device
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    device = resolve_device(device)
    out = {}
    if probe:
        out["chip_probe_tflops"] = matmul_probe_tflops(device)

    dspec, model_extra = dpipe.resolve_device_setup(cfg, spec, slab=True)
    model = get_model(cfg["model_name"])(
        num_classes=cfg["num_classes"],
        box_encoding_len=encodings.get_encoding_len(
            cfg["box_encoding_method"]),
        mode="train", **model_extra, **cfg["model_kwargs"],
    )
    builder = dpipe.make_graph_builder(dspec, model.output_graph_level, cfg)
    params = model.init(0, input_feature_dim(cfg["input_features"]), device)
    # trainable leaves as the Trainer marks them (the batch norms' moving
    # averages are the step's, not the optimizer's)
    for key, t in mlp.named_leaves(params):
        t.requires_grad_(key not in mlp.EMA_KEYS)
    opt, _ = optimizers.build_from_train_config(
        {"initial_lr": 0.125, "decay_step": 400000,
         "decay_factor": 0.1, "optimizer": "sgd"}
    )
    state = step_lib.init_train_state(params, opt)
    step_fn = step_lib.make_train_step(
        model, opt, loss_config(cfg), graph_builder=builder,
        graph_rng_seed=0,
    )
    label_map, num_classes = LABEL_METHODS[cfg["label_method"]]
    pts, labels = synthetic_lidar_frame(seed=0, points_per_beam=380)
    feats = select_input_features(pts.attr, cfg["input_features"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        packed = db.pack_points(pts.xyz, feats, dspec.num_points)
    frame = dpipe.DeviceFrame(
        packed, dl.pack_frame_labels(labels, label_map, num_classes))
    batch = dpipe.frames_to_device(dpipe.stack_frames([frame]), device)
    one = dpipe.frames_to_device(frame, device)

    def rnd():
        return db.draw_randomization(
            dspec.num_points, step_lib.graph_generator(0, 0, 0, device))

    def rate(fn, *args):
        return device_rate_ms(fn, *args, reps=reps, device=device)

    with torch.no_grad():
        out["graph_build_ms"] = rate(lambda: builder(one, rnd()))
        graph = builder(one, rnd())
        out["forward_ms"] = rate(model.apply, params, graph)
        loss_fn = step_lib.make_loss_fn(model, loss_config(cfg))
        out["loss_ms"] = rate(lambda: loss_fn(params, graph)[0])
    leaves = [t for t in optimizers.param_leaves(params) if t.requires_grad]

    def grad():
        total, _ = loss_fn(params, graph)
        return torch.autograd.grad(total, leaves)

    out["grad_ms"] = rate(grad)

    losses = []

    def step():
        nonlocal state
        state, aux = step_fn(state, batch)
        losses.append(aux["total_loss"])

    out["step_ms"] = rate(step)
    losses = [float(v) for v in losses]
    out["steps"] = len(losses)
    out["finite_loss_steps"] = sum(1 for v in losses if math.isfinite(v))
    out["first_loss"] = losses[0]
    out["attribution"] = {
        "graph_build": out["graph_build_ms"],
        "forward": out["forward_ms"],
        "loss_extra": out["loss_ms"] - out["forward_ms"],
        "backward": out["grad_ms"] - out["loss_ms"],
        "opt_and_fixed": (out["step_ms"] - out["grad_ms"]
                          - out["graph_build_ms"]),
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="device-graph train step stage attribution")
    ap.add_argument("--label_method", default="Car")
    ap.add_argument("--T", type=int, default=3)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--no_probe", action="store_true")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from pointgnn_tpu_torch import configs

    cfg = configs.model_config(args.label_method, T=args.T)
    rep = profile(cfg, reps=args.reps, probe=not args.no_probe,
                  device=args.device)
    print(json.dumps(rep, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
