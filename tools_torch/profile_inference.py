#!/usr/bin/env python3
"""Stage-level latency profile of the device-graph serving program.

The counterpart of ``tools/profile_inference.py`` for the port, with the
JAX tool's keys:

- ``chip_probe_tflops``: the rate of a large bf16 ``torch.matmul``, kept
  as a stamp of the card's state beside the other numbers (no gate);
- ``put_ms``: one copy of a packed frame to the device, waited for;
- ``total_ms``: ``InferencePipeline.device_fn`` (graph build, network,
  softmax, top-k, box decode) per call; ``graph_ms``: the graph build
  alone; ``gnn_ms``: the network alone on a built graph; ``tail_ms``:
  the rest (``total - graph - gnn``); ``cold_frame_ms`` = ``put_ms +
  total_ms``;
- ``hbm_in_use_mb`` / ``hbm_limit_mb``: the device memory torch holds
  and the card's memory (CUDA only).

Each stage is ``reps`` calls between two CUDA events after one warm-up
call (wall clock on the CPU).  No stage waits for the card
(``slab_edge_max`` keeps its pair counts on the card, as serving runs
it), so these are pipelined rates, as the JAX tool's are: ``total_ms``
replays the program's CUDA graph on a card, ``graph_ms`` and ``gnn_ms``
launch their stages' kernels from Python.

Usage:
    python tools_torch/profile_inference.py [--label_method Car] [--T 3] \\
        [--num_points 24576] [--num_keypoints 12288] [--reps 16] \\
        [--no-probe] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def device_rate_ms(fn, *args, reps=16, device=None):
    """ms per call of ``fn(*args)`` over ``reps`` calls after a warm-up:
    CUDA events around the calls on a card, the wall clock on the CPU."""
    import torch

    fn(*args)
    if device is not None and torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1e3


def matmul_probe_tflops(device, n=4096, reps=10):
    """TFLOP/s of an ``n`` x ``n`` bf16 matmul on ``device``."""
    import torch

    a = torch.randn(n, n, device=device).to(torch.bfloat16)
    b = torch.randn(n, n, device=device).to(torch.bfloat16)
    ms = device_rate_ms(torch.matmul, a, b, reps=reps, device=device)
    return 2.0 * n ** 3 / (ms * 1e-3) / 1e12


def profile(config, spec=None, reps=16, probe=True, device=None):
    """The stage dict of ``config`` (see the module docstring) on one
    synthetic frame (``synthetic_lidar_frame(seed=0,
    points_per_beam=380)``), random weights from seed 0."""
    import warnings

    import torch

    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import (InferencePipeline,
                                          select_input_features)
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.utils.device import resolve_device
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    device = resolve_device(device)
    if spec is None:
        spec = db.spec_from_config(
            config, num_points=24576, num_keypoints=12288,
            per_center_caps=(32, 192),
        )
    pipe = InferencePipeline(
        config, on_device_graph=True, use_box_score=False,
        device_spec=spec, device=device,
    )
    spec = pipe.device_spec
    pts, _ = synthetic_lidar_frame(seed=0, points_per_beam=380)
    feats = select_input_features(pts.attr, config["input_features"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        packed_host = torch.from_numpy(
            db.pack_points(pts.xyz, feats, spec.num_points))
    cuda = device.type == "cuda"

    out = {}
    if probe:
        out["chip_probe_tflops"] = matmul_probe_tflops(device)

    def put():
        packed = packed_host.to(device)
        if cuda:
            torch.cuda.synchronize(device)
        return packed

    put()  # warm the copy path
    t0 = time.perf_counter()
    for _ in range(4):
        packed = put()
    out["put_ms"] = (time.perf_counter() - t0) / 4 * 1e3

    with torch.inference_mode():
        total = device_rate_ms(pipe.device_fn, pipe.params, packed,
                               reps=reps, device=device)

        def build(p):
            return db.build_padded_graph(*db.unpack_points(p), spec)

        graph_ms = device_rate_ms(build, packed, reps=reps, device=device)
        graph = build(packed)
        with slab.pair_counts():  # K1 as serving runs it: no sync
            gnn_ms = device_rate_ms(pipe.model.apply, pipe.params, graph,
                                    reps=reps, device=device)
    out.update(
        total_ms=total,
        graph_ms=graph_ms,
        gnn_ms=gnn_ms,
        tail_ms=total - graph_ms - gnn_ms,
        cold_frame_ms=out["put_ms"] + total,
    )
    if cuda:
        out["hbm_in_use_mb"] = torch.cuda.memory_allocated(device) / 2 ** 20
        out["hbm_limit_mb"] = (torch.cuda.get_device_properties(device)
                               .total_memory / 2 ** 20)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="device-graph serving stage profile"
    )
    parser.add_argument("--label_method", default="Car")
    parser.add_argument("--T", type=int, default=3)
    parser.add_argument("--num_points", type=int, default=24576)
    parser.add_argument("--num_keypoints", type=int, default=12288)
    parser.add_argument("--reps", type=int, default=16)
    parser.add_argument(
        "--no-probe", action="store_true",
        help="skip the matmul rate stamp",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu runs the plain versions)")
    args = parser.parse_args(argv)

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.graph import device_builder as db

    config = configs.model_config(args.label_method, T=args.T)
    spec = db.spec_from_config(
        config, num_points=args.num_points,
        num_keypoints=args.num_keypoints, per_center_caps=(32, 192),
    )
    out = profile(config, spec, reps=args.reps, probe=not args.no_probe,
                  device=args.device)
    out["label_method"] = args.label_method
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
