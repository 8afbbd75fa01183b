#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``pointgnn_tpu_torch``, never JAX) on the card:

1. prints the card's name and power limit and builds the CUDA kernel
   (``pointgnn_tpu_torch/csrc/slab_edge_max.cu``, nvcc, sm_90a);
2. holds ``slab_edge_max`` against its plain PyTorch version on the
   level-0 and level-1 slab metadata of a full-size car_auto_T3 frame
   (24576 points, 12288 keypoints) in bf16, and times both; also checks
   the f32 kernel at a small size;
3. serves 8 frames through ``InferencePipeline.run_frame`` at the full
   width of car_auto_T3 (random weights from seed 0), with the launch
   count reset just before and read just after: 4 launches per frame;
4. compares the model on the card with the same model on the CPU (the
   plain kernel version) on a small frame, in f32;
5. prints one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": ...}`` line.

Any failed phase raises, so the script exits non-zero without the last
line.  It exits non-zero at once when no CUDA device is visible or the
``pointgnn_tpu_torch`` package is not beside it.  The full report also
goes to ``chiprun_out/chip_smoke_report.json``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

NUM_POINTS, NUM_KEYPOINTS = 24576, 12288
FRAMES = 8
BF16_TOL = 2e-2  # |kernel - plain| <= tol * (1 + |plain|)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def time_ms(fn, runs, warmup=2):
    """Median device time of ``fn()`` over ``runs`` CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def slab_call_inputs(graph, level, spec, widths, seed, device):
    """Arguments of one slab_edge_max call on the frame's real slab
    metadata, with random tables and tail weights of the model's
    widths (``widths[0]`` = table width)."""
    import torch

    from pointgnn_tpu_torch.graph import device_builder as db

    gen = torch.Generator(device=device).manual_seed(seed)
    lvl_spec = spec.level0 if level == 0 else spec.level1
    wiring = db.slab_kernel_wiring(lvl_spec)
    if level == 0:
        src, smask = graph.vertex_xyz[0], graph.vertex_mask[0]
        offsets, cells = graph.slab0_offsets, graph.slab0_center_cell
    else:
        src, smask = graph.vertex_xyz[1], graph.vertex_mask[1]
        offsets, cells = graph.slab_offsets, graph.slab_center_cell
    ctr, cmask = graph.vertex_xyz[1], graph.vertex_mask[1]

    def xyz4(xyz, mask, sentinel):
        x4 = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], dim=1)
        return torch.where(mask[:, None] > 0, x4,
                           torch.full((), sentinel, device=device))

    h = widths[0]
    a = torch.randn(src.shape[0], h, generator=gen, device=device)
    b = torch.randn(ctr.shape[0], h, generator=gen, device=device)
    tail = []
    for din, dout in zip(widths[:-1], widths[1:]):
        w = torch.randn(din, dout, generator=gen, device=device) / din ** 0.5
        bias = 0.1 * torch.randn(dout, generator=gen, device=device)
        tail.append((w, bias))
    return dict(
        table_a=a, src_xyz=xyz4(src, smask, 1e6).contiguous(), table_b=b,
        ctr_xyz=xyz4(ctr, cmask, -1e6).contiguous(), offsets=offsets,
        center_cell=cells, weights=tail, grid_g=wiring["grid_g"],
        radius=wiring["radius"], halo=wiring["halo"],
    )


def bound(args, pairs, peak_flops):
    """Least time (ms) for one call: the larger of its unique bytes over
    the memory rate and its chain operations on the in-radius pairs
    over the peak rate."""
    h = args["table_a"].shape[1]
    flops = 2 * h  # relu(a - b)
    n_bytes = 0
    for w, b in args["weights"]:
        flops += 2 * w.shape[0] * w.shape[1] + 2 * w.shape[1]
        n_bytes += 4 * (w.numel() + b.numel())
    flops *= pairs
    h_out = args["weights"][-1][0].shape[1]
    k = args["table_b"].shape[0]
    for name in ("table_a", "src_xyz", "table_b", "ctr_xyz", "offsets",
                 "center_cell"):
        n_bytes += args[name].numel() * args[name].element_size()
    n_bytes += 4 * k * h_out
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes"
    ), flops, n_bytes


def kernel_phase(report, device):
    """Phase 2: kernel vs plain version at full car_T3 shapes."""
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    cfg = configs.model_config("Car", T=3)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )._replace(slab_level0=True, slab_level1=True)
    pts, _ = synthetic_lidar_frame(seed=100, points_per_beam=380)
    packed = torch.from_numpy(db.pack_points(
        pts.xyz, select_input_features(pts.attr, "i"), NUM_POINTS
    )).to(device)
    graph = db.build_padded_graph(*db.unpack_points(packed), spec)
    levels = {}
    for level, widths in ((0, [32, 64, 128, 300]), (1, [300, 300])):
        args = slab_call_inputs(graph, level, spec, widths, 10 + level,
                                device)
        kw = dict(args, compute_dtype="bfloat16")
        out = slab.slab_edge_max(**kw)
        torch.cuda.synchronize()
        ref = slab.slab_edge_max_reference(**kw)
        check(out.shape == ref.shape, "L%d: shape %s vs %s"
              % (level, tuple(out.shape), tuple(ref.shape)))
        check(bool(torch.isfinite(out).all()), "L%d: non-finite" % level)
        err = (out - ref).abs()
        rel = (err / (1.0 + ref.abs())).max().item()
        check(rel <= BF16_TOL, "L%d: kernel vs plain %.3g > %.3g"
              % (level, rel, BF16_TOL))
        pairs = slab.inradius_pair_count(
            args["src_xyz"], args["ctr_xyz"], args["offsets"],
            args["center_cell"], args["grid_g"], args["radius"],
            args["halo"],
        )
        ms = time_ms(lambda: slab.slab_edge_max(**kw), runs=20)
        plain_ms = time_ms(lambda: slab.slab_edge_max_reference(**kw),
                           runs=10, warmup=1)
        bound_ms, bound_by, flops, n_bytes = bound(args, pairs,
                                                   PEAK_BF16_FLOPS)
        levels["L%d" % level] = dict(
            P=args["table_a"].shape[0], K=args["table_b"].shape[0],
            widths=widths, grid_g=args["grid_g"], radius=args["radius"],
            inradius_pairs=pairs, max_abs_err=err.max().item(),
            max_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, flops=flops, bytes=n_bytes,
            nonzero_rows=int((out.abs().sum(1) > 0).sum()),
        )
        print("phase 2: L%d P=%d K=%d pairs=%d max_abs_err=%.3g "
              "rel=%.3g (tol %.3g) kernel %.3f ms plain %.3f ms "
              "bound %.4f ms (%s)"
              % (level, args["table_a"].shape[0], args["table_b"].shape[0],
                 pairs, err.max().item(), rel, BF16_TOL, ms, plain_ms,
                 bound_ms, bound_by), flush=True)
    report["levels"] = levels

    # f32 kernel at a small size: the first 2048 keypoints of level 1
    small = slab_call_inputs(graph, 1, spec, [64, 64], 20, device)
    k_small = 2048
    for name in ("table_a", "src_xyz", "table_b", "ctr_xyz"):
        small[name] = small[name][:k_small].contiguous()
    small["center_cell"] = small["center_cell"][:k_small].contiguous()
    # rows past k_small are dropped: offsets must not point beyond them
    small["offsets"] = torch.clamp(small["offsets"], max=k_small)
    ref32 = slab.slab_edge_max_reference(**small, compute_dtype="float32")
    out32 = slab.slab_edge_max(**small, compute_dtype="float32")
    out16 = slab.slab_edge_max(**small, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    e32 = ((out32 - ref32).abs() / (1 + ref32.abs())).max().item()
    e16 = ((out16 - ref32).abs() / (1 + ref32.abs())).max().item()
    check(e32 <= 1e-4, "f32 kernel vs f32 plain: %.3g > 1e-4" % e32)
    # bf16 tables and weights carry 2^-8 relative rounding each
    check(e16 <= 5e-2, "bf16 kernel vs f32 plain: %.3g > 5e-2" % e16)
    report["small_f32"] = dict(K=k_small, f32_vs_plain_f32=e32,
                               bf16_vs_plain_f32=e16)
    print("phase 2: small K=%d f32 kernel vs f32 plain %.3g (tol 1e-4); "
          "bf16 kernel vs f32 plain %.3g (tol 5e-2)" % (k_small, e32, e16),
          flush=True)


def serving_phase(report, device):
    """Phase 3: full-width car_auto_T3 serving through run_frame."""
    import numpy as np

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    cfg = configs.model_config("Car", T=3)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )
    pipe = InferencePipeline(cfg, device_spec=spec, compute_dtype="bfloat16",
                             seed=0, device=device)
    frames = [synthetic_lidar_frame(seed=i, points_per_beam=380)[0]
              for i in range(FRAMES)]
    pipe.run_frame(synthetic_lidar_frame(seed=100, points_per_beam=380)[0])
    pipe.time_dict.clear()
    buckets = {}
    detections = []
    slab.slab_edge_max.launches = 0
    t_all = time.perf_counter()
    for pts in frames:
        before = dict(pipe.time_dict)
        cls, boxes, scores, aux = pipe.run_frame(pts)
        for key, val in pipe.time_dict.items():
            buckets.setdefault(key, []).append(
                1e3 * (val - before.get(key, 0.0))
            )
        check(boxes.ndim == 2 and boxes.shape[1:] == (7,),
              "boxes shape %s" % (boxes.shape,))
        check(len(cls) == len(scores) == len(boxes), "ragged detections")
        check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
              "non-finite detections")
        check(set(np.unique(cls).tolist()) <= {1}, "unfolded classes")
        detections.append(int(len(cls)))
    wall = time.perf_counter() - t_all
    launches = slab.slab_edge_max.launches
    check(launches == 4 * FRAMES,
          "slab_edge_max launched %d times over %d frames, want %d"
          % (launches, FRAMES, 4 * FRAMES))
    med = {k: statistics.median(v) for k, v in buckets.items()}
    report["serving"] = dict(
        frames=FRAMES, launches=launches, detections=detections,
        median_ms=med, wall_ms_per_frame=1e3 * wall / FRAMES,
        overflow=pipe.overflow_counters,
    )
    print("phase 3: %d frames, slab_edge_max launches %d (4/frame), "
          "median ms per frame %s, detections %s, wall %.1f ms/frame"
          % (FRAMES, launches,
             {k: round(v, 3) for k, v in med.items()}, detections,
             1e3 * wall / FRAMES), flush=True)
    return launches


def cpu_parity_phase(report, device):
    """Phase 4: full-width model on the card vs on the CPU, small frame,
    f32, same parameters."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    cfg = configs.model_config("Car", T=3)
    spec = db.spec_from_config(cfg, num_points=2048, num_keypoints=1024)
    pts, _ = synthetic_lidar_frame(seed=5, n_beams=32, points_per_beam=64)
    outs = {}
    params = None
    for dev in (device, torch.device("cpu")):
        pipe = InferencePipeline(
            cfg, params=params, device_spec=spec, compute_dtype="float32",
            seed=1, device=dev,
        )
        if params is None:
            params = params_from_jax(params_to_numpy(pipe.params), "cpu")
        packed = torch.from_numpy(db.pack_points(
            pts.xyz, pts.attr[:, :1], spec.num_points
        )).to(dev)
        with torch.inference_mode():
            graph = db.build_padded_graph(*db.unpack_points(packed),
                                          pipe.device_spec)
            logits, enc = pipe.model.apply(pipe.params, graph)
        outs[dev.type] = [t.cpu().numpy() for t in (
            graph.slab0_offsets, graph.slab_offsets,
            graph.slab_center_cell, graph.keypoint_indices[0],
            torch.softmax(logits, -1), enc,
        )]
    g, c = outs["cuda"], outs["cpu"]
    for i, name in enumerate(("slab0_offsets", "slab_offsets",
                              "slab_center_cell", "keypoint_indices")):
        check(np.array_equal(g[i], c[i]), "graph %s differs" % name)
    # f32 on both devices, other summation orders (no TF32): 1e-3
    dp = float(np.abs(g[4] - c[4]).max())
    de = float(np.abs(g[5] - c[5]).max())
    check(dp <= 1e-3 and de <= 1e-3,
          "cuda vs cpu model: probs %.3g enc %.3g > 1e-3" % (dp, de))
    report["cpu_parity"] = dict(probs_max_abs=dp, enc_max_abs=de)
    print("phase 4: cuda vs cpu (f32, 1024 keypoints): graph bitwise "
          "equal, probs %.3g enc %.3g (tol 1e-3)" % (dp, de), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from pointgnn_tpu_torch.nn import slab
    except ImportError as exc:
        print("chip_smoke: the pointgnn_tpu_torch package is missing "
              "beside this script (%s)" % exc, file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    path, build_s, log = slab.build_kernel()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    report["build"] = dict(seconds=build_s, ptxas=ptxas, cached=not log)
    print("phase 1: %s %s in %.1f s" % (
        "found cached" if not log else "built", os.path.basename(path),
        build_s))
    for ln in ptxas:
        print("  " + ln)

    kernel_phase(report, device)
    launches = serving_phase(report, device)
    cpu_parity_phase(report, device)

    lv = report["levels"]
    n_l1 = 3  # car_auto_T3: one level-0 and three level-1 launches
    per_frame = lambda key: lv["L0"][key] + n_l1 * lv["L1"][key]  # noqa: E731
    # the frame's bound is the sum of its launches' bounds; name the
    # limit of the level that contributes most of it
    share = {"L0": lv["L0"]["bound_ms"], "L1": n_l1 * lv["L1"]["bound_ms"]}
    kernels = [{
        "name": "slab_edge_max",
        "route": "cuda",
        "source": "pointgnn_tpu_torch/csrc/slab_edge_max.cu",
        "replaces": "pointgnn_tpu/nn/pallas_kernels.py:573",
        "launches": launches,
        "max_abs_err": max(lv["L0"]["max_abs_err"], lv["L1"]["max_abs_err"]),
        "ms": per_frame("ms"),
        "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": lv[max(share, key=share.get)]["bound_by"],
        "library_ms": None,
        "per_launch": {
            key: {k: lv[key][k] for k in (
                "inradius_pairs", "ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")}
            for key in ("L0", "L1")
        },
    }]
    report["kernels"] = kernels
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
