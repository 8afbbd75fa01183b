#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``pointgnn_tpu_torch``, never JAX) on the card:

1. prints the card's name and power limit, builds the host library
   (merge-NMS and PNG row unfiltering, ``pointgnn_tpu_torch/csrc/host/``,
   the host C++ compiler), the KITTI AP evaluator
   (``csrc/host/evaluate_object.cpp``) and the CUDA kernels
   (``pointgnn_tpu_torch/csrc/slab_edge_max.cu``,
   ``slab_edge_max_bwd.cu``, ``edge_tail_max.cu`` and
   ``fused_edge_max.cu``, one nvcc each, started together, sm_90a), with
   each kernel's registers, stack and spills as ptxas reports them;
2. holds ``slab_edge_max`` (K1) against its plain PyTorch version on the
   level-0 and level-1 slab metadata of a full-size car_auto_T3 frame
   (24576 points, 12288 keypoints) in bf16, and times both; holds the
   kernel-built pair list of each level (the work plan of K1 and K2)
   equal to the plain enumeration and prints its pair count, chunk count
   and heaviest center block, and each call's device time by CUDA kernel
   (torch.profiler); also checks the f32 kernel at a small size;
3. serves 8 frames through ``InferencePipeline.run_frame`` at the full
   width of car_auto_T3 (random weights from seed 0), with the launch
   count reset just before and read just after: 4 launches per frame;
4. compares the model on the card with the same model on the CPU (the
   plain kernel version) on a small frame, in f32;
5. holds ``slab_edge_max_backward`` (K2) against its plain version at
   the full training shapes of a randomized car_auto_T3 training graph
   (32768 points, 12288 keypoints), f32, runs it twice to show bitwise
   reproducible gradients, checks the pair list as phase 2 does and the
   winners exactly (with a cotangent of ones the last bias gradient
   counts each channel's winner entries, at least its positive
   outputs), and times K1 and K2 in f32 beside their plain versions,
   with their device time by CUDA kernel;
6. trains car_auto_T3 at full width and depth through ``make_train_step``
   (sgd, lr 0.125, batch 4 on one card, per-step graph randomization,
   random weights from seed 0): one warm-up step, then 3 timed steps
   with the launch counts reset just before and read just after (16 K1
   and 16 K2 launches per step), then one step split into K1, K2 and
   the rest with CUDA events;
7. compares one union step's loss and every parameter gradient on the
   card (the kernels) with the CPU (the plain versions) at a reduced
   capacity with the same injected graph randomization, and also with
   the card running the plain slab versions, to tell the kernels' share
   of the gap from the rest of the card's f32 path;
8. holds ``edge_tail_max`` (K3) and ``fused_edge_max`` (K4) against
   their plain versions on the inputs the edge-list model gives them on
   the seed-100 frame (capped radius edge lists, per-center caps 32 / 192
   as ``bench.py:423-426``), level 0 and the first level-1 layer, in bf16,
   K4 against K3 bitwise, two K3 runs bitwise, both in f32 at a small
   size, and the kernel-built valid-slot pair lists (the kernels' work
   plan) equal to the plain ones; prints the valid pairs and chunks,
   times both kernels, the row gather ``A[min(src, N-1)]`` alone, and
   K3's device time by CUDA kernel (pair list vs chain), and whether K4
   beats the gather and K3 together (why the layers call K4);
9. serves 8 frames through ``run_frame`` on the edge-list path
   (``slab=False``, full width, random weights from seed 0) with the
   launch counts reset just before and read just after: 4 K4 launches
   and no K1 or K3 per frame; then 2 frames with ``slab="l1"``: 1 K4 and
   3 K1 launches per frame; then splits one edge-list frame's device
   program by torch.profiler into ``radius_edges``, the rest of the
   graph build, the edge-list tail (K4 and its slot mask) and the rest
   of the network, and by CUDA kernel;
10. compares the edge-list model on the card with the CPU on a small
    frame, in f32: edge lists bitwise, outputs within 1e-3;
11. serves a synthetic KITTI tree (8 frames at the tool's size,
    ``utils/synthetic_kitti.py``) with ``run_torch.py --fast`` in a
    subprocess, as a user does, from a port checkpoint of car_auto_T3 at
    full width (random weights from seed 0): exit 0, one label file per
    frame, every line 16 fields with a class of the config's label map,
    4 K1 launches a frame (the CLI prints its launch counts); prints
    ``run_dataset``'s buckets per frame and the ratio of ``total`` to the
    sum of the others (``stream`` overlaps them); then, on frame 0 at
    the CLI's spec (32768 points, 16384 keypoints), holds every K1 launch
    of one ``device_fn`` against the plain version on the inputs the
    model gives it (``BF16_TOL``; level 0's and level 1's pair lists
    against the plain enumeration), times the packed frame's copy to the
    card and the PNG decode of the frame's image written with each row
    filter, times how much of the device program is left when
    ``device_fn`` returns (K1 reads its pair count on the host), and
    holds the native merge-NMS against the numpy loop in all four
    variants (classes equal, boxes within 1e-12, scores rtol 1e-7),
    printing both times; serves the tree again in-process, warm, and
    checks that it writes the CLI's files;
12. trains from the command line: ``train_torch.py`` in a subprocess on
    a synthetic KITTI tree (8 frames with Car, Pedestrian and Cyclist),
    car_auto_T3 at full width and depth for 4 steps (2 provider workers,
    the shipped augmentation, a checkpoint every epoch; lr 0.0125, since
    the shipped 0.125 diverges on this tree), then resumed from step 4 to
    6, then ped_cyl_auto_T3 for 2 steps: exit 0, 16 K1 and 16 K2
    launches a step (the CLI prints its counts), a finite loss every
    step, the checkpoint of the last step; in this process, prints the
    shipped lr's loss over 6 car steps and one car step split into K1,
    K2 and the rest; then one ped_cyl step with every K1/K2 call
    captured: K1 (in the step and relaunched) bitwise equal to the plain
    forward in f32, K2 within ``BWD_TOL``, each frame's pair lists equal
    to the plain enumeration, and K1/K2 timed at ped_cyl's shapes beside
    their bounds; prints the median step time after the first step, the
    time the loop waited for its prefetched batch, and the host fetch
    time per frame;
13. evaluates and scores: ``eval_torch.py`` in a subprocess over phase
    12's car_auto_T3 checkpoints (steps 2, 4, 6) on its tree: exit 0, one
    summary per checkpoint, a finite ``total_loss``, 4 K1 launches a
    frame and no K2 (the CLI prints its counts), frames per second; in
    this process, every K1 call of one eval step on a tree frame at the
    training spec (32768 points, 12288 keypoints, f32) bitwise equal to
    the plain forward (in the step and relaunched), the level-0 and
    level-1 pair lists equal to the plain enumeration, and K1 timed
    beside its bound; one eval step on the card against the CPU (8192
    points, 2048 keypoints): loss terms within ``EVAL_TOL`` of the CPU's,
    metric counts equal; then ``smoke_train_eval_torch.py
    --device_graph`` in a subprocess (Car T=1, 14 frames, 2394 steps at
    batch 1 on device-built graphs, then ``Evaluator``, ``run_dataset``
    on host-built and on device-built graphs and the AP evaluator): exit 0
    with BEV moderate AP >= 85 on both passes; prints every AP line, the
    steps per second, each stage's wall time, ``run_dataset``'s buckets
    and the KITTI conversion per frame of each pass with the trained
    weights;
14. host-built graphs, where no hand-written kernel runs: serves a tree
    of phase 11's recipe from a car_auto_T3 checkpoint (random weights
    from seed 0) with ``run_torch.py`` without ``--fast`` in a subprocess
    (exit 0, one label file per frame, 16 fields a line, every launch
    count 0; prints the buckets per frame); in this process, frame 0 at
    the runtime capacity: ``gen graph`` split into voxel downsampling,
    radius search, padding and the copy to the card, the native radius
    search against the plain numpy one on each level (the same pairs but
    for ones on the radius boundary, where float64 and float32 distances
    disagree), the device program's time (CUDA events) and peak device
    memory, and the program on the card against the CPU at 8192 points
    (one graph fed to both, f32, ``HOST_TOL``); ``train_torch.py`` with
    ``"device_graph": false`` on a tree of phase 12's recipe (car_auto_T3,
    4 steps at batch 2, lr 0.0125, 2 provider workers: exit 0, a finite
    loss every step, no K1 or K2 launch; prints the median step after the
    first, the loop's wait and the worker's fetch per frame, timed here);
    one such step in this process, its wall time against the card's busy
    time by kernel (torch.profiler) and its batch's preparation;
    ``eval_torch.py`` over that run's checkpoints (frames/s, capacity
    growth); then ``smoke_train_eval_torch.py`` at its defaults, the host
    recipe (Car T=1, 14 frames, 1200 steps at batch 2 on host-built
    graphs, both serving passes): exit 0 with BEV moderate AP >= 85 on
    both passes; prints every AP line;
15. edge-list training and the model options, where no hand-written
    kernel runs: ``train_torch.py`` with ``"device_graph_slab": false``
    on a tree of phase 12's recipe (car_auto_T3 at full width and depth,
    batch 4, lr 0.0125, 4 steps, then resumed to 6: exit 0, a finite loss
    every step, no K1 or K2 launch, the frozen train_config reads
    ``false``; the median step after the first and the loop's wait);
    one such step in this process (every kernel's launches 0, peak device
    memory, wall against device busy time); ``eval_torch.py`` over its
    checkpoints (frames/s, a finite eval loss); one edge-list union step
    on the card against the CPU (4096 points, full width, the same
    randomization: losses within ``EDGE_LOSS_TOL``, every gradient within
    ``GRAD_TOL`` of ``(1 + max|g|)``); car_auto_T3 at width 300 with
    every MLP normalized by ``fused_BN_center`` trained through
    ``Trainer`` on host-built graphs (batch 1, 3 steps: ms a step, peak
    device memory under ``BN_PEAK_GIB``, the largest change of a moving
    average), then one frame served in test mode on a device-built graph
    (slab and tail resolve off); instance norm, each of the six box
    codecs and the separated predictor: one forward and box decode on a
    host graph card against CPU (``HOST_TOL``);
16. data parallelism (``parallel/mesh.py``, one process per rank): (a)
    two ranks train car_auto_T3 at full width and depth through
    ``Trainer`` on a 4-frame synthetic tree, batch 4 (2 frames a rank,
    no augmentation, no graph randomization), gloo on this card twice
    (NCCL over two cards when there are two): 1 warm-up and 3 timed
    steps, 8 K1 and 8 K2 launches per rank per step (counted in the
    ranks), the median ms a step and the peak device memory of each
    rank, the parameters of the two ranks equal to the bit, and the
    first step against one process training the union of the same 4
    frames (the update within ``DP_UNION_TOL`` of (lr + max|update|),
    the loss within 1e-5); (b) NCCL at world size 1 bitwise the step
    without a mesh (car_auto_T3, 2 frames); (c) ``stream`` sharded over
    the two ranks' devices against ``stream`` on 8 synthetic frames
    (``DP_STREAM_TOL``, 4 K1 launches a frame); (d)
    ``parallel.dryrun.dryrun_multichip(2)`` on those devices;
17. the rest of the serving surface and the tools: (a) ``run_torch.py
    --fast -l 2`` over 2 frames of a synthetic KITTI tree and
    ``run_torch.py -l 1`` (host graphs) over 1 frame, in subprocesses:
    every vis PNG decodes (``data/png.py``) at the camera image's or the
    canvas's shape, the detection image differs from the camera image,
    the KITTI text is byte-equal to ``run_dataset`` without
    visualization, 4 K1 launches a frame on the fast run and none on the
    host run; (b) ``tools_torch/profile_inference.py`` on car_auto_T3
    at 24576 / 12288 points (every stage, 8 K1 launches a rep); (c)
    ``tools_torch/profile_train_step.py`` at full width and depth (sgd,
    lr 0.125, weights from seed 0): every stage, the attribution, the
    finite-loss steps, 16 K1 and 8 K2 launches a rep; (d)
    ``tools_torch/tune_slab_kernels.py``'s sweep over the default and
    ``block_centers`` 16 and 64 on 4 frames: raw outputs bitwise equal
    to the default's, ms a frame each; the phase's seconds;
18. prints one ``{"kernels": [...]}`` line and, last, the
    ``{"ok": true, "device": ...}`` line.

Any failed phase raises, so the script exits non-zero without the last
line.  It exits non-zero at once when no CUDA device is visible or the
``pointgnn_tpu_torch`` package is not beside it.  The full report also
goes to ``chiprun_out/chip_smoke_report.json``.
"""

import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores (no TF32)
# f32-accurate products on the tensor cores as split TF32 (three TF32
# products each): 495 / 3 TFLOP/s; reported beside the f32 bound
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12

NUM_POINTS, NUM_KEYPOINTS = 24576, 12288
FRAMES = 8
BF16_TOL = 2e-2  # |kernel - plain| <= tol * (1 + |plain|)
# K3/K4 vs their plain versions in bf16: both round at the same points,
# so they may differ only where an f32 sum in another order flips a
# bf16 rounding
TAIL_MAX_ULPS = 2
TRAIN_STEPS = 3
# K2 vs plain, per gradient tensor: |kernel - plain| <= tol * (1 + max
# |plain|).  f32 sums of the same products in other orders (the plain
# dW is a cuBLAS product over all pairs, the kernel sums per CTA and
# then over CTAs); winners agree when K1 and the plain forward agree.
BWD_TOL = 1e-4
# one train step's gradients, card vs CPU: f32 through the whole model
# and loss, every sum in another order on each device
GRAD_TOL = 1e-3


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def kernel_wrappers():
    """The launch-counting wrapper of every kernel, by kernel name."""
    from pointgnn_tpu_torch.nn import edge_tail, slab

    return {"slab_edge_max": slab.slab_edge_max,
            "slab_edge_max_backward": slab.slab_edge_max_backward,
            "edge_tail_max": edge_tail.edge_tail_max,
            "fused_edge_max": edge_tail.fused_edge_max}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bf16_ulps(out, ref):
    """Largest |out - ref| in bf16 ulps of |ref| (a zero counts as the
    smallest normal)."""
    import torch

    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return ((out - ref).abs() / ulp).max().item()


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


def kernel_split(fn, calls=3):
    """Device ms per call of ``fn()`` by CUDA kernel (torch.profiler,
    self device time, averaged over ``calls``), largest first: where a
    wrapper's time goes among the kernels and torch ops it launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            name = kernel_name(ev.key)
            split[name] = split.get(name, 0.0) + us / 1e3 / calls
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def kernel_name(key):
    """"void ns::(anonymous namespace)::f<a::b, 1>(params)" -> "f<a::b,
    1>": the return type, the parameters and the namespaces at template
    depth 0 dropped."""
    key = re.sub(r"^void ", "", key.replace("(anonymous namespace)::", ""))
    depth, cut, start = 0, len(key), 0
    for i, ch in enumerate(key):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == "(":
            cut = i
            break
        elif depth == 0 and key.startswith("::", i):
            start = i + 2
    return key[start:cut]


def short_split(split):
    """A kernel split for printing: long template names cut, ms rounded."""
    out = {}
    for name, ms in split.items():
        if len(name) > 40 and "<" in name:
            name = name[:name.index("<")] + "<...>"
        out[name] = round(out.get(name, 0.0) + ms, 4)
    return out


def ptxas_kernels(log):
    """``{kernel: "R registers, stack S B, spill stores/loads A/B B"}`` from
    ``nvcc -Xptxas -v`` output, kernel names demangled where ``c++filt``
    is installed."""
    rows, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            rows[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            rows[name]["stack"] = "stack %s B, spill stores/loads %s/%s B" \
                % m.groups()
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows[name]["regs"] = "%s registers" % m.group(1)
    names = list(rows)
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [kernel_name(n) for n in out.stdout.splitlines()]
    return {new: ", ".join(v for v in (rows[old].get("regs"),
                                       rows[old].get("stack")) if v)
            for new, old in zip(names, rows)}


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


def bound(args, pairs, peak_flops, winners=None):
    """Least time (ms) for one call: the larger of its unique bytes over
    the memory rate and the operations this run's data needs over the
    peak rate.  The forward runs the chain on every in-radius pair.
    The backward (``winners``: the winner entries and winning pairs of
    ``slab.winner_counts``) recomputes the chain on every pair; only the
    winner entries carry a cotangent, so the last layer's dW, db and dy
    count on them alone, and the layers below (and the first
    activation's cotangent into both tables) on the winning pairs.  It
    also reads ``out`` and ``g`` and writes both table gradients and the
    weight gradients."""
    h = args["table_a"].shape[1]
    weights = args["weights"]
    flops = 2 * h  # relu(a - b)
    n_bytes = 0
    for w, b in weights:
        flops += 2 * w.shape[0] * w.shape[1] + 2 * w.shape[1]
        n_bytes += 4 * (w.numel() + b.numel()) * (1 if winners is None
                                                  else 2)
    flops *= pairs
    if winners is not None:
        entries, won_pairs = winners
        flops += entries * (4 * weights[-1][0].shape[0] + 1)
        lower = 2 * h  # d(relu(a - b)) into the A and B rows
        for w, _ in weights[:-1]:
            lower += 4 * w.shape[0] * w.shape[1] + 2 * w.shape[1]
        flops += won_pairs * lower
    h_out = weights[-1][0].shape[1]
    k = args["table_b"].shape[0]
    for name in ("table_a", "src_xyz", "table_b", "ctr_xyz", "offsets",
                 "center_cell"):
        n_bytes += args[name].numel() * args[name].element_size()
    n_bytes += 4 * k * h_out * (1 if winners is None else 2)
    if winners is not None:
        n_bytes += 4 * (args["table_a"].numel() + args["table_b"].numel())
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes"
    ), flops, n_bytes


def pair_list_check(args):
    """The kernel-built pair list of one call against the plain
    enumeration (``slab._inradius_pairs``): the same (k, j) set, grouped
    by center with rows ascending, the same on two runs.  Returns the pair
    count, the chunk count and the heaviest center block's pair count
    (the critical path of a kernel that gives each block one CTA)."""
    import torch

    from pointgnn_tpu_torch.nn import slab

    bk = slab.DEFAULT_BLOCK_CENTERS
    win_lo, win_hi = slab.column_row_windows(
        args["offsets"], args["center_cell"], args["grid_g"], bk,
        args["halo"])
    walk = (args["src_xyz"], args["ctr_xyz"], win_lo, win_hi, bk,
            args["radius"])
    row_ptr, pair_k, pair_j = slab.pair_list(*walk)
    again = slab.pair_list(*walk)
    check(all(torch.equal(x, y) for x, y in zip((row_ptr, pair_k, pair_j),
                                                again)),
          "the pair list differs between two runs")
    p = args["src_xyz"].shape[0]
    got = pair_k.to(torch.int64) * p + pair_j.to(torch.int64)
    want = torch.cat([k * p + j for k, j in slab._inradius_pairs(*walk)])
    check(torch.equal(got, torch.sort(want).values),
          "kernel pair list differs from the plain enumeration")
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    check(torch.equal(torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts),
        pair_k.to(torch.int64)), "pair list offsets do not match its centers")
    n, chunks, heaviest = slab.pair_stats(
        args["src_xyz"], args["ctr_xyz"], args["offsets"],
        args["center_cell"], args["grid_g"], args["radius"], args["halo"])
    check(n == pair_k.numel(), "pair_stats count differs")
    return dict(pairs=n, chunks=chunks, heaviest_block_pairs=heaviest,
                max_center_pairs=int(counts.max()) if n else 0)


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
        plist = pair_list_check(args)
        check(plist["pairs"] == pairs, "L%d: pair list %d vs %d pairs"
              % (level, plist["pairs"], pairs))
        print("phase 2: L%d pair list equals the plain enumeration: %d "
              "pairs, %d chunks of %d, heaviest block %d pairs, heaviest "
              "center %d" % (level, pairs, plist["chunks"], slab.PAIR_CHUNK,
                             plist["heaviest_block_pairs"],
                             plist["max_center_pairs"]), flush=True)
        ms = time_ms(lambda: slab.slab_edge_max(**kw), runs=20)
        plain_ms = time_ms(lambda: slab.slab_edge_max_reference(**kw),
                           runs=10, warmup=1)
        split = kernel_split(lambda: slab.slab_edge_max(**kw))
        bound_ms, bound_by, flops, n_bytes = bound(args, pairs,
                                                   PEAK_BF16_FLOPS)
        levels["L%d" % level] = dict(
            P=args["table_a"].shape[0], K=args["table_b"].shape[0],
            widths=widths, grid_g=args["grid_g"], radius=args["radius"],
            inradius_pairs=pairs, max_abs_err=err.max().item(),
            max_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, flops=flops, bytes=n_bytes,
            nonzero_rows=int((out.abs().sum(1) > 0).sum()), pair_list=plist,
            device_ms_by_kernel=split,
        )
        print("phase 2: L%d P=%d K=%d pairs=%d max_abs_err=%.3g "
              "rel=%.3g (tol %.3g) kernel %.3f ms plain %.3f ms "
              "bound %.4f ms (%s)"
              % (level, args["table_a"].shape[0], args["table_b"].shape[0],
                 pairs, err.max().item(), rel, BF16_TOL, ms, plain_ms,
                 bound_ms, bound_by), flush=True)
        print("  device ms per call by kernel: %s" % short_split(split),
              flush=True)
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
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    cfg = configs.model_config("Car", T=3)
    spec = db.spec_from_config(
        cfg, num_points=NUM_POINTS, num_keypoints=NUM_KEYPOINTS
    )
    pipe = InferencePipeline(cfg, on_device_graph=True, device_spec=spec,
                             compute_dtype="bfloat16",
                             seed=0, device=device)
    frames = [synthetic_lidar_frame(seed=i, points_per_beam=380)[0]
              for i in range(FRAMES)]
    pipe.run_frame(synthetic_lidar_frame(seed=100, points_per_beam=380)[0])
    pipe.time_dict.clear()
    buckets = {}
    detections = []
    reset_counts()
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
    counts = read_counts()
    launches = counts["slab_edge_max"]
    check(launches == 4 * FRAMES,
          "slab_edge_max launched %d times over %d frames, want %d"
          % (launches, FRAMES, 4 * FRAMES))
    check(counts["edge_tail_max"] == 0, "the slab path launched K3")
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
            cfg, on_device_graph=True, params=params, device_spec=spec,
            compute_dtype="float32",
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


def _flat_grads(res):
    return [res[0], res[1]] + [t for wb in res[2] for t in wb]


def _train_setup(device, spec=None, slab="auto"):
    """car_auto_T3 training as a Trainer resolves it on one card: the
    model in train mode with slab wiring (``slab=False``: on capped edge
    lists), its graph builder, the loss config and the train config."""
    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.model import encodings
    from pointgnn_tpu_torch.model.losses import loss_config
    from pointgnn_tpu_torch.model.pointgnn import PointGNN
    from pointgnn_tpu_torch.train import device_pipeline as dpipe

    cfg = configs.get_config("car_auto_T3_train")
    tcfg = configs.get_train_config("car_auto_T3_train")
    dspec, extra = dpipe.resolve_device_setup(cfg, spec, slab=slab)
    model = PointGNN(
        num_classes=cfg["num_classes"],
        box_encoding_len=encodings.get_encoding_len(
            cfg["box_encoding_method"]),
        mode="train", **extra, **cfg["model_kwargs"],
    )
    builder = dpipe.make_graph_builder(dspec, model.output_graph_level, cfg)
    return cfg, tcfg, dspec, model, builder, loss_config(cfg)


def _train_frames(cfg, dspec, seeds, device, lower_labels=False,
                  **frame_kw):
    """Synthetic frames with their labels, packed as DeviceFrames and
    stacked on the device.  The synthetic boxes sit above the points
    the generator carves for each car, so no point falls inside them;
    ``lower_labels`` sets each box on the ground (camera y = 1.74, the
    sensor 1.73 m up) so that its carved points, and the keypoints among
    them, get a localization target."""
    import warnings

    from pointgnn_tpu_torch.data.labels import LABEL_METHODS
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.graph import device_labels as dl
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.train import device_pipeline as dpipe
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    label_map, num_classes = LABEL_METHODS[cfg["label_method"]]
    frames = []
    for seed in seeds:
        pts, labels = synthetic_lidar_frame(seed=seed, **frame_kw)
        if lower_labels:
            labels = [dict(lb, y3d=1.74) for lb in labels]
        feats = select_input_features(pts.attr, cfg["input_features"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            packed = db.pack_points(pts.xyz, feats, dspec.num_points)
        frames.append(dpipe.DeviceFrame(
            packed, dl.pack_frame_labels(labels, label_map, num_classes)))
    return dpipe.frames_to_device(dpipe.stack_frames(frames), device)


def backward_kernel_phase(report, device):
    """Phase 5: K2 vs its plain version (and K1 in f32) at the full
    training shapes of one randomized car_auto_T3 training graph."""
    import torch

    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.parallel.step import graph_generator

    cfg, _, dspec, _, _, _ = _train_setup(device)
    batch = _train_frames(cfg, dspec, [100], device, points_per_beam=380)
    graph = db.build_padded_graph(
        *db.unpack_points(batch.packed_points[0]), dspec,
        rnd=db.draw_randomization(dspec.num_points,
                                  graph_generator(0, 0, 0, device)),
    )
    levels = {}
    for level, widths in ((0, [32, 64, 128, 300]), (1, [300, 300])):
        args = slab_call_inputs(graph, level, dspec, widths, 30 + level,
                                device)
        kw = dict(args, compute_dtype="float32")
        out = slab.slab_edge_max(**kw)
        gen = torch.Generator(device=device).manual_seed(40 + level)
        g = torch.randn(out.shape, generator=gen, device=device)
        got = slab.slab_edge_max_backward(**kw, out=out, g=g)
        again = slab.slab_edge_max_backward(**kw, out=out, g=g)
        torch.cuda.synchronize()
        ref_out = slab.slab_edge_max_reference(**kw)
        ref = slab.slab_edge_max_backward_reference(**kw, out=ref_out, g=g)
        fwd_err = (out - ref_out).abs().max().item()
        check(fwd_err <= 1e-4 * (1 + ref_out.abs().max().item()),
              "L%d: f32 K1 vs plain %.3g" % (level, fwd_err))
        names = ["d_table_a", "d_table_b"] + [
            "d_%s%d" % (kind, i) for i in range(len(widths) - 1)
            for kind in ("w", "b")
        ]
        errs = {}
        for name, x, y, z in zip(names, _flat_grads(got),
                                 _flat_grads(again), _flat_grads(ref)):
            check(x.shape == z.shape, "L%d %s shape" % (level, name))
            check(bool(torch.isfinite(x).all()),
                  "L%d %s non-finite" % (level, name))
            check(torch.equal(x, y),
                  "L%d %s differs between two runs" % (level, name))
            err = (x - z).abs().max().item()
            scale = z.abs().max().item()
            check(err <= BWD_TOL * (1 + scale),
                  "L%d %s: K2 vs plain %.3g > %.3g * (1 + %.3g)"
                  % (level, name, err, BWD_TOL, scale))
            errs[name] = dict(max_abs_err=err, max_abs_plain=scale)
        pairs = slab.inradius_pair_count(
            args["src_xyz"], args["ctr_xyz"], args["offsets"],
            args["center_cell"], args["grid_g"], args["radius"],
            args["halo"],
        )
        plist = pair_list_check(args)
        check(plist["pairs"] == pairs, "L%d: pair list %d vs %d pairs"
              % (level, plist["pairs"], pairs))
        # exact winners: with g = 1 the last bias gradient of a channel
        # counts its winner entries (exact in f32); every center with a
        # positive output has at least one, unless K2's recompute differs
        # from K1's forward
        ones = slab.slab_edge_max_backward(**kw, out=out,
                                           g=torch.ones_like(out))
        won = ones[2][-1][1]
        need = (out > 0).sum(0).to(torch.float32)
        check(bool((won >= need).all()),
              "L%d: %d channels lost winners (K2 recompute != K1 forward)"
              % (level, int((won < need).sum())))
        winner_check = dict(winner_entries=int(won.sum()),
                            positive_outputs=int(need.sum()))
        print("phase 5: L%d pair list equals the plain enumeration: %d "
              "pairs, %d chunks of %d, heaviest block %d pairs; winner "
              "check (g = 1): %d winner entries >= %d positive outputs, "
              "every channel" % (level, pairs, plist["chunks"],
                                 slab.PAIR_CHUNK,
                                 plist["heaviest_block_pairs"],
                                 winner_check["winner_entries"],
                                 winner_check["positive_outputs"]),
              flush=True)
        ms = time_ms(lambda: slab.slab_edge_max_backward(**kw, out=out,
                                                         g=g),
                     runs=5, warmup=1)
        plain_ms = time_ms(
            lambda: slab.slab_edge_max_backward_reference(
                **kw, out=ref_out, g=g),
            runs=3, warmup=1)
        fwd_ms = time_ms(lambda: slab.slab_edge_max(**kw), runs=5, warmup=1)
        fwd_plain_ms = time_ms(lambda: slab.slab_edge_max_reference(**kw),
                               runs=3, warmup=1)
        split = kernel_split(lambda: slab.slab_edge_max_backward(
            **kw, out=out, g=g))
        fwd_split = kernel_split(lambda: slab.slab_edge_max(**kw))
        winners = slab.winner_counts(**kw, out=ref_out)
        bound_ms, bound_by, flops, n_bytes = bound(args, pairs,
                                                   PEAK_F32_FLOPS, winners)
        fwd_bound_ms, fwd_bound_by, _, _ = bound(args, pairs,
                                                 PEAK_F32_FLOPS)
        max_err = max(e["max_abs_err"] for e in errs.values())
        levels["L%d" % level] = dict(
            P=args["table_a"].shape[0], K=args["table_b"].shape[0],
            widths=widths, inradius_pairs=pairs, winner_entries=winners[0],
            winning_pairs=winners[1], grads=errs,
            max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, flops=flops,
            bytes=n_bytes, pair_list=plist, winner_check=winner_check,
            device_ms_by_kernel=split,
            bound_ms_at_3xtf32=bound(args, pairs, PEAK_3XTF32_FLOPS,
                                     winners)[0],
            fwd_f32=dict(
                ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_bound_ms,
                bound_by=fwd_bound_by, max_abs_err=fwd_err,
                bound_ms_at_3xtf32=bound(args, pairs,
                                         PEAK_3XTF32_FLOPS)[0],
                device_ms_by_kernel=fwd_split),
        )
        print("phase 5: L%d P=%d K=%d pairs=%d (winner entries %d, "
              "winning pairs %d) K2 max_abs_err=%.3g "
              "(tol %.3g * (1 + max|plain|)), bitwise equal over two runs; "
              "K2 %.3f ms plain %.3f ms bound %.4f ms (%s); K1 f32 %.3f ms "
              "plain %.3f ms bound %.4f ms"
              % (level, args["table_a"].shape[0], args["table_b"].shape[0],
                 pairs, winners[0], winners[1], max_err, BWD_TOL, ms,
                 plain_ms, bound_ms, bound_by,
                 fwd_ms, fwd_plain_ms, fwd_bound_ms), flush=True)
        for name, e in errs.items():
            print("  %s: max_abs_err %.3g max|plain| %.3g"
                  % (name, e["max_abs_err"], e["max_abs_plain"]))
        for name, sp in (("K2", split), ("K1 f32", fwd_split)):
            print("  %s device ms per call by kernel: %s"
                  % (name, short_split(sp)), flush=True)
    report["train_levels"] = levels


def _split_step(step, state, batch):
    """One train step with every K1 and K2 call bracketed by CUDA
    events: ``(state, aux, wall ms, K1 ms, K2 ms)``."""
    import torch

    from pointgnn_tpu_torch.nn import slab

    orig = {"K1": slab.slab_edge_max, "K2": slab.slab_edge_max_backward}
    events = {"K1": [], "K2": []}

    def timed(name):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = orig[name](*args, **kwargs)
            end.record()
            events[name].append((start, end))
            return res

        wrapper.launches = 0  # the wrapped function counts on its name
        return wrapper

    slab.slab_edge_max = timed("K1")
    slab.slab_edge_max_backward = timed("K2")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    finally:
        slab.slab_edge_max = orig["K1"]
        slab.slab_edge_max_backward = orig["K2"]
    split = {k: sum(s.elapsed_time(e) for s, e in v)
             for k, v in events.items()}
    return state, aux, wall, split["K1"], split["K2"], {
        k: len(v) for k, v in events.items()}


def train_phase(report, device):
    """Phase 6: full-width car_auto_T3 training steps at batch 4."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch.infer import input_feature_dim
    from pointgnn_tpu_torch.parallel import step as step_lib
    from pointgnn_tpu_torch.train import metrics as metrics_lib
    from pointgnn_tpu_torch.train import optimizers

    cfg, tcfg, dspec, model, builder, loss_cfg = _train_setup(device)
    frames_per_device = tcfg["batch_size"]  # one card: the whole batch
    params = model.init(seed=0,
                        input_dim=input_feature_dim(cfg["input_features"]),
                        device=device)
    leaves = optimizers.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt, lr = optimizers.build_from_train_config(tcfg)
    state = step_lib.init_train_state(params, opt)
    step = step_lib.make_train_step(
        model, opt, loss_cfg, builder, frames_per_device,
        with_metrics=True, graph_rng_seed=0,
    )
    batch = _train_frames(cfg, dspec, range(frames_per_device), device,
                          points_per_beam=380)
    initial = [t.detach().clone() for t in leaves]
    torch.cuda.reset_peak_memory_stats()
    state, aux = step(state, batch)  # warm-up (allocator, kernel loads)
    torch.cuda.synchronize()

    metrics = metrics_lib.StreamingMetrics(model.num_classes)
    reset_counts()
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append({k: float(aux[k]) for k in (
            "cls_loss", "loc_loss", "reg_loss", "total_loss")})
        metrics.update(aux)
    counts = read_counts()
    k1 = counts["slab_edge_max"]
    k2 = counts["slab_edge_max_backward"]
    per_step = 4 * frames_per_device  # (1 level-0 + 3 level-1) per frame
    check(k1 == per_step * TRAIN_STEPS,
          "K1 launched %d times over %d steps, want %d"
          % (k1, TRAIN_STEPS, per_step * TRAIN_STEPS))
    check(k2 == per_step * TRAIN_STEPS,
          "K2 launched %d times over %d steps, want %d"
          % (k2, TRAIN_STEPS, per_step * TRAIN_STEPS))
    for d in losses:
        check(all(np.isfinite(v) for v in d.values()),
              "non-finite loss %s" % d)
    # every tensor with a gradient moved (the heads of classes without a
    # localization target get none into their biases)
    changed = [not torch.equal(t.detach(), b)
               for t, b in zip(leaves, initial)]
    with_grad = [t.grad is not None and bool((t.grad != 0).any())
                 for t in leaves]
    moved = sum(changed)
    check(all(c or not g for c, g in zip(changed, with_grad))
          and moved >= sum(with_grad) > 0,
          "%d of %d parameter tensors changed, %d had gradients"
          % (moved, len(leaves), sum(with_grad)))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    state, aux, split_wall, k1_ms, k2_ms, split_calls = _split_step(
        step, state, batch)
    res = metrics.results()
    report["train"] = dict(
        batch=frames_per_device, steps=TRAIN_STEPS, step_ms=step_ms,
        median_step_ms=statistics.median(step_ms), losses=losses,
        launches=dict(K1=k1, K2=k2), lr=lr(0), peak_mem_gib=peak_gib,
        num_endpoint=float(aux["num_endpoint"]),
        num_valid_endpoint=float(aux["num_valid_endpoint"]),
        split=dict(wall_ms=split_wall, K1_ms=k1_ms, K2_ms=k2_ms,
                   rest_ms=split_wall - k1_ms - k2_ms, calls=split_calls),
        recall_1=res["recall_1"], precision_0=res["precision_0"],
    )
    print("phase 6: car_auto_T3 train, batch %d, %d steps: %s ms/step "
          "(median %.1f), losses %s, launches K1 %d K2 %d (%d/step each), "
          "%d/%d parameter tensors changed (all with gradients), peak "
          "%.2f GiB; split step "
          "%.1f ms = K1 %.1f + K2 %.1f + rest %.1f"
          % (frames_per_device, TRAIN_STEPS,
             [round(v, 1) for v in step_ms], statistics.median(step_ms),
             [round(d["total_loss"], 5) for d in losses], k1, k2, per_step,
             moved, len(leaves), peak_gib, split_wall, k1_ms, k2_ms,
             split_wall - k1_ms - k2_ms), flush=True)
    return k1, k2


def _leaf_paths(tree, prefix=""):
    """Path names of a parameter tree's tensors, in ``param_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, "%s/%s" % (prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, "%s/%d" % (prefix, i))]
    return [] if tree is None else [prefix]


def _compare_runs(a, b, paths):
    """Loss and gradient gaps of run ``a`` against run ``b``."""
    import numpy as np

    loss_err = max(abs(x - y) / max(abs(y), 1e-12)
                   for x, y in zip(a["losses"], b["losses"]))
    gaps = []
    for x, y in zip(a["grads"], b["grads"]):
        gaps.append(float(np.abs(x - y).max())
                    / (1 + float(np.abs(y).max())))
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    return dict(loss_rel_err=loss_err, worst_grad_err_scaled=gaps[worst],
                worst_leaf=paths[worst], grad_err_scaled=gaps)


def grad_parity_phase(report, device):
    """Phase 7: one union step's loss and gradients, card vs CPU, full
    width, reduced capacity, same injected randomization.

    Three runs: the card with the kernels (the gated one), the card with
    the plain slab versions in their place, and the CPU (the plain
    versions).  Comparing the three says whether the card-vs-CPU gap
    comes from the kernels or from the rest of the card's f32 path.  In
    the kernel run every K2 call is also held against the plain
    backward on the same inputs and the model's own cotangent."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
    from pointgnn_tpu_torch.parallel import step as step_lib
    from pointgnn_tpu_torch.train import optimizers

    cfg, _, _, _, _, _ = _train_setup(device)
    spec = db.spec_from_config(cfg, num_points=4096, num_keypoints=2048,
                               runtime=False)
    frames = 2
    gen = torch.Generator().manual_seed(1)
    draws = [db.draw_randomization(spec.num_points, gen)
             for _ in range(frames)]
    orig = (slab.slab_edge_max, slab.slab_edge_max_backward)
    call_gaps = []

    def checked_backward(*args, **opts):
        # called as the autograd Function calls it: (tables, coordinates,
        # metadata, weights, out, g) positionally, options by keyword.
        # The plain forward's own output gives the plain winners.
        res = orig[1](*args, **opts)
        fwd_args, out, g = args[:7], args[7], args[8]
        ref_out = slab.slab_edge_max_reference(*fwd_args, **opts)
        ref = slab.slab_edge_max_backward_reference(*fwd_args, ref_out, g,
                                                    **opts)
        gaps = [float((x - z).abs().max()) / (1 + float(z.abs().max()))
                for x, z in zip(_flat_grads(res), _flat_grads(ref))]
        call_gaps.append(dict(
            K=int(out.shape[0]), h_out=int(out.shape[1]),
            fwd_max_abs_err=float((out - ref_out).abs().max()),
            fwd_entries_differ=int((out != ref_out).sum()),
            grad_err_scaled=max(gaps)))
        return res

    checked_backward.launches = 0  # the wrapped function counts on its name
    runs = {}
    params_np = None
    for name, dev in (("card", device), ("card_plain", device),
                      ("cpu", torch.device("cpu"))):
        _, _, dspec, model, builder, loss_cfg = _train_setup(dev, spec)
        if params_np is None:
            params_np = params_to_numpy(model.init(seed=2, device="cpu"))
        params = params_from_jax(params_np, dev)
        leaves = optimizers.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        sums = step_lib.make_union_sums_fn(model, loss_cfg, builder, frames)
        batch = _train_frames(cfg, dspec, range(20, 20 + frames), dev,
                              lower_labels=True, n_beams=32,
                              points_per_beam=120)
        dev_draws = [tuple(x.to(dev) for x in d) for d in draws]
        if name == "card":
            slab.slab_edge_max_backward = checked_backward
        elif name == "card_plain":
            slab.slab_edge_max = slab.slab_edge_max_reference
            slab.slab_edge_max_backward = slab.slab_edge_max_backward_reference
        try:
            acc, reg = sums(params, batch, dev_draws)
            cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
            loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
            total = cls + loc + reg
            total.backward()
        finally:
            slab.slab_edge_max, slab.slab_edge_max_backward = orig
        runs[name] = dict(
            losses=[float(x.detach()) for x in (total, cls, loc, reg)],
            n_val=float(acc["n_val"]),
            grads=[t.grad.detach().cpu().numpy() if t.grad is not None
                   else np.zeros(tuple(t.shape), np.float32)
                   for t in leaves],
        )
        paths = _leaf_paths(params)
    check(runs["card"]["n_val"] == runs["card_plain"]["n_val"]
          == runs["cpu"]["n_val"] > 0,
          "localization targets differ: %s"
          % {k: r["n_val"] for k, r in runs.items()})
    check(len(call_gaps) == 4 * frames,
          "%d K2 calls in the kernel run, want %d"
          % (len(call_gaps), 4 * frames))
    gated = _compare_runs(runs["card"], runs["cpu"], paths)
    check(gated["loss_rel_err"] <= 1e-4, "losses card vs CPU: rel %.3g > 1e-4"
          % gated["loss_rel_err"])
    for path, gap in zip(paths, gated["grad_err_scaled"]):
        check(gap <= GRAD_TOL, "gradient %s: card vs CPU %.3g of (1 + max|g|)"
              " > %.3g" % (path, gap, GRAD_TOL))
    split = {
        "card_plain_vs_cpu": _compare_runs(runs["card_plain"], runs["cpu"],
                                           paths),
        "card_vs_card_plain": _compare_runs(runs["card"],
                                            runs["card_plain"], paths),
    }
    worst_call = max(c["grad_err_scaled"] for c in call_gaps)
    report["grad_parity"] = dict(
        num_points=spec.num_points, num_keypoints=spec.num_keypoints,
        frames=frames, leaves=len(paths), n_val=runs["card"]["n_val"],
        losses={k: r["losses"] for k, r in runs.items()},
        card_vs_cpu=gated, k2_calls=call_gaps, **split,
    )
    print("phase 7: card vs CPU union step (%d frames, %d points, %d "
          "keypoints, full width, %d keypoints with a box target): "
          "losses rel err %.3g (tol 1e-4), worst gradient err %.3g of "
          "(1 + max|g|) over %d leaves at %s (tol %.3g)"
          % (frames, spec.num_points, spec.num_keypoints,
             runs["card"]["n_val"], gated["loss_rel_err"],
             gated["worst_grad_err_scaled"], len(paths), gated["worst_leaf"],
             GRAD_TOL), flush=True)
    for key, c in split.items():
        print("  %s: losses rel err %.3g, worst gradient err %.3g at %s"
              % (key, c["loss_rel_err"], c["worst_grad_err_scaled"],
                 c["worst_leaf"]))
    print("  K2 vs plain on the model's own %d calls: worst %.3g of "
          "(1 + max|plain|); K1 vs plain forward entries that differ %s"
          % (len(call_gaps), worst_call,
             [c["fwd_entries_differ"] for c in call_gaps]), flush=True)


# car_auto_T3 edge-list capacity: per-center caps of bench.py:423-426
EDGE_CAPS = (32, 192)
L1_FRAMES = 2


def edge_spec(cfg, **kw):
    """The smoke spec with the edge-list caps (slab flags off)."""
    from pointgnn_tpu_torch.graph import device_builder as db

    kw.setdefault("num_points", NUM_POINTS)
    kw.setdefault("num_keypoints", NUM_KEYPOINTS)
    return db.spec_from_config(cfg, per_center_caps=EDGE_CAPS, **kw)


def edge_pipeline(device, slab=False):
    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.infer import InferencePipeline

    cfg = configs.model_config("Car", T=3)
    return InferencePipeline(cfg, on_device_graph=True,
                             device_spec=edge_spec(cfg),
                             compute_dtype="bfloat16", seed=0, device=device,
                             slab=slab)


def capture_tail_inputs(pipe, pts):
    """Serve ``pts`` and record the edge-list tail's inputs of every
    layer as the model gives them: ``[(table_a, table_b, edges_src,
    tail weights), ...]`` (level 0 first)."""
    from pointgnn_tpu_torch.nn import layers

    calls = []
    orig = layers._tail_agg

    def recording(tail, table_a, table_b, edges_src, compute_dtype):
        calls.append((table_a.clone(), table_b.clone(), edges_src.clone(),
                      [(layer["w"], layer["b"]) for layer in tail]))
        return orig(tail, table_a, table_b, edges_src, compute_dtype)

    layers._tail_agg = recording
    try:
        pipe.run_frame(pts)
    finally:
        layers._tail_agg = orig
    return calls


def tail_args(call, dtype, centers=None):
    """K3 and K4 arguments of one recorded call, in ``dtype``, as the
    layer builds them (gather ``A[min(src, N-1)]``, sentinel mask),
    optionally cut to the first ``centers`` centers."""
    import torch

    table_a, table_b, src, weights = call
    n, k = table_a.shape[0], table_b.shape[0]
    src = src.reshape(k, -1)
    if centers is not None:
        table_b, src = table_b[:centers], src[:centers]
        k = centers
    a = table_a.to(dtype).contiguous()
    b = table_b.to(dtype).contiguous()
    valid = (src < n).to(torch.float32).contiguous()
    gathered = a.index_select(
        0, torch.clamp(src.reshape(-1).long(), max=n - 1)).contiguous()
    k3 = dict(gathered=gathered, table_b=b, slot_valid=valid,
              weights=weights)
    k4 = dict(table_a=a, table_b=b, edges_src=src.to(torch.int32)
              .contiguous(), slot_valid=valid, weights=weights)
    return k3, k4


def tail_bound(args, fused):
    """Least time (ms) of one K3 (or K4) call: its bytes over the memory
    rate against the chain's operations on this run's valid slots over
    the bf16 peak.  Bytes: the valid rows of G (K4: the whole A table
    and the edges), B, the flags, the weights as the kernel reads them
    (f32) and the output."""
    valid = args["slot_valid"]
    n_valid = int((valid > 0).sum())
    b = args["table_b"]
    h = b.shape[1]
    weights = args["weights"]
    flops = 2 * h
    n_bytes = 0
    for w, bias in weights:
        flops += 2 * w.shape[0] * w.shape[1] + 2 * w.shape[1]
        n_bytes += 4 * (w.numel() + bias.numel())
    flops *= n_valid
    h_out = weights[-1][0].shape[1] if weights else h
    if fused:
        a = args["table_a"]
        n_bytes += a.numel() * a.element_size()
        n_bytes += args["edges_src"].numel() * 4
    else:
        n_bytes += n_valid * h * args["gathered"].element_size()
    n_bytes += b.numel() * b.element_size() + valid.numel() * 4
    n_bytes += 4 * b.shape[0] * h_out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes"), flops, n_bytes


def tail_pair_check(k3, k4):
    """The kernel-built valid-slot pair lists of one call (K3's rows and
    K4's) against the plain ones, and the same on two runs.  Returns
    ``(pairs, chunks)``."""
    import torch

    from pointgnn_tpu_torch.nn import edge_tail

    n_a = k4["table_a"].shape[0]
    for edges in (None, k4["edges_src"]):
        args = (k3["slot_valid"], edges, n_a)
        got = edge_tail.tail_pair_list(*args)
        again = edge_tail.tail_pair_list(*args)
        want = edge_tail.tail_pair_list_reference(*args)
        check(all(torch.equal(x, y) and torch.equal(x, z)
                  for x, y, z in zip(got, again, want)),
              "the %s pair list differs from the plain one or between runs"
              % ("K3" if edges is None else "K4"))
    n = int(got[0][-1])
    return n, -(-n // edge_tail.PAIR_CHUNK)


def tail_split_groups(split):
    """A K3/K4 call's device ms by stage: the pair list (count and write
    passes, the offsets' cumsum), the chain, the finish pass, the rest
    (the weights' rounding and layout)."""
    groups = dict(pair_list=0.0, chain=0.0, finish=0.0, other=0.0)
    for name, ms in split.items():
        if name.startswith("pair_kernel") or "Scan" in name:
            groups["pair_list"] += ms
        elif name.startswith("chain_kernel"):
            groups["chain"] += ms
        elif name.startswith("finish_kernel"):
            groups["finish"] += ms
        else:
            groups["other"] += ms
    return groups


def edge_kernel_phase(report, device):
    """Phase 8: K3 and K4 vs their plain versions (and K4 vs K3) on the
    inputs the edge-list model gives them on the seed-100 frame."""
    import torch

    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.nn import edge_tail
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    pipe = edge_pipeline(device)
    pts, _ = synthetic_lidar_frame(seed=100, points_per_beam=380)
    calls = capture_tail_inputs(pipe, pts)
    check(len(calls) == 4, "%d edge-list layers, want 4" % len(calls))
    packed = torch.from_numpy(db.pack_points(
        pts.xyz, select_input_features(pts.attr, "i"), NUM_POINTS
    )).to(device)
    _, counters = db.build_padded_graph(*db.unpack_points(packed),
                                        pipe.device_spec,
                                        return_counters=True)
    levels = {}
    for level, call in ((0, calls[0]), (1, calls[1])):
        k3, k4 = tail_args(call, torch.bfloat16)
        out3 = edge_tail.edge_tail_max(**k3)
        out4 = edge_tail.fused_edge_max(**k4)
        again = edge_tail.edge_tail_max(**k3)
        torch.cuda.synchronize()
        ref = edge_tail.edge_tail_max_reference(**k3)
        ref4 = edge_tail.fused_edge_max_reference(**k4)
        check(torch.equal(ref, ref4), "L%d: the plain versions differ"
              % level)
        errs = {}
        for name, out in (("K3", out3), ("K4", out4)):
            check(out.shape == ref.shape, "L%d %s: shape %s vs %s"
                  % (level, name, tuple(out.shape), tuple(ref.shape)))
            check(bool(torch.isfinite(out).all()),
                  "L%d %s: non-finite" % (level, name))
            err = (out - ref).abs()
            rel = (err / (1.0 + ref.abs())).max().item()
            check(rel <= BF16_TOL, "L%d %s: kernel vs plain %.3g > %.3g"
                  % (level, name, rel, BF16_TOL))
            ulps = bf16_ulps(out, ref)
            check(ulps <= TAIL_MAX_ULPS, "L%d %s: kernel vs plain %.3g bf16"
                  " ulps > %d" % (level, name, ulps, TAIL_MAX_ULPS))
            errs[name] = (err.max().item(), rel, ulps)
        check(torch.equal(out3, out4), "L%d: K4 differs from K3" % level)
        check(torch.equal(out3, again), "L%d: two K3 runs differ" % level)
        pairs, chunks = tail_pair_check(k3, k4)
        check(pairs == int((k3["slot_valid"] > 0).sum()),
              "L%d: pair list length differs from the valid slots" % level)
        row = dict(K=k3["table_b"].shape[0], S=k3["slot_valid"].shape[1],
                   rows_a=k4["table_a"].shape[0],
                   widths=[k3["table_b"].shape[1]] + [
                       w.shape[1] for w, _ in k3["weights"]],
                   valid_slots=pairs, chunks=chunks,
                   saturated_centers=int(
                       counters["l%d_saturated_centers" % level]),
                   cell_overflow_sources=int(
                       counters["l%d_cell_overflow_sources" % level]),
                   nonzero_rows=int((out3.abs().sum(1) > 0).sum()),
                   k4_equals_k3=True, runs_bitwise_equal=True,
                   pair_lists_equal_plain=True)
        for name, fn, plain, args, fused in (
            ("K3", edge_tail.edge_tail_max,
             edge_tail.edge_tail_max_reference, k3, False),
            ("K4", edge_tail.fused_edge_max,
             edge_tail.fused_edge_max_reference, k4, True),
        ):
            ms = time_ms(lambda: fn(**args), runs=20)
            plain_ms = time_ms(lambda: plain(**args), runs=10, warmup=1)
            bound_ms, bound_by, flops, n_bytes = tail_bound(args, fused)
            # the products run as f32 fmaf (bitwise the plain version's):
            # the least time at the f32 rate outside the tensor cores
            f32_ms = 1e3 * max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES)
            row[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_ms_at_f32=f32_ms,
                             bound_by=bound_by, flops=flops, bytes=n_bytes,
                             max_abs_err=errs[name][0],
                             max_rel_err=errs[name][1],
                             max_bf16_ulps=errs[name][2])
        # the row gather the layer would run before K3, alone
        table_a = k4["table_a"]
        src = k4["edges_src"].reshape(-1).to(torch.int64)
        n_a = table_a.shape[0]
        row["gather_ms"] = time_ms(lambda: table_a.index_select(
            0, torch.clamp(src, max=n_a - 1)), runs=20)
        row["k4_beats_gather_and_k3"] = (
            row["K4"]["ms"] <= row["gather_ms"] + row["K3"]["ms"])
        split = kernel_split(lambda: edge_tail.edge_tail_max(**k3))
        row["K3"]["device_ms_by_kernel"] = split
        row["K3"]["device_ms_by_stage"] = tail_split_groups(split)
        levels["L%d" % level] = row
        print("phase 8: L%d K=%d S=%d valid slots %d (%d chunks of %d), "
              "saturated centers %d; pair lists equal the plain ones; K3 "
              "%.3f ms (plain %.3f, bound %.4f %s, %.4f at f32, err %.3g, "
              "%.3g ulps); K4 %.3f ms (plain %.3f, bound %.4f %s, %.4f at "
              "f32, err %.3g, %.3g ulps); K4 == K3 bitwise, two K3 runs "
              "bitwise; gather alone %.3f ms, K4 <= gather + K3: %s"
              % (level, row["K"], row["S"], pairs, chunks,
                 edge_tail.PAIR_CHUNK, row["saturated_centers"],
                 row["K3"]["ms"], row["K3"]["plain_ms"],
                 row["K3"]["bound_ms"], row["K3"]["bound_by"],
                 row["K3"]["bound_ms_at_f32"],
                 row["K3"]["max_rel_err"], row["K3"]["max_bf16_ulps"],
                 row["K4"]["ms"], row["K4"]["plain_ms"],
                 row["K4"]["bound_ms"], row["K4"]["bound_by"],
                 row["K4"]["bound_ms_at_f32"],
                 row["K4"]["max_rel_err"], row["K4"]["max_bf16_ulps"],
                 row["gather_ms"], row["k4_beats_gather_and_k3"]),
              flush=True)
        print("  K3 device ms per call by stage: %s; by kernel: %s"
              % ({k: round(v, 4) for k, v in
                  row["K3"]["device_ms_by_stage"].items()},
                 short_split(split)), flush=True)
    report["edge_levels"] = levels

    # f32 at a small size: the first 2048 centers of the level-1 call
    k3, k4 = tail_args(calls[1], torch.float32, centers=2048)
    ref = edge_tail.edge_tail_max_reference(**k3)
    small = {}
    for name, out in (("K3", edge_tail.edge_tail_max(**k3)),
                      ("K4", edge_tail.fused_edge_max(**k4))):
        torch.cuda.synchronize()
        small[name] = ((out - ref).abs() / (1 + ref.abs())).max().item()
        check(small[name] <= 1e-4, "f32 %s vs f32 plain: %.3g > 1e-4"
              % (name, small[name]))
    report["edge_small_f32"] = dict(K=2048, **small)
    print("phase 8: small K=2048 f32 K3 vs plain %.3g, K4 vs plain %.3g "
          "(tol 1e-4)" % (small["K3"], small["K4"]), flush=True)
    return pipe


def device_program_split(pipe, pts, device, calls=3):
    """Device ms of one frame's device program (``device_fn``) by stage,
    from torch.profiler: every stage is a ``record_function`` range around
    its function, and its device time the time of the torch kernels
    launched inside it.  The profiler links no range to the kernels that
    the port launches through ctypes, so K4's own kernels (pair list,
    chain, finish) are counted by name.  Also the program's device time
    by CUDA kernel, its span on the card (CUDA events) and the card's busy
    share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.nn import edge_tail, layers

    packed = torch.from_numpy(db.pack_points(
        pts.xyz, select_input_features(pts.attr, "i"), NUM_POINTS
    )).to(device)

    def program():
        return pipe.device_fn(pipe.params, packed)

    by_kernel = kernel_split(program, calls)
    span_ms = time_ms(program, runs=calls, warmup=1)
    stages = {"graph build": (db, "build_padded_graph"),
              "radius_edges": (db, "radius_edges"),
              "edge-list tail": (layers, "_tail_agg"),
              # K4's kernels, launched by this helper of its wrapper
              "K4": (edge_tail, "_tail_on_card")}
    saved = {}
    for name, (mod, attr) in stages.items():
        orig = getattr(mod, attr)
        saved[(mod, attr)] = orig

        def ranged(*a, _name=name, _orig=orig, **kw):
            with record_function(_name):
                return _orig(*a, **kw)

        setattr(mod, attr, ranged)
    try:
        program()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                program()
            torch.cuda.synchronize()
    finally:
        for (mod, attr), orig in saved.items():
            setattr(mod, attr, orig)
    ms = {name: 0.0 for name in stages}
    for ev in prof.events():
        if ev.name in ms and ev.device_type == DeviceType.CPU:
            ms[ev.name] += ev.device_time_total / 1e3 / calls
    total = sum(by_kernel.values())
    # no slab kernel runs on this path, so these names are K4's
    k4_kernels = sum(v for k, v in by_kernel.items() if k.startswith(
        ("pair_kernel", "chain_kernel", "finish_kernel")))
    by_stage = {
        "radius_edges": ms["radius_edges"],
        "graph build, rest": ms["graph build"] - ms["radius_edges"],
        "K4 kernels": k4_kernels,
        "K4 torch ops (offsets, weights)": ms["K4"],
        "edge-list tail, rest (slot mask, casts)":
            ms["edge-list tail"] - ms["K4"],
        "rest of the program":
            total - ms["graph build"] - ms["edge-list tail"] - k4_kernels,
    }
    return dict(device_ms=total, span_ms=span_ms,
                busy_share=total / span_ms if span_ms else None,
                by_stage=by_stage, by_kernel=by_kernel,
                stages_seen=any(v > 0 for v in ms.values()))


def edge_serving_phase(report, device, pipe):
    """Phase 9: full-width car_auto_T3 serving on the edge-list path
    (8 frames), then 2 frames with slab="l1"; then the device program of
    one edge-list frame split by stage."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    frames = [synthetic_lidar_frame(seed=i, points_per_beam=380)[0]
              for i in range(FRAMES)]
    out = {}
    # the layers call K4 (the gather inside the kernel), not the gather
    # and K3
    for mode, n_frames, want in (
        ("edges", FRAMES, {"fused_edge_max": 4, "edge_tail_max": 0,
                           "slab_edge_max": 0}),
        ("l1", L1_FRAMES, {"fused_edge_max": 1, "edge_tail_max": 0,
                           "slab_edge_max": 3}),
    ):
        if mode == "l1":
            pipe = edge_pipeline(device, slab="l1")
            pipe.run_frame(synthetic_lidar_frame(seed=100,
                                                 points_per_beam=380)[0])
        pipe.time_dict.clear()
        buckets, detections = {}, []
        reset_counts()
        t_all = time.perf_counter()
        for pts in frames[:n_frames]:
            before = dict(pipe.time_dict)
            cls, boxes, scores, _ = pipe.run_frame(pts)
            for key, val in pipe.time_dict.items():
                buckets.setdefault(key, []).append(
                    1e3 * (val - before.get(key, 0.0)))
            check(boxes.ndim == 2 and boxes.shape[1:] == (7,),
                  "boxes shape %s" % (boxes.shape,))
            check(len(cls) == len(scores) == len(boxes), "ragged detections")
            check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
                  "non-finite detections")
            detections.append(int(len(cls)))
        wall = time.perf_counter() - t_all
        counts = read_counts()
        for name, per_frame in want.items():
            check(counts[name] == per_frame * n_frames,
                  "%s: %s launched %d times over %d frames, want %d"
                  % (mode, name, counts[name], n_frames,
                     per_frame * n_frames))
        check(counts["slab_edge_max_backward"] == 0,
              "%s: unexpected launches %s" % (mode, counts))
        # capacity truncation of each frame's graph (no kernel runs)
        saturation = []
        for pts in frames[:n_frames]:
            packed = torch.from_numpy(db.pack_points(
                pts.xyz, select_input_features(pts.attr, "i"), NUM_POINTS
            )).to(device)
            _, c = db.build_padded_graph(*db.unpack_points(packed),
                                         pipe.device_spec,
                                         return_counters=True)
            saturation.append({k: int(v) for k, v in c.items()})
        med = {k: statistics.median(v) for k, v in buckets.items()}
        out[mode] = dict(frames=n_frames, launches=counts,
                         detections=detections, median_ms=med,
                         ms_per_frame=buckets,
                         wall_ms_per_frame=1e3 * wall / n_frames,
                         counters=saturation)
        print("phase 9: %s, %d frames, launches %s, median ms per frame %s,"
              " detections %s, wall %.1f ms/frame; saturated centers per "
              "frame L0 %s L1 %s"
              % (mode, n_frames, counts,
                 {k: round(v, 3) for k, v in med.items()}, detections,
                 1e3 * wall / n_frames,
                 [c.get("l0_saturated_centers") for c in saturation],
                 [c.get("l1_saturated_centers") for c in saturation]),
              flush=True)
        if mode == "edges":
            split = device_program_split(pipe, frames[0], device)
            out[mode]["device_program"] = split
            print("phase 9: edges, one frame's device program: %.3f ms of "
                  "kernels in a %.3f ms span (busy %.3f); by stage %s%s; by "
                  "kernel %s"
                  % (split["device_ms"], split["span_ms"],
                     split["busy_share"],
                     {k: round(v, 3) for k, v in split["by_stage"].items()},
                     "" if split["stages_seen"] else
                     " (the profiler gave the stages no device time)",
                     dict(list(short_split(split["by_kernel"]).items())[:12])),
                  flush=True)
    report["edge_serving"] = out
    return out


def edge_cpu_parity_phase(report, device):
    """Phase 10: the edge-list model on the card vs on the CPU, small
    frame, f32, same parameters."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    cfg = configs.model_config("Car", T=3)
    spec = edge_spec(cfg, num_points=2048, num_keypoints=1024)
    pts, _ = synthetic_lidar_frame(seed=5, n_beams=32, points_per_beam=64)
    outs = []
    params = None
    for dev in (device, torch.device("cpu")):
        pipe = InferencePipeline(
            cfg, on_device_graph=True, params=params, device_spec=spec,
            compute_dtype="float32",
            seed=1, device=dev, slab=False,
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
        outs.append([t.cpu().numpy() for t in (
            graph.edges_src[0], graph.edges_src[1], graph.edges_dst[0],
            graph.edges_dst[1], graph.keypoint_indices[0],
            torch.softmax(logits, -1), enc,
        )])
    g, c = outs
    for i, name in enumerate(("edges_src[0]", "edges_src[1]",
                              "edges_dst[0]", "edges_dst[1]",
                              "keypoint_indices[0]")):
        check(np.array_equal(g[i], c[i]), "graph %s differs" % name)
    # f32 on both devices, other summation orders (no TF32): 1e-3
    dp = float(np.abs(g[5] - c[5]).max())
    de = float(np.abs(g[6] - c[6]).max())
    check(dp <= 1e-3 and de <= 1e-3,
          "cuda vs cpu edge-list model: probs %.3g enc %.3g > 1e-3"
          % (dp, de))
    report["edge_cpu_parity"] = dict(probs_max_abs=dp, enc_max_abs=de,
                                     valid_edges=[int((g[i] < n).sum())
                                                  for i, n in ((0, 2048),
                                                               (1, 1024))])
    print("phase 10: cuda vs cpu edge-list model (f32, 1024 keypoints): "
          "edge lists bitwise equal, probs %.3g enc %.3g (tol 1e-3)"
          % (dp, de), flush=True)


KITTI_FRAMES = 8
KITTI_BUCKETS = ("fetch input", "gen graph", "gnn inference", "nms", "total")
NMS_VARIANTS = ("nms_boxes_3d", "nms_boxes_3d_uncertainty",
                "nms_boxes_3d_merge_only", "nms_boxes_3d_score_only")


def _python_overlap(single, boxes):
    """The same overlap under another identity: the numpy NMS loop."""
    from pointgnn_tpu_torch.postprocess import iou

    return iou.overlapped_boxes_3d(single, boxes)


def capture_k1_calls(run):
    """Run ``run()`` and record every ``slab_edge_max`` call the layers
    make (level 0 first): its arguments, as the layers give them, and
    its output."""
    import torch

    from pointgnn_tpu_torch.nn import layers

    calls = []
    orig = layers._slab_agg

    def recording(tail, table_a, src4, table_b, ctr4, meta, compute_dtype):
        cd = layers.mlp.as_compute_dtype(compute_dtype) or torch.float32
        args = dict(
            table_a=table_a.clone(), src_xyz=src4.clone(),
            table_b=table_b.clone(), ctr_xyz=ctr4.clone(),
            offsets=meta["offsets"].clone(),
            center_cell=meta["center_cell"].clone(),
            weights=[(layer["w"], layer["b"]) for layer in tail],
            grid_g=meta["grid_g"], radius=meta["radius"],
            halo=meta.get("halo", 1),
            compute_dtype=str(cd).replace("torch.", ""))
        out = orig(tail, table_a, src4, table_b, ctr4, meta, compute_dtype)
        calls.append((args, out.clone()))
        return out

    layers._slab_agg = recording
    try:
        run()
    finally:
        layers._slab_agg = orig
    return calls


def capture_slab_inputs(pipe, packed):
    """The arguments of every ``slab_edge_max`` call of ``device_fn`` on
    ``packed`` (level 0 first)."""
    return [args for args, _ in capture_k1_calls(
        lambda: pipe.device_fn(pipe.params, packed))]


def kitti_k1_check(pipe, packed):
    """K1 on the KITTI path's own inputs: every launch of one
    ``device_fn`` on ``packed`` (the CLI's spec, its checkpoint) held
    against the plain version, and the pair list of level 0 and of the
    first level-1 layer against the plain enumeration."""
    import torch

    from pointgnn_tpu_torch.nn import slab

    calls = capture_slab_inputs(pipe, packed)
    check(len(calls) == 4, "device_fn made %d slab calls, want 4"
          % len(calls))
    rows = []
    for i, args in enumerate(calls):
        out = slab.slab_edge_max(**args)
        torch.cuda.synchronize()
        ref = slab.slab_edge_max_reference(**args)
        check(out.shape == ref.shape, "KITTI K1 call %d: shape %s vs %s"
              % (i, tuple(out.shape), tuple(ref.shape)))
        check(bool(torch.isfinite(out).all()),
              "KITTI K1 call %d: non-finite" % i)
        err = (out - ref).abs()
        rel = (err / (1.0 + ref.abs())).max().item()
        check(rel <= BF16_TOL, "KITTI K1 call %d: kernel vs plain %.3g > "
              "%.3g" % (i, rel, BF16_TOL))
        row = dict(P=args["table_a"].shape[0], K=args["table_b"].shape[0],
                   compute_dtype=args["compute_dtype"],
                   max_abs_err=err.max().item(), max_rel_err=rel,
                   bf16_ulps=bf16_ulps(out, ref))
        if i < 2:  # the level-1 layers share their slab metadata
            row["pair_list"] = pair_list_check(args)
        rows.append(row)
    return rows


def kitti_cli_phase(report, device):
    """Phase 11: a synthetic KITTI tree served by ``run_torch.py --fast``
    on the card (a subprocess, as a user runs it), then one frame's
    hypotheses through the native NMS and the numpy loop."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.data import png
    from pointgnn_tpu_torch.data.kitti import KittiDataset
    from pointgnn_tpu_torch.data.labels import LABEL_METHODS
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import (InferencePipeline,
                                          select_input_features)
    from pointgnn_tpu_torch.postprocess import nms
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.utils import synthetic_kitti

    work = os.path.join(HERE, "build", "chip_smoke_kitti")
    shutil.rmtree(work, ignore_errors=True)
    tree, ck_dir, out_dir = (os.path.join(work, d)
                             for d in ("kitti", "ckpt", "out"))
    names = synthetic_kitti.main(tree, KITTI_FRAMES, n_ground=12000)
    cfg = configs.get_config("car_auto_T3_train")
    params = InferencePipeline(cfg, seed=0, device="cpu").params
    ckpt.save_checkpoint(ck_dir, 0, {"params": params}, config=cfg)

    cmd = [sys.executable, os.path.join(HERE, "run_torch.py"), ck_dir,
           "--fast", "--dataset_root_dir", tree, "--output_dir", out_dir]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, "run_torch.py exited %d:\n%s\n%s" % (
        res.returncode, res.stdout[-4000:], res.stderr[-4000:]))
    lines = res.stdout.strip().splitlines()
    buckets = {}
    for ln in lines:
        m = re.match(r"^(.+): ([0-9.]+) ms/frame$", ln)
        if m:
            buckets[m.group(1)] = float(m.group(2))
    check(set(buckets) == set(KITTI_BUCKETS),
          "run_dataset buckets %s" % sorted(buckets))
    launches = json.loads(lines[-1])["launches"]
    check(launches == {"slab_edge_max": 4 * KITTI_FRAMES,
                       "slab_edge_max_backward": 0, "edge_tail_max": 0,
                       "fused_edge_max": 0},
          "run_torch.py launches %s over %d frames, want 4 slab_edge_max "
          "a frame" % (launches, KITTI_FRAMES))

    label_map = LABEL_METHODS[cfg["label_method"]][0]
    classes = set(label_map) - {"Background", "DontCare"}
    files = sorted(os.listdir(os.path.join(out_dir, "data")))
    check(files == [n + ".txt" for n in names], "label files %s" % files)
    per_frame = []
    for name in files:
        with open(os.path.join(out_dir, "data", name)) as f:
            rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
        for row in rows:
            check(len(row) == 16, "%s: %d fields" % (name, len(row)))
            check(row[0] in classes, "%s: class %r" % (name, row[0]))
            check(row[1:4] == ["-1", "-1", "0"], "%s: %s" % (name, row[1:4]))
            check(np.isfinite(np.float64(row[4:])).all(),
                  "%s: non-finite fields" % name)
        per_frame.append(len(rows))
    check(sum(per_frame) > 0, "no detection in %d frames" % KITTI_FRAMES)
    summed = sum(buckets[k] for k in KITTI_BUCKETS[:-1])

    # one frame's hypotheses on the card, as the CLI's pipeline makes them
    pipe = InferencePipeline(cfg, checkpoint_dir=ck_dir, device=device,
                             on_device_graph=True)
    check(pipe.restored_step == 0, "restored step %d" % pipe.restored_step)
    ds = KittiDataset(
        os.path.join(tree, "image/training/image_2"),
        os.path.join(tree, "velodyne/training/velodyne/"),
        os.path.join(tree, "calib/training/calib/"),
        os.path.join(tree, "labels/training/label_2"),
        os.path.join(tree, "3DOP_splits/val.txt"), num_classes=4)
    pts = ds.get_cam_points_in_image_with_rgb(0)
    host = torch.from_numpy(db.pack_points(
        pts.xyz, select_input_features(pts.attr, cfg["input_features"]),
        pipe.device_spec.num_points))
    packed = host.to(device)
    k1 = kitti_k1_check(pipe, packed)
    # stream copies each packed frame with a plain blocking .to(device)
    copy = []
    for _ in range(11):
        t0 = time.perf_counter()
        host.to(device)
        torch.cuda.synchronize()
        copy.append(1e3 * (time.perf_counter() - t0))
    copy_ms = statistics.median(copy[1:])
    # KITTI photographs are mostly Average and Paeth rows; the tree's
    # images are written with None rows: decode one image written with
    # each filter type
    image = ds.get_image(0)
    png_ms = {}
    for kind in range(5):
        data = png.encode_png(image, filter_type=kind)
        check(np.array_equal(png.decode_png(data), image),
              "PNG filter %d does not round-trip" % kind)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            png.decode_png(data)
            times.append(1e3 * (time.perf_counter() - t0))
        png_ms[kind] = statistics.median(times)
    # how much of the device program is left when device_fn returns:
    # slab_edge_max reads its pair count on the host, so the host waits
    # for the card inside device_fn; only the rest can overlap host NMS
    dispatch, whole = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = pipe.device_fn(pipe.params, packed)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dispatch.append(1e3 * (t1 - t0))
        whole.append(1e3 * (t2 - t0))
    dispatch_ms, whole_ms = (statistics.median(dispatch[1:]),
                             statistics.median(whole[1:]))
    scores, sel_cls, sel_boxes, _ = (t.cpu().numpy() for t in outs)
    keep = scores > 0
    labels = sel_cls[keep].astype(np.int64)
    for v in range(2, pipe.num_classes - 1, 2):
        labels[labels == v] = v - 1
    boxes = sel_boxes[keep].astype(np.float64)
    probs = scores[keep].astype(np.float64)
    kw = dict(overlapped_thres=cfg["nms_overlapped_thres"],
              appr_factor=100.0, top_k=-1)
    variants = {}
    for variant in NMS_VARIANTS:
        fn = getattr(nms, variant)
        t0 = time.perf_counter()
        cn, bn, sn, _ = fn(labels, boxes, probs, **kw)
        t1 = time.perf_counter()
        cp, bp, sp, _ = fn(labels, boxes, probs,
                           overlapped_fn=_python_overlap, **kw)
        t2 = time.perf_counter()
        check(len(cn) == len(cp) and (cn == cp).all(),
              "%s: native kept %d, numpy %d" % (variant, len(cn), len(cp)))
        check(np.allclose(bn, bp, rtol=0, atol=1e-12),
              "%s: boxes differ by %.3g" % (variant, abs(bn - bp).max()))
        check(np.allclose(sn, sp, rtol=1e-7, atol=1e-9),
              "%s: scores differ by %.3g" % (variant, abs(sn - sp).max()))
        variants[variant] = dict(kept=int(len(cn)),
                                 native_ms=1e3 * (t1 - t0),
                                 python_ms=1e3 * (t2 - t1))

    # the same tree again through run_dataset in this process, warm (the
    # CLI's buckets include its first frame's one-time costs), with the
    # KITTI conversion (projection, occlusion rescoring), which no bucket
    # holds, timed apart
    convert = [0.0]
    to_kitti = pipe.detections_to_kitti

    def timed_to_kitti(*args):
        t0 = time.perf_counter()
        out = to_kitti(*args)
        convert[0] += time.perf_counter() - t0
        return out

    pipe.detections_to_kitti = timed_to_kitti
    warm_dir = os.path.join(work, "warm")
    warm = {k: 1e3 * v for k, v in
            pipe.run_dataset(ds, warm_dir, verbose=False).items()}
    warm_sum = sum(warm[k] for k in KITTI_BUCKETS[:-1])
    for name in files:
        with open(os.path.join(out_dir, "data", name)) as a, \
                open(os.path.join(warm_dir, "data", name)) as b:
            check(a.read() == b.read(),
                  "%s: run_torch.py and run_dataset wrote other text" % name)
    shutil.rmtree(work, ignore_errors=True)
    report["kitti_cli"] = dict(
        frames=KITTI_FRAMES, ms_per_frame=buckets, cli_seconds=cli_s,
        total_over_bucket_sum=buckets["total"] / summed,
        warm_ms_per_frame=warm, warm_total_over_bucket_sum=(
            warm["total"] / warm_sum),
        warm_kitti_conversion_ms_per_frame=1e3 * convert[0] / KITTI_FRAMES,
        launches=launches, detections=per_frame, hypotheses=int(keep.sum()),
        device_fn_return_ms=dispatch_ms, device_fn_done_ms=whole_ms,
        overlap_left_share=(whole_ms - dispatch_ms) / whole_ms,
        nms=variants, k1_on_frame0=k1, packed_copy_ms=copy_ms,
        packed_bytes=host.numel() * host.element_size(),
        png_decode_ms_by_filter=png_ms, image_shape=list(image.shape),
    )
    print("phase 11: run_torch.py --fast served %d synthetic KITTI frames "
          "(n_ground 12000) in %.1f s: ms per frame %s; total / sum of the "
          "other buckets %.3f; launches %s; detections %s"
          % (KITTI_FRAMES, cli_s, buckets, buckets["total"] / summed,
             launches, per_frame), flush=True)
    print("phase 11: the same frames warm in this process: ms per frame "
          "%s; total / sum of the other buckets %.3f; KITTI conversion "
          "(in no bucket) %.3f ms per frame; label files equal the CLI's"
          % ({k: round(v, 3) for k, v in warm.items()}, warm["total"]
             / warm_sum, 1e3 * convert[0] / KITTI_FRAMES), flush=True)
    print("phase 11: frame 0, %d hypotheses: device_fn returns after %.3f "
          "ms of a %.3f ms device program (%.3f of it left to overlap the "
          "host)" % (int(keep.sum()), dispatch_ms, whole_ms,
                     (whole_ms - dispatch_ms) / whole_ms), flush=True)
    for i, row in enumerate(k1):
        print("phase 11: frame 0, K1 call %d (P=%d K=%d %s) vs plain: "
              "max_abs_err %.3g rel %.3g (tol %.3g), %.1f bf16 ulps%s"
              % (i, row["P"], row["K"], row["compute_dtype"],
                 row["max_abs_err"], row["max_rel_err"], BF16_TOL,
                 row["bf16_ulps"],
                 "; pair list equals the plain enumeration: %d pairs, %d "
                 "chunks" % (row["pair_list"]["pairs"],
                             row["pair_list"]["chunks"])
                 if "pair_list" in row else ""), flush=True)
    print("phase 11: packed frame %d bytes, copy to the card %.3f ms; PNG "
          "decode of a %s image by row filter (0 None .. 4 Paeth): %s ms"
          % (host.numel() * host.element_size(), copy_ms,
             "x".join(map(str, image.shape)),
             {k: round(v, 3) for k, v in png_ms.items()}), flush=True)
    for variant, row in variants.items():
        print("phase 11: %s: native %.3f ms, numpy loop %.3f ms, %d kept "
              "(equal: classes, boxes 1e-12, scores rtol 1e-7)"
              % (variant, row["native_ms"], row["python_ms"], row["kept"]),
              flush=True)
    return launches, k1


TRAIN_CLI_FRAMES = 8
TRAIN_CLI_N_GROUND = 12000
TRAIN_CLI_CLASSES = ("Car", "Pedestrian", "Cyclist")
# car_auto_T3's shipped sgd learning rate (0.125) diverges on the
# synthetic tree at full width: the loss grows ~4-6x a step and turns NaN
# by step 6 (the port follows the JAX step's trajectory step for step,
# tests/test_torch_train_trajectory.py).  The car runs train at a tenth
# of it; the shipped rate's loss per step is probed and reported.
CAR_CLI_LR = 0.0125
LR_PROBE_STEPS = 6
# phase 12's tree and train_dirs, kept for phase 13's evaluation
TRAIN_CLI_WORK = os.path.join(HERE, "build", "chip_smoke_train")


def train_cli_configs(name):
    """``(config, train_config)`` of a phase-12 run: the shipped ones,
    at full width and depth."""
    from pointgnn_tpu_torch import configs

    return configs.get_config(name), configs.get_train_config(name)


def _train_cli(work, name, tree, device, run, **overrides):
    """One ``train_torch.py`` run in a subprocess, as a user runs it, on
    config files written from the shipped configs with ``overrides``.
    Returns its last JSON line, its stdout and its wall seconds."""
    from pointgnn_tpu_torch.utils import config_io

    cfg, tc = train_cli_configs(name)
    tc.update(train_dir=os.path.join(work, name), **overrides)
    cfg_path = os.path.join(work, "%s_%s_config" % (name, run))
    tc_path = os.path.join(work, "%s_%s_train_config" % (name, run))
    config_io.save_config(cfg_path, cfg)
    config_io.save_train_config(tc_path, tc)
    cmd = [sys.executable, os.path.join(HERE, "train_torch.py"), tc_path,
           cfg_path, "--dataset_root_dir", tree, "--dataset_split_file",
           os.path.join(tree, "3DOP_splits/train.txt"), "--device",
           device.type]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, "train_torch.py (%s, %s) exited %d:\n%s\n%s"
          % (name, run, res.returncode, res.stdout[-4000:],
             res.stderr[-4000:]))
    last = json.loads(res.stdout.strip().splitlines()[-1])
    return last, res.stdout, seconds, tc


def _check_train_run(last, stdout, tc, steps, first_step=0,
                     launches_per_frame=4):
    """Exit state of one CLI run: the steps it ran, 4 K1 and 4 K2
    launches per frame of every step (1 level-0 + 3 level-1; 0 on edge
    lists), a finite total loss every step, a checkpoint at the last
    step."""
    import numpy as np

    from pointgnn_tpu_torch.train import checkpoint as ckpt

    # every rank launches for its batch_size / ranks frames
    per_step = launches_per_frame * tc["batch_size"] // last["ranks"]
    check(last["steps"] == steps, "ran %d steps, want %d"
          % (last["steps"], steps))
    check(last["launches"] == {"slab_edge_max": per_step * steps,
                               "slab_edge_max_backward": per_step * steps},
          "launches %s over %d steps, want %d of each a step"
          % (last["launches"], steps, per_step))
    if first_step:
        check("Restored checkpoint at step %d" % first_step in stdout,
              "the run did not resume from step %d" % first_step)
    losses = last["total_loss"]
    check(len(losses) == steps and all(np.isfinite(v) for v in losses),
          "total losses %s over %d steps" % (losses, steps))
    steps_saved = ckpt.list_checkpoint_steps(tc["train_dir"])
    check(first_step + steps in steps_saved, "checkpoints %s, want step %d"
          % (steps_saved, first_step + steps))
    return dict(steps=steps, launches=last["launches"], losses=losses,
                checkpoints=steps_saved, step_ms=last["step_ms"],
                wait_ms=last["wait_ms"])


def capture_train_calls(trainer, frame_indices):
    """One train step of ``trainer`` on ``frame_indices`` with the
    arguments of every K2 call recorded (tables, coordinates, slab
    metadata, weights, K1's forward output and the cotangent), cloned
    before the optimizer moves the weights."""
    from pointgnn_tpu_torch.nn import slab

    calls = []
    orig = slab.slab_edge_max_backward

    def recording(table_a, src_xyz, table_b, ctr_xyz, offsets, center_cell,
                  weights, out, g, **opts):
        calls.append(dict(
            table_a=table_a.detach().clone(), src_xyz=src_xyz.clone(),
            table_b=table_b.detach().clone(), ctr_xyz=ctr_xyz.clone(),
            offsets=offsets.clone(), center_cell=center_cell.clone(),
            weights=[(w.detach().clone(), b.detach().clone())
                     for w, b in weights],
            out=out.clone(), g=g.clone(), **opts))
        return orig(table_a, src_xyz, table_b, ctr_xyz, offsets,
                    center_cell, weights, out, g, **opts)

    recording.launches = 0  # the wrapped function counts on its name
    slab.slab_edge_max_backward = recording
    try:
        trainer.train_batch(frame_indices=frame_indices)
    finally:
        slab.slab_edge_max_backward = orig
    return calls


def train_k1_k2_check(calls, num_points):
    """Every K1 and K2 call of one step against the plain versions (f32):
    K1's output in the step and a fresh K1 launch bitwise equal to the
    plain forward, K2 within ``BWD_TOL`` per gradient tensor, and each
    frame's level-0 and level-1 pair lists equal to the plain
    enumeration.  Returns one row per call and the first level-0 and
    level-1 call of the step (for timing)."""
    import torch

    from pointgnn_tpu_torch.nn import slab

    rows, first = [], {}
    seen_meta = set()
    for i, call in enumerate(calls):
        args = {k: v for k, v in call.items()
                if k not in ("out", "g", "block_centers")}
        check(args.pop("compute_dtype") == "float32",
              "K2 call %d is not f32" % i)
        level = 0 if args["table_a"].shape[0] == num_points else 1
        fresh = slab.slab_edge_max(**args, compute_dtype="float32")
        torch.cuda.synchronize()
        ref_out = slab.slab_edge_max_reference(**args,
                                               compute_dtype="float32")
        check(torch.equal(call["out"], ref_out),
              "call %d (L%d): K1's output in the step is not the plain "
              "forward (max %.3g)" % (i, level, (call["out"] - ref_out).abs()
                                      .max().item()))
        check(torch.equal(fresh, ref_out),
              "call %d (L%d): K1 is not bitwise the plain forward" % (i,
                                                                      level))
        kw = dict(args, compute_dtype="float32")
        got = slab.slab_edge_max_backward(**kw, out=call["out"], g=call["g"])
        torch.cuda.synchronize()
        ref = slab.slab_edge_max_backward_reference(**kw, out=ref_out,
                                                    g=call["g"])
        err = 0.0
        for j, (x, z) in enumerate(zip(_flat_grads(got), _flat_grads(ref))):
            check(x.shape == z.shape and bool(torch.isfinite(x).all()),
                  "call %d (L%d) gradient %d: shape or non-finite"
                  % (i, level, j))
            e = (x - z).abs().max().item()
            scale = z.abs().max().item()
            check(e <= BWD_TOL * (1 + scale),
                  "call %d (L%d) gradient %d: K2 vs plain %.3g > %.3g * (1 "
                  "+ %.3g)" % (i, level, j, e, BWD_TOL, scale))
            err = max(err, e)
        row = dict(level=level, P=args["table_a"].shape[0],
                   K=args["table_b"].shape[0], k2_max_abs_err=err)
        key = (level, args["offsets"].cpu().numpy().tobytes())
        if key not in seen_meta:  # each frame's levels, once
            seen_meta.add(key)
            row["pair_list"] = pair_list_check(args)
        rows.append(row)
        first.setdefault(level, (args, ref_out, call["g"]))
    return rows, first


def train_cli_phase(report, device):
    """Phase 12: training from the command line.  ``train_torch.py``
    trains car_auto_T3 (4 steps, then resumed to 6) and ped_cyl (2 steps)
    on a synthetic KITTI tree with Car, Pedestrian and Cyclist; then one
    ped_cyl step in this process with every K1/K2 call held against the
    plain versions, and the fetch timed per frame."""
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.train import device_pipeline as dpipe
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.train.trainer import Trainer
    from pointgnn_tpu_torch.utils import synthetic_kitti

    work = TRAIN_CLI_WORK
    shutil.rmtree(work, ignore_errors=True)
    tree = os.path.join(work, "kitti")
    synthetic_kitti.main(tree, TRAIN_CLI_FRAMES, classes=TRAIN_CLI_CLASSES,
                         n_ground=TRAIN_CLI_N_GROUND)
    common = dict(save_every_epoch=1, num_load_dataset_workers=2)
    car = "car_auto_T3_train"
    runs = {}
    last, out, secs, tc = _train_cli(work, car, tree, device, "first",
                                     max_steps=4, initial_lr=CAR_CLI_LR,
                                     **common)
    runs["car"] = dict(_check_train_run(last, out, tc, 4), seconds=secs)
    last, out, secs, tc = _train_cli(work, car, tree, device, "resume",
                                     max_steps=6, initial_lr=CAR_CLI_LR,
                                     **common)
    runs["car_resume"] = dict(_check_train_run(last, out, tc, 2, 4),
                              seconds=secs)
    ped = "ped_cyl_auto_T3_trainval"
    last, out, secs, tc = _train_cli(work, ped, tree, device, "first",
                                     max_steps=2, **common)
    runs["ped_cyl"] = dict(_check_train_run(last, out, tc, 2), seconds=secs)
    k1 = sum(r["launches"]["slab_edge_max"] for r in runs.values())
    k2 = sum(r["launches"]["slab_edge_max_backward"] for r in runs.values())
    step_ms = runs["car"]["step_ms"][1:] + runs["car_resume"]["step_ms"][1:]
    wait_ms = runs["car"]["wait_ms"][1:] + runs["car_resume"]["wait_ms"][1:]

    def trainer_on_tree(name, tag, **overrides):
        cfg, tc = train_cli_configs(name)
        tc.update(train_dir=os.path.join(work, tag),
                  num_load_dataset_workers=0, **overrides)
        spec = DatasetSpec.from_kitti_root(
            tree, os.path.join(tree, "3DOP_splits/train.txt"),
            cfg["num_classes"])
        return tc, Trainer(cfg, tc, FetchSpec(spec, cfg, tc),
                           num_frames=TRAIN_CLI_FRAMES, device=device)

    # the shipped learning rate on this tree (reported, not checked)
    tc, trainer = trainer_on_tree(car, "probe")
    probe = []
    try:
        for s in range(LR_PROBE_STEPS):
            aux = trainer.train_batch(frame_indices=[
                (s % 2) * 4 + i for i in range(tc["batch_size"])])
            probe.append(float(aux["total_loss"]))
    finally:
        trainer.close()

    # one car step on the tree's frames split into K1, K2 and the rest
    tc, trainer = trainer_on_tree(car, "split", initial_lr=CAR_CLI_LR)
    try:
        batch = trainer.prepare_batch(list(range(tc["batch_size"])))
        trainer.train_batch(prepared=batch)  # warm-up
        state, _, split_wall, split_k1, split_k2, _ = _split_step(
            trainer.step_fn, trainer.state, batch)
        trainer.state = state
    finally:
        trainer.close()
    split = dict(wall_ms=split_wall, K1_ms=split_k1, K2_ms=split_k2,
                 rest_ms=split_wall - split_k1 - split_k2)

    # one ped_cyl step in this process, every K1/K2 call captured
    tc, trainer = trainer_on_tree(ped, "capture")
    try:
        dspec = trainer.device_spec
        calls = capture_train_calls(trainer, list(range(tc["batch_size"])))
    finally:
        trainer.close()
    per_step = 4 * tc["batch_size"]
    check(len(calls) == per_step, "the ped_cyl step made %d K2 calls, want "
          "%d" % (len(calls), per_step))
    rows, first = train_k1_k2_check(calls, dspec.num_points)
    levels = {}
    for level, (args, ref_out, g) in sorted(first.items()):
        kw = dict(args, compute_dtype="float32")
        pairs = slab.inradius_pair_count(
            args["src_xyz"], args["ctr_xyz"], args["offsets"],
            args["center_cell"], args["grid_g"], args["radius"],
            args["halo"])
        winners = slab.winner_counts(**kw, out=ref_out)
        b2 = bound(args, pairs, PEAK_F32_FLOPS, winners)
        b1 = bound(args, pairs, PEAK_F32_FLOPS)
        levels["L%d" % level] = dict(
            P=args["table_a"].shape[0], K=args["table_b"].shape[0],
            widths=[args["table_a"].shape[1]] + [
                w.shape[1] for w, _ in args["weights"]],
            radius=args["radius"], inradius_pairs=pairs,
            winner_entries=winners[0], winning_pairs=winners[1],
            K1=dict(ms=time_ms(lambda: slab.slab_edge_max(**kw), runs=5,
                               warmup=1),
                    plain_ms=time_ms(
                        lambda: slab.slab_edge_max_reference(**kw), runs=3,
                        warmup=1),
                    bound_ms=b1[0], bound_by=b1[1]),
            K2=dict(ms=time_ms(lambda: slab.slab_edge_max_backward(
                        **kw, out=ref_out, g=g), runs=5, warmup=1),
                    plain_ms=time_ms(
                        lambda: slab.slab_edge_max_backward_reference(
                            **kw, out=ref_out, g=g), runs=3, warmup=1),
                    bound_ms=b2[0], bound_by=b2[1]),
        )

    # host fetch per frame (KITTI read, shipped augmentation, packing),
    # as the provider's workers run it
    cfg, tc = train_cli_configs(car)
    fspec = FetchSpec(DatasetSpec.from_kitti_root(
        tree, os.path.join(tree, "3DOP_splits/train.txt"),
        cfg["num_classes"]), cfg, tc,
        device_spec=dpipe.resolve_device_setup(
            cfg, tc.get("device_graph_spec"))[0])
    fetch = dpipe.build_device_fetch(fspec)
    fetch_ms = []
    for i in range(TRAIN_CLI_FRAMES):
        t0 = time.perf_counter()
        fetch(i, i)
        fetch_ms.append(1e3 * (time.perf_counter() - t0))
    report["train_cli"] = dict(
        frames=TRAIN_CLI_FRAMES, n_ground=TRAIN_CLI_N_GROUND, runs=runs,
        launches=dict(K1=k1, K2=k2),
        median_step_ms_after_first=statistics.median(step_ms),
        median_wait_ms_after_first=statistics.median(wait_ms),
        first_step_wait_ms=runs["car"]["wait_ms"][0],
        fetch_ms_per_frame=fetch_ms,
        median_fetch_ms_per_frame=statistics.median(fetch_ms),
        ped_cyl_calls=rows, ped_cyl_levels=levels,
        car_lr=CAR_CLI_LR, shipped_lr_total_loss=probe, split_step=split,
    )
    for key, r in runs.items():
        print("phase 12: train_torch.py %s: %d steps in %.1f s, launches %s, "
              "checkpoints %s, losses %s, step ms %s, wait ms %s"
              % (key, r["steps"], r["seconds"], r["launches"],
                 r["checkpoints"], [round(v, 5) for v in r["losses"]],
                 [round(v, 1) for v in r["step_ms"]],
                 [round(v, 1) for v in r["wait_ms"]]), flush=True)
    print("phase 12: car_auto_T3 batch %d: median %.1f ms per step after "
          "the first, the loop waited %.3f ms (median) for its prefetched "
          "batch; fetch %.1f ms per frame (median of %d)"
          % (tc["batch_size"], statistics.median(step_ms),
             statistics.median(wait_ms), statistics.median(fetch_ms),
             len(fetch_ms)), flush=True)
    print("phase 12: one car step on the tree's frames, split: %.1f ms = K1 "
          "%.1f + K2 %.1f + rest %.1f" % (split_wall, split_k1, split_k2,
                                          split["rest_ms"]), flush=True)
    print("phase 12: car_auto_T3 at the shipped lr %g (the CLI runs use "
          "%g): total loss per step %s" % (
              train_cli_configs(car)[1]["initial_lr"], CAR_CLI_LR, probe),
          flush=True)
    print("phase 12: one ped_cyl step: %d K1/K2 calls, K1 bitwise equal to "
          "the plain forward (in the step and relaunched), K2 max_abs_err "
          "%.3g (tol %.3g * (1 + max|plain|)); %d pair lists equal the "
          "plain enumeration" % (
              len(rows), max(r["k2_max_abs_err"] for r in rows), BWD_TOL,
              sum("pair_list" in r for r in rows)), flush=True)
    for key, lv in levels.items():
        print("phase 12: ped_cyl %s P=%d K=%d radius %.1f pairs=%d (winner "
              "entries %d): K1 %.3f ms plain %.3f bound %.4f (%s); K2 %.3f "
              "ms plain %.3f bound %.4f (%s)"
              % (key, lv["P"], lv["K"], lv["radius"], lv["inradius_pairs"],
                 lv["winner_entries"], lv["K1"]["ms"], lv["K1"]["plain_ms"],
                 lv["K1"]["bound_ms"], lv["K1"]["bound_by"], lv["K2"]["ms"],
                 lv["K2"]["plain_ms"], lv["K2"]["bound_ms"],
                 lv["K2"]["bound_by"]), flush=True)
    return k1, k2, rows


# eval step card vs CPU: every loss term within this share of its CPU
# value (f32 through the model; the card's cuBLAS and the CPU's sums
# round in other orders), the metric counts equal
EVAL_TOL = 1e-5
# the card-vs-CPU eval step's graph (a tree frame holds ~6-7K points)
EVAL_SMALL_POINTS, EVAL_SMALL_KEYPOINTS = 8192, 2048
SMOKE_TIMEOUT = 900


def eval_k1_check(calls):
    """Every K1 call of one eval step (f32, the training spec): the
    output in the step and a fresh launch bitwise equal to the plain
    forward, and the level-0 and level-1 pair lists equal to the plain
    enumeration.  Returns one row per call."""
    import torch

    from pointgnn_tpu_torch.nn import slab

    rows = []
    for i, (args, out) in enumerate(calls):
        check(args["compute_dtype"] == "float32",
              "eval K1 call %d is %s, not f32" % (i, args["compute_dtype"]))
        fresh = slab.slab_edge_max(**args)
        torch.cuda.synchronize()
        ref = slab.slab_edge_max_reference(**args)
        check(torch.equal(out, ref), "eval K1 call %d: the output in the "
              "step is not the plain forward (max %.3g)"
              % (i, (out - ref).abs().max().item()))
        check(torch.equal(fresh, ref),
              "eval K1 call %d: K1 is not bitwise the plain forward" % i)
        row = dict(level=min(i, 1), P=args["table_a"].shape[0],
                   K=args["table_b"].shape[0], max_abs_err=0.0)
        if i < 2:  # the level-1 layers share their slab metadata
            row["pair_list"] = pair_list_check(args)
        rows.append(row)
    return rows


def eval_phase(report, device):
    """Phase 13: evaluation and the KITTI AP acceptance loop.
    ``eval_torch.py`` evaluates phase 12's car_auto_T3 checkpoints; one
    eval step's K1 calls are held against the plain forward at the
    training spec; one eval step on the card against the CPU; then
    ``smoke_train_eval_torch.py`` at its defaults trains, evaluates,
    serves and scores a synthetic KITTI tree."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.train import device_pipeline as dpipe
    from pointgnn_tpu_torch.train.evaluator import Evaluator
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.utils import config_io

    tree = os.path.join(TRAIN_CLI_WORK, "kitti")
    car_dir = os.path.join(TRAIN_CLI_WORK, "car_auto_T3_train")
    split = os.path.join(tree, "3DOP_splits/val.txt")
    work = os.path.join(HERE, "build", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    steps = ckpt.list_checkpoint_steps(car_dir)
    check(steps == [2, 4, 6], "phase 12 left checkpoints %s" % steps)

    # the eval CLI over phase 12's car run, as a user runs it
    eval_dir = os.path.join(work, "eval")
    ec = dict(configs.eval_config("Car"), train_dir=car_dir,
              eval_dir=eval_dir, max_step=steps[-1], eval_every_second=1)
    ec_path = os.path.join(work, "eval_config")
    config_io.save_train_config(ec_path, ec)
    cmd = [sys.executable, os.path.join(HERE, "eval_torch.py"), ec_path,
           "--dataset_root_dir", tree, "--dataset_split_file", split]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, "eval_torch.py exited %d:\n%s\n%s" % (
        res.returncode, res.stdout[-4000:], res.stderr[-4000:]))
    lines = res.stdout.strip().splitlines()
    check("Evaluating on %d frames" % TRAIN_CLI_FRAMES in lines,
          "eval_torch.py did not evaluate %d frames" % TRAIN_CLI_FRAMES)
    fps = [float(m.group(1)) for m in (
        re.match(r"^eval throughput: ([0-9.]+) frames/s", ln)
        for ln in lines) if m]
    check(len(fps) == len(steps), "eval throughput printed %d times for %d "
          "checkpoints" % (len(fps), len(steps)))
    cli_launches = json.loads(lines[-1])["launches"]
    want = {"slab_edge_max": 4 * TRAIN_CLI_FRAMES * len(steps),
            "slab_edge_max_backward": 0}
    check(cli_launches == want, "eval_torch.py launches %s, want %s (4 K1 a "
          "frame, no K2)" % (cli_launches, want))
    with open(os.path.join(eval_dir, "scalars.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    total = {r["step"]: r["value"] for r in rows if r["key"] == "total_loss"}
    check(sorted({r["step"] for r in rows}) == steps and sorted(total)
          == steps, "eval summaries for steps %s"
          % sorted({r["step"] for r in rows}))
    check(all(np.isfinite(v) for v in total.values()),
          "non-finite eval total_loss %s" % total)

    # every K1 call of one eval step at the training spec, in this process
    cfg = config_io.load_config(os.path.join(car_dir, "config"))
    frozen = config_io.load_train_config(os.path.join(car_dir,
                                                      "train_config"))
    dspec = DatasetSpec.from_kitti_root(tree, split, cfg["num_classes"])

    def evaluator(on, **extra):
        e = dict(ec, **extra)
        return Evaluator(cfg, e, FetchSpec(dspec, cfg, e, is_eval=True),
                         num_frames=TRAIN_CLI_FRAMES, train_config=frozen,
                         device=on)

    ev = evaluator(device)
    try:
        params = ckpt.restore_checkpoint(car_dir, step=steps[-1],
                                         device=device)[0]["params"]
        host_frame = ev.provider.provide(0)
        frame = dpipe.frames_to_device(host_frame, device)
        spec = ev.device_spec
        calls = capture_k1_calls(lambda: ev._eval_step(params, frame))
    finally:
        ev.close()
    check(len(calls) == 4, "an eval step made %d K1 calls, want 4"
          % len(calls))
    k1_rows = eval_k1_check(calls)
    levels = {}
    for level in (0, 1):
        args = calls[level][0]
        pairs = slab.inradius_pair_count(
            args["src_xyz"], args["ctr_xyz"], args["offsets"],
            args["center_cell"], args["grid_g"], args["radius"],
            args["halo"])
        b = bound(args, pairs, PEAK_F32_FLOPS)
        levels["L%d" % level] = dict(
            P=args["table_a"].shape[0], K=args["table_b"].shape[0],
            inradius_pairs=pairs, max_abs_err=0.0,
            ms=time_ms(lambda: slab.slab_edge_max(**args), runs=5, warmup=1),
            plain_ms=time_ms(lambda: slab.slab_edge_max_reference(**args),
                             runs=3, warmup=1),
            bound_ms=b[0], bound_by=b[1])

    # one eval step on the card against the CPU, at a small spec
    small = json.loads(json.dumps(spec._replace(
        num_points=EVAL_SMALL_POINTS, num_keypoints=EVAL_SMALL_KEYPOINTS)))
    outs = []
    for on in (device, torch.device("cpu")):
        ev = evaluator(on, device_graph_spec=small)
        try:
            p = ckpt.restore_checkpoint(car_dir, step=steps[-1],
                                        device=on)[0]["params"]
            aux = ev._eval_step(p, dpipe.frames_to_device(
                ev.provider.provide(0), on))
            outs.append({k: v.cpu().numpy() for k, v in aux.items()})
        finally:
            ev.close()
    gpu, cpu = outs
    loss_err = {}
    for key in ("cls_loss", "loc_loss", "reg_loss", "total_loss",
                "classwise_loc_loss"):
        err = float(np.abs(gpu[key] - cpu[key]).max())
        scale = float(np.abs(cpu[key]).max())
        check(err <= EVAL_TOL * scale, "eval step %s: card vs CPU %.3g > "
              "%g * %.3g" % (key, err, EVAL_TOL, scale))
        loss_err[key] = dict(max_abs_err=err, scale=scale)
    for key in ("confusion", "pr_pos_hist", "pr_neg_hist", "num_endpoint",
                "num_valid_endpoint"):
        check(np.array_equal(gpu[key], cpu[key]),
              "eval step %s: card and CPU counts differ" % key)

    # the acceptance loop's --device_graph recipe, as a user runs it
    smoke, ap_lines, smoke_s = run_smoke(os.path.join(work, "smoke"),
                                         "--device_graph")
    n_l1 = 1  # the smoke's Car T=1: one level-1 layer
    per_frame = 1 + n_l1
    smoke_k1 = sum(v["slab_edge_max"] for v in smoke["launches"].values())
    smoke_k2 = sum(v["slab_edge_max_backward"]
                   for v in smoke["launches"].values())
    check(smoke["launches"]["train"] == {
        "slab_edge_max": per_frame * smoke["steps"],
        "slab_edge_max_backward": per_frame * smoke["steps"],
        "edge_tail_max": 0, "fused_edge_max": 0},
        "smoke training launches %s over %d steps"
        % (smoke["launches"]["train"], smoke["steps"]))
    check(not any(smoke["launches"]["serve_host"].values()),
          "the smoke's host pass launched %s"
          % smoke["launches"]["serve_host"])
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(TRAIN_CLI_WORK, ignore_errors=True)
    report["eval"] = dict(
        cli=dict(seconds=cli_s, checkpoints=steps, frames=TRAIN_CLI_FRAMES,
                 frames_per_s=fps, total_loss=total,
                 launches=cli_launches),
        k1_calls=k1_rows, k1_levels=levels,
        card_vs_cpu=dict(points=EVAL_SMALL_POINTS,
                         keypoints=EVAL_SMALL_KEYPOINTS, tol=EVAL_TOL,
                         losses=loss_err),
        smoke=dict(smoke, seconds=smoke_s, ap_lines=ap_lines),
        launches=dict(eval_cli_K1=cli_launches["slab_edge_max"],
                      eval_cli_K2=cli_launches["slab_edge_max_backward"],
                      smoke_K1=smoke_k1, smoke_K2=smoke_k2),
    )
    print("phase 13: eval_torch.py evaluated car_auto_T3 checkpoints %s on "
          "%d frames in %.1f s: frames/s %s, total_loss %s, launches %s"
          % (steps, TRAIN_CLI_FRAMES, cli_s, fps,
             {k: round(v, 5) for k, v in total.items()}, cli_launches),
          flush=True)
    print("phase 13: one eval step on a tree frame: %d K1 calls bitwise "
          "equal to the plain forward (in the step and relaunched); %d pair "
          "lists equal the plain enumeration" % (
              len(k1_rows), sum("pair_list" in r for r in k1_rows)),
          flush=True)
    for key, lv in levels.items():
        print("phase 13: eval step %s P=%d K=%d f32 pairs=%d: K1 %.3f ms "
              "plain %.3f bound %.4f (%s)"
              % (key, lv["P"], lv["K"], lv["inradius_pairs"], lv["ms"],
                 lv["plain_ms"], lv["bound_ms"], lv["bound_by"]), flush=True)
    print("phase 13: eval step card vs CPU (%d points, %d keypoints, f32): "
          "%s; metric counts equal" % (
              EVAL_SMALL_POINTS, EVAL_SMALL_KEYPOINTS,
              {k: "%.3g of %.3g" % (v["max_abs_err"], v["scale"])
               for k, v in loss_err.items()}), flush=True)
    print_smoke(13, smoke, ap_lines, smoke_s)
    return cli_launches["slab_edge_max"], smoke_k1, smoke_k2, k1_rows


SMOKE_PASSES = ("host", "fast(on-device)")


def run_smoke(workdir, *flags):
    """``smoke_train_eval_torch.py`` in a subprocess, as a user runs it:
    exit 0, BEV moderate >= 85 on both serving passes (host-built and
    device-built graphs), 9 AP lines per pass.  Returns its JSON line, its
    AP lines and its wall seconds."""
    cmd = [sys.executable, os.path.join(HERE, "smoke_train_eval_torch.py"),
           workdir, *flags]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=SMOKE_TIMEOUT)
    smoke_s = time.perf_counter() - t0
    check(res.returncode == 0, "smoke_train_eval_torch.py %s exited "
          "%d:\n%s\n%s" % (" ".join(flags), res.returncode,
                            res.stdout[-6000:], res.stderr[-4000:]))
    lines = res.stdout.strip().splitlines()
    smoke = json.loads(lines[-1])
    check(smoke["passed"] and min(smoke["bev_moderate"].values()) >= 85.0,
          "smoke: BEV moderate %s" % smoke["bev_moderate"])
    ap_lines = [ln for ln in lines if ln.startswith(tuple(
        "[%s]" % p for p in SMOKE_PASSES))]
    check(len(ap_lines) == 9 * len(SMOKE_PASSES),
          "smoke printed %d AP lines" % len(ap_lines))
    check(any(ln.startswith("oracle: skipped") for ln in lines),
          "smoke did not report skipping the oracle")
    return smoke, ap_lines, smoke_s


def print_smoke(phase, smoke, ap_lines, smoke_s):
    for ln in ap_lines:
        print("phase %d: smoke %s" % (phase, ln), flush=True)
    print("phase %d: smoke_train_eval_torch.py (%s recipe) in %.1f s: BEV "
          "moderate (min over classes) %s, 3D moderate (mean) %s; %d steps "
          "in %.1f s (%.2f steps/s, median %.2f ms after the first, median "
          "wait %.2f ms); eval %.2f s (%.1f frames/s); launches %s"
          % (phase, smoke["recipe"], smoke_s, smoke["bev_moderate"],
             smoke["3d_moderate"], smoke["steps"], smoke["train_s"],
             smoke["steps_per_s"], smoke["median_step_ms_after_first"],
             smoke["median_wait_ms_after_first"], smoke["eval_s"],
             smoke["eval_frames_per_s"], smoke["launches"]), flush=True)
    for key, p in smoke["serve"].items():
        print("phase %d: smoke serving %s: %.2f s, ms per frame %s; KITTI "
              "conversion ms per frame (median) %.3f; detections per frame "
              "%s%s" % (phase, key, p["serve_s"],
                        {k: round(v, 3) for k, v in
                         p["serve_ms_per_frame"].items()},
                        statistics.median(p["kitti_conversion_ms_per_frame"]),
                        p["detections_per_frame"],
                        "; capacity %s" % p["capacity"] if "capacity" in p
                        else ""), flush=True)


HOST_SMALL_POINTS = 8192
HOST_TOL = 1e-3  # |card - cpu| <= tol * (1 + |cpu|), f32 on both
HOST_TRAIN_STEPS = 4
HOST_WORK = os.path.join(HERE, "build", "chip_smoke_host")
HOST_BUCKETS = ("fetch input", "gen graph", "gnn inference", "decode box",
                "nms", "total")


def _check_label_files(out_dir, names, label_map):
    import numpy as np

    classes = set(label_map) - {"Background", "DontCare"}
    files = sorted(os.listdir(os.path.join(out_dir, "data")))
    check(files == [n + ".txt" for n in names], "label files %s" % files)
    lines = 0
    for name in files:
        with open(os.path.join(out_dir, "data", name)) as f:
            rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
        for row in rows:
            check(len(row) == 16, "%s: %d fields" % (name, len(row)))
            check(row[0] in classes, "%s: class %r" % (name, row[0]))
            check(np.isfinite(np.float64(row[4:])).all(),
                  "%s: non-finite field" % name)
        lines += len(rows)
    return lines


def _edge_set_diff(pts, ctr, radius, native_edges, plain_edges):
    """Pairs found by one search only; each must sit on the radius
    boundary (the native search tests distances in float64, the numpy
    one in float32).  Returns the count."""
    import numpy as np

    a = set(map(tuple, native_edges.tolist()))
    b = set(map(tuple, plain_edges.tolist()))
    diff = np.array(sorted(a ^ b), dtype=np.int64).reshape(-1, 2)
    if len(diff):
        d = np.linalg.norm(pts[diff[:, 0]].astype(np.float64)
                           - ctr[diff[:, 1]].astype(np.float64), axis=1)
        check(np.all(np.abs(d - radius) <= 1e-5 * radius),
              "native and plain radius searches differ off the boundary: "
              "%s" % diff[np.abs(d - radius) > 1e-5 * radius][:5])
    return len(diff)


def host_graph_phase(report, device):
    """Phase 14: host-built graphs.  ``run_torch.py`` without ``--fast`` on
    a tree of phase 11's recipe; one host frame's graph build split and
    its device program timed, card against CPU; ``train_torch.py`` and
    ``eval_torch.py`` with ``"device_graph": false``; then
    ``smoke_train_eval_torch.py``'s host recipe."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.data.kitti import KittiDataset
    from pointgnn_tpu_torch.data.labels import LABEL_METHODS
    from pointgnn_tpu_torch.graph import builder, pad, radius, voxel
    from pointgnn_tpu_torch.infer import (InferencePipeline,
                                          select_input_features)
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.train.pipeline import (DatasetSpec, FetchSpec,
                                                   build_fetch)
    from pointgnn_tpu_torch.utils import config_io, synthetic_kitti

    work = HOST_WORK
    shutil.rmtree(work, ignore_errors=True)
    out = {}

    # 1. run_torch.py without --fast on a tree of phase 11's recipe
    tree, ck_dir, out_dir = (os.path.join(work, d)
                             for d in ("kitti", "ckpt", "out"))
    names = synthetic_kitti.main(tree, KITTI_FRAMES, n_ground=12000)
    cfg = configs.get_config("car_auto_T3_train")
    params = InferencePipeline(cfg, seed=0, device="cpu").params
    ckpt.save_checkpoint(ck_dir, 0, {"params": params}, config=cfg)
    cmd = [sys.executable, os.path.join(HERE, "run_torch.py"), ck_dir,
           "--dataset_root_dir", tree, "--output_dir", out_dir]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=900)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, "run_torch.py (host graphs) exited %d:\n%s\n"
          "%s" % (res.returncode, res.stdout[-4000:], res.stderr[-4000:]))
    lines = res.stdout.strip().splitlines()
    buckets = {}
    for ln in lines:
        m = re.match(r"^(.+): ([0-9.]+) ms/frame$", ln)
        if m:
            buckets[m.group(1)] = float(m.group(2))
    check(set(buckets) == set(HOST_BUCKETS),
          "run_dataset buckets %s" % sorted(buckets))
    launches = json.loads(lines[-1])["launches"]
    check(not any(launches.values()),
          "run_torch.py without --fast launched %s" % launches)
    n_lines = _check_label_files(out_dir, names,
                                 LABEL_METHODS[cfg["label_method"]][0])
    out["cli"] = dict(seconds=cli_s, frames=KITTI_FRAMES,
                      ms_per_frame=buckets, launches=launches,
                      detections=n_lines)
    print("phase 14: run_torch.py without --fast served %d frames in %.1f s "
          "(%d detections); ms per frame %s; launches %s"
          % (KITTI_FRAMES, cli_s, n_lines, buckets, launches), flush=True)

    # 2. one host frame in this process: the graph build split, the
    # native radius search against the plain one, the device program
    pipe = InferencePipeline(cfg, checkpoint_dir=ck_dir, device=device)
    ds = KittiDataset(
        os.path.join(tree, "image/training/image_2"),
        os.path.join(tree, "velodyne/training/velodyne/"),
        os.path.join(tree, "calib/training/calib/"),
        os.path.join(tree, "labels/training/label_2"),
        num_classes=cfg["num_classes"])
    pts = ds.get_cam_points_in_image_with_rgb(
        0, cfg.get("downsample_by_voxel_size"))
    gen = cfg["runtime_graph_gen_kwargs"]
    split, searches = {}, {}
    for _ in range(2):  # the second, warm round is kept
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        vcl, kil = voxel.multi_level_downsample_random(
            pts.xyz, gen["base_voxel_size"],
            [lc["graph_scale"] for lc in gen["level_configs"]],
            add_rnd3d=gen["add_rnd3d"], rng=rng)
        t1 = time.perf_counter()
        edges = []
        for lc in gen["level_configs"]:
            g = lc["graph_level"]
            edges.append(builder.get_graph_generate_fn(
                lc["graph_gen_method"])(vcl[g], vcl[g + 1], rng=rng,
                                        **lc["graph_gen_kwargs"]))
        t2 = time.perf_counter()
        frame = pad.FrameData(
            select_input_features(pts.attr, cfg["input_features"]),
            vcl, kil, edges)
        cap, _ = pad.grow_to_fit(pipe.capacity, [frame])
        padded = pad.pad_frame(frame, cap)
        t3 = time.perf_counter()
        graph = pad.to_device(padded, device)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        split = {"voxel_ms": 1e3 * (t1 - t0), "radius_ms": 1e3 * (t2 - t1),
                 "pad_ms": 1e3 * (t3 - t2), "copy_ms": 1e3 * (t4 - t3)}
    for li, lc in enumerate(gen["level_configs"]):
        g, kw = lc["graph_level"], lc["graph_gen_kwargs"]
        t0 = time.perf_counter()
        plain = radius.radius_neighbors(vcl[g], vcl[g + 1], kw["radius"],
                                        kw["num_neighbors"],
                                        use_native=False)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        nat = radius.radius_neighbors(vcl[g], vcl[g + 1], kw["radius"],
                                      kw["num_neighbors"])
        native_ms = 1e3 * (time.perf_counter() - t0)
        # uncapped: the seed draws nothing, so a rerun is bitwise equal
        check(kw["num_neighbors"] < 0, "the runtime graph is uncapped")
        check(np.array_equal(nat, edges[li]),
              "the native search is not deterministic")
        n_diff = _edge_set_diff(vcl[g], vcl[g + 1], kw["radius"], nat,
                                plain)
        searches["L%d" % li] = dict(
            points=len(vcl[g]), centers=len(vcl[g + 1]), edges=len(nat),
            native_ms=native_ms, plain_ms=plain_ms, boundary_diff=n_diff)

    def program():
        return pipe.host_graph_fn(pipe.params, graph)

    program()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    device_ms = time_ms(program, runs=5, warmup=1)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out["frame"] = dict(
        points=len(pts.xyz), vertices=[len(v) for v in vcl],
        edges=[len(e) for e in edges], capacity=[list(cap.vertices),
                                                 list(cap.edges)],
        gen_graph_split=split, radius_searches=searches,
        device_ms=device_ms, peak_device_gib=peak_gib)
    print("phase 14: frame 0 (%d points): vertices %s, edges %s, capacity "
          "%s; gen graph %s ms; device program %.3f ms, peak device memory "
          "%.2f GiB" % (len(pts.xyz), out["frame"]["vertices"],
                        out["frame"]["edges"], out["frame"]["capacity"],
                        {k: round(v, 3) for k, v in split.items()},
                        device_ms, peak_gib), flush=True)
    for key, row in searches.items():
        print("phase 14: radius search %s (%d points, %d centers, %d edges): "
              "native %.2f ms, plain numpy %.2f ms, %d pairs differ (on the "
              "radius boundary)" % (key, row["points"], row["centers"],
                                    row["edges"], row["native_ms"],
                                    row["plain_ms"], row["boundary_diff"]),
              flush=True)

    # the device program on the card against the CPU, one graph built
    # once, at HOST_SMALL_POINTS points
    small = pts.mask(np.arange(min(HOST_SMALL_POINTS, len(pts.xyz))))
    cpu_pipe = InferencePipeline(
        cfg, params=params_from_jax(params_to_numpy(pipe.params), "cpu"),
        capacity=pad.GraphCapacity((HOST_SMALL_POINTS, 4096, 4096),
                                   (65536, 262144)), device="cpu")
    sgraph = cpu_pipe.host_graph(small, np.random.default_rng(1))
    outs = [[t.cpu().numpy() for t in p.host_graph_fn(
        p.params, pad.to_device(sgraph, p.device))]
        for p in (pipe, cpu_pipe)]
    errs = {}
    for key, got, want in zip(("probs", "decoded"), *outs):
        check(np.isfinite(got).all(), "card %s not finite" % key)
        err = np.abs(got - want) / (1.0 + np.abs(want))
        check(err.max() <= HOST_TOL, "host program %s card vs CPU %.3g > %g"
              % (key, err.max(), HOST_TOL))
        errs[key] = float(np.abs(got - want).max())
    out["card_vs_cpu"] = dict(points=len(small.xyz), tol=HOST_TOL,
                              max_abs_err=errs)
    print("phase 14: host program card vs CPU (%d points, f32): max abs err "
          "%s (tol %g relative)" % (len(small.xyz), errs, HOST_TOL),
          flush=True)
    del pipe, cpu_pipe, graph
    torch.cuda.empty_cache()

    # 3. train_torch.py on host-built graphs, then eval_torch.py
    ttree = os.path.join(work, "train_kitti")
    synthetic_kitti.main(ttree, TRAIN_CLI_FRAMES, classes=TRAIN_CLI_CLASSES,
                         n_ground=TRAIN_CLI_N_GROUND)
    car = "car_auto_T3_train"
    # batch 2: the family's frame_capacity holds 2 frames (the shipped
    # batch 4 trains over 2 devices)
    last, stdout, secs, tc = _train_cli(
        work, car, ttree, device, "host", max_steps=HOST_TRAIN_STEPS,
        initial_lr=CAR_CLI_LR, device_graph=False, batch_size=2,
        save_every_epoch=1, num_load_dataset_workers=2)
    check(last["steps"] == HOST_TRAIN_STEPS, "host training ran %d steps"
          % last["steps"])
    check(not any(last["launches"].values()),
          "host training launched %s" % last["launches"])
    losses = last["total_loss"]
    check(len(losses) == HOST_TRAIN_STEPS
          and all(np.isfinite(v) for v in losses),
          "host training losses %s" % losses)
    steps = ckpt.list_checkpoint_steps(tc["train_dir"])
    check(HOST_TRAIN_STEPS in steps, "host checkpoints %s" % steps)
    # the worker's fetch (KITTI read, augmentation, host graph, labels)
    cfg_t, _ = train_cli_configs(car)
    fetch = build_fetch(FetchSpec(DatasetSpec.from_kitti_root(
        ttree, os.path.join(ttree, "3DOP_splits/train.txt"),
        cfg_t["num_classes"]), cfg_t, tc))
    fetch_ms = []
    for i in range(TRAIN_CLI_FRAMES):
        t0 = time.perf_counter()
        fetch(i, i)
        fetch_ms.append(1e3 * (time.perf_counter() - t0))
    # one host train step in this process: host wall time against the
    # card's busy time (torch.profiler), and the batch's preparation
    from pointgnn_tpu_torch.train.trainer import Trainer

    tc_in = dict(tc, train_dir=os.path.join(work, "in_process"),
                 num_load_dataset_workers=0)
    trainer = Trainer(cfg_t, tc_in, FetchSpec(DatasetSpec.from_kitti_root(
        ttree, os.path.join(ttree, "3DOP_splits/train.txt"),
        cfg_t["num_classes"]), cfg_t, tc_in), num_frames=TRAIN_CLI_FRAMES,
        device=device)
    try:
        prep_ms, wall_ms = [], []
        for i in range(4):
            t0 = time.perf_counter()
            batch = trainer.prepare_batch([2 * i, 2 * i + 1])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.train_batch(prepared=batch)
            torch.cuda.synchronize()
            prep_ms.append(1e3 * (t1 - t0))
            wall_ms.append(1e3 * (time.perf_counter() - t1))
        split = kernel_split(lambda: trainer.train_batch(prepared=batch))
    finally:
        trainer.close()
    busy = sum(split.values())
    step_wall = statistics.median(wall_ms[1:])
    out["train_step"] = dict(
        prepare_ms=prep_ms, wall_ms=wall_ms, device_busy_ms=busy,
        idle_share=1.0 - busy / step_wall,
        by_kernel=dict(list(short_split(split).items())[:8]))
    print("phase 14: one host train step in this process (batch 2): wall "
          "%.2f ms (median of 3 after the first), device busy %.2f ms "
          "(idle %.0f%%), batch preparation (fetch, union, pad, copy) %.1f "
          "ms; top kernels %s" % (step_wall, busy,
                                  100 * out["train_step"]["idle_share"],
                                  statistics.median(prep_ms),
                                  out["train_step"]["by_kernel"]),
          flush=True)
    out["train_cli"] = dict(
        seconds=secs, steps=last["steps"], losses=losses,
        launches=last["launches"], checkpoints=steps,
        median_step_ms_after_first=statistics.median(last["step_ms"][1:]),
        median_wait_ms_after_first=statistics.median(last["wait_ms"][1:]),
        fetch_ms_per_frame=fetch_ms)
    print("phase 14: train_torch.py (device_graph false, batch 2) %d steps "
          "in %.1f s: losses %s, median step %.2f ms after the first, "
          "median wait %.2f ms, fetch per frame (median) %.1f ms, launches "
          "%s" % (last["steps"], secs, [round(v, 4) for v in losses],
                  out["train_cli"]["median_step_ms_after_first"],
                  out["train_cli"]["median_wait_ms_after_first"],
                  statistics.median(fetch_ms), last["launches"]), flush=True)

    ec = dict(configs.eval_config("Car"), train_dir=tc["train_dir"],
              eval_dir=os.path.join(work, "eval"), max_step=steps[-1],
              eval_every_second=1)
    ec_path = os.path.join(work, "eval_config")
    config_io.save_train_config(ec_path, ec)
    cmd = [sys.executable, os.path.join(HERE, "eval_torch.py"), ec_path,
           "--dataset_root_dir", ttree, "--dataset_split_file",
           os.path.join(ttree, "3DOP_splits/val.txt")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    eval_s = time.perf_counter() - t0
    check(res.returncode == 0, "eval_torch.py (host graphs) exited %d:\n%s\n"
          "%s" % (res.returncode, res.stdout[-4000:], res.stderr[-4000:]))
    lines = res.stdout.strip().splitlines()
    fps = [float(m.group(1)) for m in (
        re.match(r"^eval throughput: ([0-9.]+) frames/s", ln)
        for ln in lines) if m]
    check(len(fps) == len(steps), "eval throughput printed %d times for %d "
          "checkpoints" % (len(fps), len(steps)))
    grown = [ln for ln in lines if ln.startswith("eval capacity grown")]
    eval_launches = json.loads(lines[-1])["launches"]
    check(not any(eval_launches.values()),
          "host evaluation launched %s" % eval_launches)
    with open(os.path.join(work, "eval", "scalars.jsonl")) as f:
        total = {r["step"]: r["value"] for r in map(json.loads, f)
                 if r["key"] == "total_loss"}
    check(sorted(total) == steps and all(np.isfinite(v)
                                         for v in total.values()),
          "host eval total_loss %s" % total)
    out["eval_cli"] = dict(seconds=eval_s, checkpoints=steps,
                           frames_per_s=fps, capacity_growth=grown,
                           total_loss=total, launches=eval_launches)
    print("phase 14: eval_torch.py (host graphs) evaluated checkpoints %s "
          "in %.1f s: frames/s %s, total_loss %s, capacity growth %s"
          % (steps, eval_s, fps, {k: round(v, 5) for k, v in total.items()},
             grown or "none"), flush=True)

    # 4. the acceptance loop's default (host) recipe
    smoke, ap_lines, smoke_s = run_smoke(os.path.join(work, "smoke"))
    check(smoke["recipe"] == "host", "smoke recipe %s" % smoke["recipe"])
    # K1 runs only in the fast pass: 2 launches a frame (Car T=1)
    want = {k: 0 for k in kernel_wrappers()}
    check(all(smoke["launches"][stage] == want
              for stage in ("train", "eval", "serve_host"))
          and smoke["launches"]["serve_fast"] == dict(
              want, slab_edge_max=2 * len(
                  smoke["serve"]["fast"]["detections_per_frame"])),
          "the host smoke launched %s" % smoke["launches"])
    out["smoke"] = dict(smoke, seconds=smoke_s, ap_lines=ap_lines)
    print_smoke(14, smoke, ap_lines, smoke_s)
    shutil.rmtree(work, ignore_errors=True)
    report["host_graph"] = out
    return out


EDGE_WORK = os.path.join(HERE, "build", "chip_smoke_edges")
EDGE_STEPS, EDGE_RESUME_STEPS = 4, 6
# the union step card vs CPU: loss terms at this relative tolerance,
# gradients at GRAD_TOL of (1 + max|g|)
EDGE_LOSS_TOL = 1e-5
EDGE_SMALL_POINTS, EDGE_SMALL_KEYPOINTS = 4096, 2048
# batch norm: car_auto_T3 at width 300 with every MLP normalized by
# fused_BN_center, batch 1 on host-built graphs (the routing of a BN
# config), unchunked (its statistics are over the whole edge list)
BN_DEPTH = 3  # GNN layers kept: car_auto_T3's full depth
BN_STEPS = 3
BN_PEAK_GIB = 60.0
CODECS = ("direct_encoding", "center_box_encoding", "voxelnet_box_encoding",
          "classaware_voxelnet_box_encoding",
          "classaware_all_class_box_encoding",
          "classaware_all_class_box_canonical_encoding")


def _normalized_config(norm, depth=3):
    """car_auto_T3 at width 300 with ``depth`` GNN layers and every MLP
    normalized by ``norm``."""
    from pointgnn_tpu_torch import configs

    cfg = configs.get_config("car_auto_T3_train")
    lcs = cfg["model_kwargs"]["layer_configs"]
    lcs[:] = lcs[:1 + depth] + lcs[-1:]
    for lc in lcs:
        for key in lc["kwargs"]:
            if key.endswith("normalization_type"):
                lc["kwargs"][key] = norm
    return cfg


def _program_card_vs_cpu(cfg, params_np, graph, device):
    """The host-graph device program (forward, softmax, box decode) of
    ``cfg`` on one padded graph, card against CPU with the same
    parameters: the largest error of the probabilities and the decoded
    boxes, each within ``HOST_TOL`` of ``(1 + |cpu|)``."""
    import numpy as np

    from pointgnn_tpu_torch.graph import pad
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.params import params_from_jax

    outs = []
    for dev in (device, "cpu"):
        pipe = InferencePipeline(cfg, params=params_from_jax(params_np, dev),
                                 device=dev)
        outs.append([t.cpu().numpy() for t in pipe.host_graph_fn(
            pipe.params, pad.to_device(graph, pipe.device))])
    errs = {}
    for key, got, want in zip(("probs", "decoded"), *outs):
        check(np.isfinite(got).all(), "card %s not finite" % key)
        err = np.abs(got - want) / (1.0 + np.abs(want))
        check(err.max() <= HOST_TOL, "%s card vs CPU %.3g > %g"
              % (key, err.max(), HOST_TOL))
        errs[key] = float(np.abs(got - want).max())
    return errs


def edge_training_phase(report, device):
    """Phase 15: edge-list training and the model options.
    ``train_torch.py`` on device-built edge lists (``device_graph_slab:
    false``), resumed, and ``eval_torch.py`` over its checkpoints; one
    such step in this process (launches, peak memory, device split) and a
    union step card vs CPU; a batch-norm config trained through
    ``Trainer`` and served; instance norm, the six box codecs and the
    separated predictor card vs CPU."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.data.kitti import KittiDataset
    from pointgnn_tpu_torch.graph import device_builder as db, pad
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.nn import mlp
    from pointgnn_tpu_torch.params import params_from_jax, params_to_numpy
    from pointgnn_tpu_torch.parallel import step as step_lib
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.train import optimizers
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.train.trainer import Trainer
    from pointgnn_tpu_torch.utils import config_io, synthetic_kitti

    work = EDGE_WORK
    shutil.rmtree(work, ignore_errors=True)
    card = card_line()
    out = {"card": card}
    launches = {name: 0 for name in kernel_wrappers()}

    def count(counts):
        for name, n in counts.items():
            launches[name] += n

    # 1. train_torch.py on edge lists (phase 12's recipe), then resumed
    tree = os.path.join(work, "kitti")
    synthetic_kitti.main(tree, TRAIN_CLI_FRAMES, classes=TRAIN_CLI_CLASSES,
                         n_ground=TRAIN_CLI_N_GROUND)
    car = "car_auto_T3_train"
    common = dict(initial_lr=CAR_CLI_LR, device_graph_slab=False,
                  save_every_epoch=1, num_load_dataset_workers=2)
    runs = {}
    for run, steps, first in (("first", EDGE_STEPS, 0),
                              ("resume", EDGE_RESUME_STEPS, EDGE_STEPS)):
        last, stdout, secs, tc = _train_cli(work, car, tree, device,
                                            "edges_" + run,
                                            max_steps=steps, **common)
        runs[run] = dict(_check_train_run(last, stdout, tc, steps - first,
                                          first, launches_per_frame=0),
                         seconds=secs)
        count(last["launches"])
    frozen = config_io.load_train_config(os.path.join(tc["train_dir"],
                                                      "train_config"))
    check(frozen["device_graph"] is True
          and frozen["device_graph_slab"] is False,
          "frozen routing %s / %s" % (frozen["device_graph"],
                                      frozen["device_graph_slab"]))
    step_ms = runs["first"]["step_ms"][1:] + runs["resume"]["step_ms"][1:]
    wait_ms = runs["first"]["wait_ms"][1:] + runs["resume"]["wait_ms"][1:]
    out["train_cli"] = dict(
        runs=runs, frozen_device_graph_slab=frozen["device_graph_slab"],
        median_step_ms_after_first=statistics.median(step_ms),
        median_wait_ms_after_first=statistics.median(wait_ms))
    print("phase 15: train_torch.py on edge lists (device_graph_slab "
          "false, batch 4): %d steps (%.1f s) then resumed to %d (%.1f s), "
          "losses %s / %s, median step %.2f ms after the first, median wait "
          "%.3f ms, launches %s; frozen device_graph_slab %s [%s]"
          % (EDGE_STEPS, runs["first"]["seconds"], EDGE_RESUME_STEPS,
             runs["resume"]["seconds"],
             [round(v, 4) for v in runs["first"]["losses"]],
             [round(v, 4) for v in runs["resume"]["losses"]],
             out["train_cli"]["median_step_ms_after_first"],
             out["train_cli"]["median_wait_ms_after_first"],
             {k: launches[k] for k in launches}, frozen["device_graph_slab"],
             card), flush=True)

    # 2. one edge-list step in this process: every kernel's launches,
    # peak device memory, wall against device busy time
    cfg, _ = train_cli_configs(car)
    tc_in = dict(tc, train_dir=os.path.join(work, "in_process"),
                 num_load_dataset_workers=0)
    spec = DatasetSpec.from_kitti_root(
        tree, os.path.join(tree, "3DOP_splits/train.txt"),
        cfg["num_classes"])
    trainer = Trainer(cfg, tc_in, FetchSpec(spec, cfg, tc_in),
                      num_frames=TRAIN_CLI_FRAMES, device=device)
    try:
        m = trainer.model
        check(m.slab_level0 is None and m.slab_level1 is None
              and m.edge_sentinel == "src" and m.edge_chunks == 16,
              "the edge-list trainer's model is not on the segment path")
        batches = [trainer.prepare_batch(list(range(4 * i, 4 * i + 4)))
                   for i in range(2)]
        trainer.train_batch(prepared=batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        wall = []
        for b in (batches[1], batches[0], batches[1]):
            t0 = time.perf_counter()
            aux = trainer.train_batch(prepared=b)
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t0))
            check(np.isfinite(float(aux["total_loss"])),
                  "edge-list step loss %s" % float(aux["total_loss"]))
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        split = kernel_split(lambda: trainer.train_batch(
            prepared=batches[0]), calls=1)
    finally:
        trainer.close()
    count(counts)
    check(not any(counts.values()), "the edge-list step launched %s"
          % counts)
    busy = sum(split.values())
    step = statistics.median(wall)
    out["train_step"] = dict(wall_ms=wall, device_busy_ms=busy,
                             idle_share=1.0 - busy / step,
                             peak_device_gib=peak_gib, launches=counts,
                             by_kernel=dict(list(short_split(
                                 split).items())[:8]))
    print("phase 15: one edge-list step in this process (batch 4): wall "
          "%.2f ms (median of 3), device busy %.2f ms (idle %.0f%%), peak "
          "device memory %.2f GiB, launches %s; top kernels %s [%s]"
          % (step, busy, 100 * out["train_step"]["idle_share"], peak_gib,
             counts, out["train_step"]["by_kernel"], card), flush=True)
    del batches, trainer
    torch.cuda.empty_cache()

    # 3. eval_torch.py over the edge-list checkpoints
    steps = ckpt.list_checkpoint_steps(tc["train_dir"])
    ec = dict(configs.eval_config("Car"), train_dir=tc["train_dir"],
              eval_dir=os.path.join(work, "eval"), max_step=steps[-1],
              eval_every_second=1)
    ec_path = os.path.join(work, "eval_config")
    config_io.save_train_config(ec_path, ec)
    cmd = [sys.executable, os.path.join(HERE, "eval_torch.py"), ec_path,
           "--dataset_root_dir", tree, "--dataset_split_file",
           os.path.join(tree, "3DOP_splits/val.txt"), "--device",
           device.type]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    eval_s = time.perf_counter() - t0
    check(res.returncode == 0, "eval_torch.py (edge lists) exited %d:\n%s\n"
          "%s" % (res.returncode, res.stdout[-4000:], res.stderr[-4000:]))
    lines = res.stdout.strip().splitlines()
    fps = [float(mt.group(1)) for mt in (
        re.match(r"^eval throughput: ([0-9.]+) frames/s", ln)
        for ln in lines) if mt]
    check(len(fps) == len(steps), "eval throughput printed %d times for %d "
          "checkpoints" % (len(fps), len(steps)))
    eval_launches = json.loads(lines[-1])["launches"]
    count(eval_launches)
    check(not any(eval_launches.values()),
          "edge-list evaluation launched %s" % eval_launches)
    with open(os.path.join(work, "eval", "scalars.jsonl")) as f:
        total = {r["step"]: r["value"] for r in map(json.loads, f)
                 if r["key"] == "total_loss"}
    check(sorted(total) == steps and all(np.isfinite(v)
                                         for v in total.values()),
          "edge-list eval total_loss %s" % total)
    out["eval_cli"] = dict(seconds=eval_s, checkpoints=steps,
                           frames_per_s=fps, total_loss=total,
                           launches=eval_launches)
    print("phase 15: eval_torch.py (edge lists) evaluated checkpoints %s in "
          "%.1f s: frames/s %s, total_loss %s [%s]"
          % (steps, eval_s, fps, {k: round(v, 5) for k, v in total.items()},
             card), flush=True)

    # 4. one edge-list union step, card vs CPU: full width, reduced
    # capacity, the same injected graph randomization
    small = db.spec_from_config(cfg, num_points=EDGE_SMALL_POINTS,
                                num_keypoints=EDGE_SMALL_KEYPOINTS,
                                runtime=False)
    gen = torch.Generator().manual_seed(3)
    draws = [db.draw_randomization(small.num_points, gen) for _ in range(2)]
    parity, params_np, paths = {}, None, None
    reset_counts()
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        _, _, dspec, model, builder, loss_cfg = _train_setup(dev, small,
                                                             slab=False)
        if params_np is None:
            params_np = params_to_numpy(model.init(seed=2, device="cpu"))
        params = params_from_jax(params_np, dev)
        leaves = optimizers.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        sums = step_lib.make_union_sums_fn(model, loss_cfg, builder, 2)
        batch = _train_frames(cfg, dspec, (20, 21), dev, lower_labels=True,
                              n_beams=32, points_per_beam=120)
        acc, reg = sums(params, batch, [tuple(x.to(dev) for x in d)
                                        for d in draws])
        cls = acc["cls_w"] / torch.clamp(acc["n_ep"], min=1.0)
        loc = acc["loc_w"] / torch.clamp(acc["n_val"], min=1.0)
        total_loss = cls + loc + reg
        total_loss.backward()
        parity[name] = dict(
            losses=[float(x.detach()) for x in (total_loss, cls, loc, reg)],
            n_val=float(acc["n_val"]),
            grads=[t.grad.detach().cpu().numpy() if t.grad is not None
                   else np.zeros(tuple(t.shape), np.float32)
                   for t in leaves])
        paths = _leaf_paths(params)
    counts = read_counts()
    count(counts)
    check(not any(counts.values()), "the card's union step launched %s"
          % counts)
    check(parity["card"]["n_val"] == parity["cpu"]["n_val"] > 0,
          "localization targets differ: %s"
          % {k: r["n_val"] for k, r in parity.items()})
    gap = _compare_runs(parity["card"], parity["cpu"], paths)
    check(gap["loss_rel_err"] <= EDGE_LOSS_TOL,
          "edge-list losses card vs CPU: rel %.3g > %g"
          % (gap["loss_rel_err"], EDGE_LOSS_TOL))
    for path, g in zip(paths, gap["grad_err_scaled"]):
        check(g <= GRAD_TOL, "edge-list gradient %s: card vs CPU %.3g of (1 "
              "+ max|g|) > %.3g" % (path, g, GRAD_TOL))
    out["card_vs_cpu"] = dict(num_points=small.num_points,
                              num_keypoints=small.num_keypoints,
                              n_val=parity["card"]["n_val"],
                              losses={k: r["losses"]
                                      for k, r in parity.items()},
                              loss_rel_err=gap["loss_rel_err"],
                              worst_grad_err_scaled=gap[
                                  "worst_grad_err_scaled"],
                              worst_leaf=gap["worst_leaf"])
    print("phase 15: edge-list union step card vs CPU (2 frames, %d points, "
          "%d keypoints, full width): losses rel err %.3g (tol %g), worst "
          "gradient err %.3g of (1 + max|g|) at %s (tol %g) [%s]"
          % (small.num_points, small.num_keypoints, gap["loss_rel_err"],
             EDGE_LOSS_TOL, gap["worst_grad_err_scaled"], gap["worst_leaf"],
             GRAD_TOL, card), flush=True)

    # 5. batch norm: train through Trainer on host graphs, then serve
    bn_cfg = _normalized_config("fused_BN_center", BN_DEPTH)
    bn_tc = dict(train_cli_configs(car)[1],
                 train_dir=os.path.join(work, "bn"), batch_size=1,
                 initial_lr=CAR_CLI_LR, num_load_dataset_workers=0)
    bn = Trainer(bn_cfg, bn_tc, FetchSpec(spec, bn_cfg, bn_tc),
                 num_frames=TRAIN_CLI_FRAMES, device=device)
    try:
        check(not bn.device_graph and bn.model._has_bn
              and bn.model.edge_chunks == 1,
              "the BN trainer is not on unchunked host graphs")
        rows = bn.capacity.edges[1]
        width = bn_cfg["model_kwargs"]["layer_configs"][1]["kwargs"][
            "edge_MLP_depth_list"][-1]
        est_gib = rows * (width + 3) * 4 / 2**30
        print("phase 15: BN step: %d padded level-1 edge rows x %d channels "
              "x 4 B = %.2f GiB per saved edge tensor, %d GNN layers; each "
              "layer's edge MLP is recomputed in the backward" % (
                  rows, width + 3, est_gib, BN_DEPTH), flush=True)
        def emas():
            return [t.detach().clone() for k, t in mlp.named_leaves(
                bn.state.params) if k in mlp.EMA_KEYS]

        before = emas()
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bn_ms, bn_losses = [], []
        for i in range(BN_STEPS):
            prepared = bn.prepare_batch([i])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = bn.train_batch(prepared=prepared)
            torch.cuda.synchronize()
            bn_ms.append(1e3 * (time.perf_counter() - t0))
            bn_losses.append(float(aux["total_loss"]))
        bn_peak = torch.cuda.max_memory_allocated() / 2**30
        after = emas()
        bn_params = params_to_numpy(bn.state.params)
    finally:
        bn.close()
    counts = read_counts()
    count(counts)
    check(not any(counts.values()), "the BN steps launched %s" % counts)
    check(all(np.isfinite(v) for v in bn_losses), "BN losses %s"
          % bn_losses)
    check(bn_peak < BN_PEAK_GIB, "BN peak device memory %.2f GiB" % bn_peak)
    ema_change = max(float((a - b).abs().max()) for a, b in
                     zip(after, before))
    check(np.isfinite(ema_change) and ema_change > 0,
          "the moving averages did not move (%s)" % ema_change)
    del bn
    torch.cuda.empty_cache()
    # test mode, on a device-built graph: slab and tail resolve off
    ds = KittiDataset(
        os.path.join(tree, "image/training/image_2"),
        os.path.join(tree, "velodyne/training/velodyne/"),
        os.path.join(tree, "calib/training/calib/"),
        os.path.join(tree, "labels/training/label_2"),
        num_classes=bn_cfg["num_classes"])
    pts = ds.get_cam_points_in_image_with_rgb(
        0, bn_cfg.get("downsample_by_voxel_size"))
    pipe = InferencePipeline(bn_cfg, params=params_from_jax(bn_params,
                                                            device),
                             on_device_graph=True, device=device)
    check(pipe.slab is False and pipe.pallas_tail is False
          and pipe.model.mode == "test" and pipe.model.edge_chunks == 1,
          "BN serving: slab %s, tail %s" % (pipe.slab, pipe.pallas_tail))
    reset_counts()
    _, boxes, scores, _ = pipe.run_frame(pts)
    counts = read_counts()
    count(counts)
    check(not any(counts.values()), "BN serving launched %s" % counts)
    check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
          "BN serving gave non-finite boxes")
    out["bn"] = dict(depth=BN_DEPTH, rows=rows, est_gib_per_tensor=est_gib,
                     step_ms=bn_ms, losses=bn_losses, peak_device_gib=bn_peak,
                     max_ema_change=ema_change, serve_detections=len(boxes),
                     serve_slab=pipe.slab, serve_tail=pipe.pallas_tail)
    print("phase 15: BN (fused_BN_center everywhere, car_auto_T3 width %d, "
          "%d GNN layers, batch 1, host graphs): %d steps, ms %s, losses %s, "
          "peak device memory %.2f GiB (limit %g), largest EMA change %.4g; "
          "served one frame in test mode on a device-built graph (slab %s, "
          "tail %s, %d detections) [%s]"
          % (width, BN_DEPTH, BN_STEPS, [round(v, 2) for v in bn_ms],
             [round(v, 4) for v in bn_losses], bn_peak, BN_PEAK_GIB,
             ema_change, pipe.slab, pipe.pallas_tail, len(boxes), card),
          flush=True)
    del pipe
    torch.cuda.empty_cache()

    # 6. instance norm, the six codecs and the separated predictor: one
    # forward and box decode on a host graph of tree frame 0, card vs CPU
    small_pts = pts.mask(np.arange(min(HOST_SMALL_POINTS, len(pts.xyz))))
    base = InferencePipeline(cfg, seed=0, device="cpu",
                             capacity=pad.GraphCapacity(
                                 (HOST_SMALL_POINTS, 4096, 4096),
                                 (65536, 262144)))
    graph = base.host_graph(small_pts, np.random.default_rng(1))
    base_np = params_to_numpy(base.params)
    options = {}
    reset_counts()
    in_cfg = _normalized_config("IN")
    options["IN"] = _program_card_vs_cpu(
        in_cfg, params_to_numpy(InferencePipeline(
            in_cfg, seed=0, device="cpu").params), graph, device)
    for codec in CODECS:
        options[codec] = _program_card_vs_cpu(
            dict(cfg, box_encoding_method=codec), base_np, graph, device)
    sep = json.loads(json.dumps(cfg))
    sep["model_kwargs"]["layer_configs"][-1]["type"] = (
        "classaware_separated_predictor")
    options["classaware_separated_predictor"] = _program_card_vs_cpu(
        sep, params_to_numpy(InferencePipeline(sep, seed=0,
                                               device="cpu").params),
        graph, device)
    counts = read_counts()
    count(counts)
    check(not any(counts.values()), "the option forwards launched %s"
          % counts)
    out["options_card_vs_cpu"] = dict(points=len(small_pts.xyz),
                                      tol=HOST_TOL, max_abs_err=options)
    for key, errs in options.items():
        print("phase 15: %s forward and decode card vs CPU (%d points, "
              "f32): max abs err %s (tol %g relative) [%s]"
              % (key, len(small_pts.xyz), errs, HOST_TOL, card), flush=True)
    check(not any(launches.values()), "phase 15 launched %s" % launches)
    out["launches"] = launches
    shutil.rmtree(work, ignore_errors=True)
    report["edge_training"] = out
    return out


DP_WORK = os.path.join(HERE, "build", "chip_smoke_dp")
DP_FRAMES = 4  # one step's batch: 2 frames per rank
DP_STEPS = 3  # timed, after one warm-up step
DP_UNION_TOL = 1e-4  # the union step's tolerance (tests/test_torch_dp_*)
DP_STREAM_FRAMES = 8
DP_STREAM_TOL = dict(scores=(1e-4, 1e-5), boxes=(1e-4, 1e-4))
DP_STREAM_SPEC = None  # the serving pipeline's default device spec


def _dp_devices():
    """Two ranks: one per card on two cards (NCCL), else this card
    twice (gloo)."""
    import torch

    return (["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2
            else ["cuda:0", "cuda:0"])


def _update_err(p0, a, b, lr):
    """The largest gap between two parameter updates from ``p0``, per
    leaf in units of (lr + the leaf's largest update in ``b``): the
    gradient gap in units of (1 + max|g|)."""
    from pointgnn_tpu_torch.params import params_from_jax
    from pointgnn_tpu_torch.train import optimizers

    worst = 0.0
    for t0, ta, tb in zip(*(optimizers.param_leaves(params_from_jax(
            p, "cpu")) for p in (p0, a, b))):
        ua, ub = ta - t0, tb - t0
        worst = max(worst, float((ua - ub).abs().max()
                                 / (lr + ub.abs().max())))
    return worst


def _max_param_diff(a, b):
    from pointgnn_tpu_torch.params import params_from_jax
    from pointgnn_tpu_torch.train import optimizers

    return max(float((x - y).abs().max()) for x, y in zip(
        *(optimizers.param_leaves(params_from_jax(p, "cpu"))
          for p in (a, b))))


def _ws1_case(path):
    """Phase 16(b)'s case: car_auto_T3 at full width and depth, two
    synthetic frames at the family's training spec, one sgd step without
    graph randomization."""
    from pointgnn_tpu_torch.data.labels import LABEL_METHODS
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.graph import device_labels as dl
    from pointgnn_tpu_torch.infer import input_feature_dim
    from pointgnn_tpu_torch.infer import select_input_features
    from pointgnn_tpu_torch.model.losses import loss_config
    from pointgnn_tpu_torch.model.pointgnn import PointGNN
    from pointgnn_tpu_torch.params import params_to_numpy
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.train import device_pipeline as dpipe
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    cfg, tc = train_cli_configs("car_auto_T3_train")
    spec = tc.get("device_graph_spec")
    dspec, _ = dpipe.resolve_device_setup(cfg, spec)
    label_map, num_classes = LABEL_METHODS[cfg["label_method"]]
    frames = []
    for seed in (0, 1):
        points, labels = synthetic_lidar_frame(seed=seed)
        packed = db.pack_points(points.xyz, select_input_features(
            points.attr, cfg["input_features"]), dspec.num_points)
        frames.append(dpipe.DeviceFrame(packed, dl.pack_frame_labels(
            labels, label_map, num_classes)))
    batch = dpipe.stack_frames(frames)
    model = dict(num_classes=num_classes, box_encoding_len=7, mode="train",
                 **cfg["model_kwargs"])
    params = PointGNN(**model).init(
        0, input_feature_dim(cfg["input_features"]), "cpu")
    ckpt.save_tree(path, dict(
        model=model, loss=loss_config(cfg), steps=1,
        optimizer=dict(tc, initial_lr=CAR_CLI_LR),
        params=params_to_numpy(params),
        graph_builder=dict(config=cfg, spec=spec, slab="auto"),
        step=dict(frames_per_device=2, with_metrics=True),
        inputs=[(batch.packed_points, tuple(batch.labels))]))


def data_parallel_phase(report, device):
    """Phase 16: data-parallel training and serving.  (a) two ranks
    train car_auto_T3 through ``Trainer`` (gloo on this card twice, NCCL
    over two cards when there are two) at batch 4, 2 frames a rank;
    (b) NCCL at world size 1 against the step without a mesh; (c)
    ``stream`` sharded over this card twice against ``stream``; (d)
    ``dryrun_multichip(2)``."""
    import numpy as np
    import torch

    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.parallel import dryrun, mesh
    from pointgnn_tpu_torch.params import params_to_numpy
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.train.trainer import Trainer
    from pointgnn_tpu_torch.utils import synthetic_kitti
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame

    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    card = card_line()
    work = DP_WORK
    shutil.rmtree(work, ignore_errors=True)
    tree = os.path.join(work, "kitti")
    synthetic_kitti.main(tree, DP_FRAMES, n_ground=TRAIN_CLI_N_GROUND)
    devices = _dp_devices()
    backend = "nccl" if devices[0] != devices[1] else "gloo"

    # (a) no augmentation and no graph randomization: both ranks and the
    # one-process step below see the same four graphs
    cfg, tc = train_cli_configs("car_auto_T3_train")
    tc.update(batch_size=DP_FRAMES, NUM_GPU=2, num_load_dataset_workers=0,
              data_aug_configs=[], device_graph_rnd3d=False,
              initial_lr=CAR_CLI_LR, train_dir=os.path.join(work, "dp"))
    fspec = FetchSpec(DatasetSpec.from_kitti_root(
        tree, os.path.join(tree, "3DOP_splits/train.txt"),
        cfg["num_classes"]), cfg, tc)
    batch = list(range(DP_FRAMES))
    job = dict(config=cfg, train_config=tc, fetch_spec=fspec,
               num_frames=DP_FRAMES, batches=[batch] * (1 + DP_STEPS),
               snapshots=(1,))
    t0 = time.perf_counter()
    ranks = [r[0] for r in mesh.launch(dryrun.train_jobs, 2, [job],
                                       devices=devices, timeout=600,
                                       join_timeout=900)]
    launch_s = time.perf_counter() - t0
    per_step = 4 * DP_FRAMES // 2  # (1 level-0 + 3 level-1) per frame
    for r, res in enumerate(ranks):
        check(all(l == [per_step, per_step] for l in res["launches"]),
              "rank %d launched K1/K2 %s a step, want %d of each"
              % (r, res["launches"], per_step))
        check(all(np.isfinite(res["total_loss"])),
              "rank %d losses %s" % (r, res["total_loss"]))
    rank_diff = _max_param_diff(ranks[0]["params"], ranks[1]["params"])
    check(rank_diff == 0.0, "the ranks' parameters differ by %g" % rank_diff)
    one_tc = dict(tc, NUM_GPU=1, train_dir=os.path.join(work, "one"))
    one = Trainer(cfg, one_tc, fspec._replace(train_config=one_tc),
                  num_frames=DP_FRAMES, device=device)
    try:
        p0 = copy.deepcopy(params_to_numpy(one.state.params))
        aux = one.train_batch(batch)
        p1 = params_to_numpy(one.state.params)
    finally:
        one.close()
    union_err = _update_err(p0, ranks[0]["snapshots"][1], p1, CAR_CLI_LR)
    loss_err = abs(ranks[0]["total_loss"][0] - float(aux["total_loss"])) / \
        abs(float(aux["total_loss"]))
    check(union_err <= DP_UNION_TOL and loss_err <= 1e-5,
          "two ranks vs one process on the union: update gap %.3g (tol "
          "%g), loss rel err %.3g (tol 1e-5)" % (union_err, DP_UNION_TOL,
                                                loss_err))
    peak = [r["peak_bytes"] for r in ranks]
    check(all(peak), "peak device memory per rank %s" % peak)
    step_ms = [statistics.median(r["step_ms"][1:]) for r in ranks]
    timed = [[sum(l[i] for l in r["launches"][1:]) for i in (0, 1)]
             for r in ranks]
    report["data_parallel"] = dict(
        devices=devices, backend=backend, launch_s=launch_s,
        step_ms=[r["step_ms"] for r in ranks], median_step_ms=step_ms,
        launches_per_step=per_step, timed_launches=timed,
        peak_gib=[(p or 0) / 2 ** 30 for p in peak],
        losses=[r["total_loss"] for r in ranks], rank_param_diff=rank_diff,
        union_update_err=union_err, union_loss_rel_err=loss_err)
    print("phase 16: %d ranks (%s on %s) trained car_auto_T3 at batch %d "
          "(%d frames a rank), 1 + %d steps in %.1f s: median ms per step "
          "%s, K1/K2 launches per rank per step %s, peak GiB per rank %s, "
          "losses %s; max |param difference| between ranks %g; vs one "
          "process on the union: update gap %.3g of (lr + max|update|) "
          "(tol %g), loss rel err %.3g [%s]"
          % (len(ranks), backend, ",".join(devices), DP_FRAMES,
             DP_FRAMES // 2, DP_STEPS, launch_s,
             [round(v, 2) for v in step_ms],
             [r["launches"][-1] for r in ranks],
             [round(v, 2) for v in report["data_parallel"]["peak_gib"]],
             [[round(v, 5) for v in r["total_loss"]] for r in ranks],
             rank_diff, union_err, DP_UNION_TOL, loss_err, card),
          flush=True)

    # (b) NCCL at world size 1, against the step without a mesh
    path = os.path.join(work, "ws1.npz")
    _ws1_case(path)
    # one card: NCCL
    ws1 = mesh.launch(dryrun.run_cases, 1, [path], devices=devices[:1],
                      timeout=600, join_timeout=600)[0][0]
    plain = [dryrun.run_cases(None, [path], device=device)[0]
             for _ in range(2)]
    repeat_diff = _max_param_diff(plain[0]["params"], plain[1]["params"])
    ws1_diff = _max_param_diff(ws1["params"], plain[0]["params"])
    loss_same = (ws1["aux"][0]["total_loss"].tobytes()
                 == plain[0]["aux"][0]["total_loss"].tobytes())
    report["data_parallel"]["nccl_ws1"] = dict(
        param_diff=ws1_diff, repeat_param_diff=repeat_diff,
        loss_bitwise=loss_same)
    print("phase 16: NCCL world size 1 vs no mesh (car_auto_T3, 2 frames): "
          "max |param difference| %g, total loss bitwise %s; two runs "
          "without a mesh differ by %g" % (ws1_diff, loss_same, repeat_diff),
          flush=True)
    check(ws1_diff == 0.0 and loss_same,
          "NCCL at world size 1 differs from the step without a mesh by %g"
          % ws1_diff)

    # (c) stream sharded over the card twice
    frames = [synthetic_lidar_frame(seed=s)[0]
              for s in range(DP_STREAM_FRAMES)]
    pipe = InferencePipeline(cfg, on_device_graph=True, device=device,
                             device_spec=DP_STREAM_SPEC, seed=0)
    t0 = time.perf_counter()
    want = list(pipe.stream(iter(frames), batch=4))
    plain_ms = 1e3 * (time.perf_counter() - t0) / len(frames)
    shard = InferencePipeline(cfg, on_device_graph=True, device=device,
                              device_spec=DP_STREAM_SPEC, seed=0)
    reset_counts()
    t0 = time.perf_counter()
    got = list(shard.stream(iter(frames), batch=4, mesh=devices))
    mesh_ms = 1e3 * (time.perf_counter() - t0) / len(frames)
    stream_counts = read_counts()
    stream_k1 = stream_counts["slab_edge_max"]
    check(stream_k1 == 4 * len(frames),
          "sharded stream launched K1 %d times, want %d"
          % (stream_k1, 4 * len(frames)))
    check(len(got) == len(want) == len(frames), "stream lengths differ")
    worst = {"scores": 0.0, "boxes": 0.0}
    for (c1, b1, s1, _), (c2, b2, s2, _) in zip(want, got):
        check(np.array_equal(c1, c2), "sharded stream classes differ")
        for key, x, y in (("scores", s2, s1), ("boxes", b2, b1)):
            rtol, atol = DP_STREAM_TOL[key]
            if x.size:
                worst[key] = max(worst[key], float(
                    (np.abs(x - y) / (atol + rtol * np.abs(y))).max()))
    check(max(worst.values()) <= 1.0, "sharded stream vs stream: %s of "
          "the tolerance" % worst)
    report["data_parallel"]["stream"] = dict(
        frames=len(frames), ms_per_frame=mesh_ms, plain_ms_per_frame=plain_ms,
        k1_launches=stream_k1, worst_share_of_tol=worst,
        detections=int(sum(len(g[0]) for g in got)))
    print("phase 16: stream over %s, %d frames in batches of 4: %.1f ms a "
          "frame (unsharded %.1f), K1 launches %d, %d detections, worst "
          "gap %s of the tolerance %s" % (
              ",".join(devices), len(frames), mesh_ms, plain_ms, stream_k1,
              report["data_parallel"]["stream"]["detections"], worst,
              DP_STREAM_TOL), flush=True)

    # (d) the dry run, each rank on its own frame
    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(2, devices=devices)
    report["data_parallel"]["dryrun"] = dict(dry, seconds=time.perf_counter()
                                             - t0)
    # the timed steps' launches on both ranks, and the sharded stream's
    return {"training": {"slab_edge_max": sum(t[0] for t in timed),
                         "slab_edge_max_backward": sum(t[1] for t in timed)},
            "stream": stream_counts}


VIS_FRAMES = 2  # run_torch.py --fast -l 2; the host run serves 1
PROFILE_REPS = 16  # profile_inference, as the tool's default
TRAIN_PROFILE_REPS = 4
TUNE_FRAMES = 4
TUNE_VARIANTS = "16,64"


def _vis_cli(ck_dir, tree, out_dir, *flags):
    """``run_torch.py`` in a subprocess; returns its launch counts."""
    cmd = [sys.executable, os.path.join(HERE, "run_torch.py"), ck_dir,
           "--dataset_root_dir", tree, "--output_dir", out_dir] + list(flags)
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, "run_torch.py %s exited %d:\n%s\n%s" % (
        " ".join(flags), res.returncode, res.stdout[-4000:],
        res.stderr[-4000:]))
    return json.loads(res.stdout.strip().splitlines()[-1])["launches"]


def _label_texts(out_dir):
    data = os.path.join(out_dir, "data")
    return {n: open(os.path.join(data, n), "rb").read()
            for n in sorted(os.listdir(data))}


def tools_phase(report, device):
    """Phase 17: the rest of the serving surface and the tools.  (a)
    ``run_torch.py --fast -l 2`` over 2 frames of a synthetic tree and
    ``run_torch.py -l 1`` (host graphs) over 1 frame: every vis PNG
    decodes at its shape, the detection image differs from the camera
    image, the KITTI text equals a run without visualization byte for
    byte, 4 K1 launches a frame on the fast run and none on the host
    run; (b) ``tools_torch/profile_inference.py``'s ``profile`` on
    car_auto_T3 at 24576 / 12288 points; (c)
    ``tools_torch/profile_train_step.py``'s ``profile`` on car_auto_T3
    at full width and depth (sgd, lr 0.125, as the JAX tool), its finite
    loss steps; (d) ``tools_torch/tune_slab_kernels.py``'s ``sweep`` over
    the default and two ``block_centers`` variants on 4 frames, outputs
    bitwise equal.  Launches are counted from 0 around each path."""
    import numpy as np

    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.data import png
    from pointgnn_tpu_torch.data.kitti import KittiDataset
    from pointgnn_tpu_torch.graph import device_builder as db
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.utils import synthetic_kitti
    from pointgnn_tpu_torch.utils.synthetic import synthetic_lidar_frame
    from pointgnn_tpu_torch.utils.vis import BEV_SIZE
    from tools_torch import profile_inference, profile_train_step
    from tools_torch import tune_slab_kernels

    t_phase = time.perf_counter()
    zero = {name: 0 for name in kernel_wrappers()}
    launches = {}
    out = {}

    # (a) visualization from the command line
    work = os.path.join(HERE, "build", "chip_smoke_vis")
    shutil.rmtree(work, ignore_errors=True)
    tree, ck_dir = os.path.join(work, "kitti"), os.path.join(work, "ckpt")
    names = synthetic_kitti.main(tree, VIS_FRAMES, n_ground=12000)
    cfg = configs.get_config("car_auto_T3_train")
    params = InferencePipeline(cfg, seed=0, device="cpu").params
    ckpt.save_checkpoint(ck_dir, 0, {"params": params}, config=cfg)
    ds = KittiDataset(
        os.path.join(tree, "image/training/image_2"),
        os.path.join(tree, "velodyne/training/velodyne/"),
        os.path.join(tree, "calib/training/calib/"),
        os.path.join(tree, "labels/training/label_2"),
        os.path.join(tree, "3DOP_splits/val.txt"), num_classes=4)
    vis_runs = {}
    for key, level, frames, fast in (("fast", 2, VIS_FRAMES, True),
                                     ("host", 1, 1, False)):
        out_dir = os.path.join(work, key)
        t0 = time.perf_counter()
        counts = _vis_cli(ck_dir, tree, out_dir, "-l", str(level),
                             "--num_frames", str(frames),
                             *(("--fast",) if fast else ()))
        cli_s = time.perf_counter() - t0
        want_k1 = 4 * frames if fast else 0
        check(counts == dict(zero, slab_edge_max=want_k1),
              "run_torch.py -l %d (%s) launches %s, want %d slab_edge_max"
              % (level, key, counts, want_k1))
        launches["vis_cli_" + key] = counts
        # the same run without visualization, in this process
        pipe = InferencePipeline(cfg, checkpoint_dir=ck_dir, device=device,
                                 on_device_graph=fast)
        plain_dir = os.path.join(work, key + "_plain")
        pipe.run_dataset(ds, plain_dir, num_frames=frames, verbose=False)
        texts = _label_texts(out_dir)
        check(texts == _label_texts(plain_dir),
              "run_torch.py -l %d (%s): KITTI text differs from the run "
              "without visualization" % (level, key))
        check(sorted(texts) == [n + ".txt" for n in names[:frames]],
              "label files %s" % sorted(texts))
        suffixes = ("", "_bev") + (("_3d",) if level >= 2 else ())
        vis_dir = os.path.join(out_dir, "vis")
        files = sorted(os.listdir(vis_dir))
        check(files == sorted(n + s + ".png" for n in names[:frames]
                              for s in suffixes), "vis files %s" % files)
        changed = []
        for i, name in enumerate(names[:frames]):
            image = ds.get_image(i)
            det = png.read_png(os.path.join(vis_dir, name + ".png"))
            check(det.shape == image.shape, "%s.png shape %s" % (
                name, det.shape))
            changed.append(int((det != image).any(axis=2).sum()))
            check(changed[-1] > 0, "%s.png equals the camera image" % name)
            for suffix in suffixes[1:]:
                bev = png.read_png(os.path.join(vis_dir, name + suffix
                                                + ".png"))
                check(bev.shape == (BEV_SIZE, BEV_SIZE, 3),
                      "%s%s.png shape %s" % (name, suffix, bev.shape))
        vis_runs[key] = dict(level=level, frames=frames, cli_seconds=cli_s,
                             launches=counts, vis_files=len(files),
                             changed_pixels=changed,
                             detections=[len(t.splitlines()) - 1
                                         for t in texts.values()])
    shutil.rmtree(work, ignore_errors=True)
    out["vis_cli"] = vis_runs

    # (b) profile_inference at the tool's defaults (car T=3)
    car = configs.model_config("Car", T=3)
    spec = db.spec_from_config(car, num_points=24576, num_keypoints=12288,
                               per_center_caps=(32, 192))
    reset_counts()
    prof = profile_inference.profile(car, spec, reps=PROFILE_REPS,
                                     probe=True, device=device)
    launches["profile_inference"] = read_counts()
    # device_fn and model.apply, each a warm-up and the timed calls
    want_k1 = 2 * 4 * (PROFILE_REPS + 1)
    check(launches["profile_inference"] == dict(zero, slab_edge_max=want_k1),
          "profile_inference launches %s, want %d slab_edge_max"
          % (launches["profile_inference"], want_k1))
    check(all(np.isfinite(v) and v > 0 for k, v in prof.items()
              if k != "tail_ms"), "profile_inference %s" % prof)
    out["profile_inference"] = prof

    # (c) profile_train_step at the JAX tool's settings
    reset_counts()
    train = profile_train_step.profile(car, reps=TRAIN_PROFILE_REPS,
                                       probe=False, device=device)
    launches["profile_train_step"] = read_counts()
    # forward, loss, grad and step each run K1 4 times a call; grad and
    # step run K2 4 times a call
    calls = TRAIN_PROFILE_REPS + 1
    want = dict(zero, slab_edge_max=16 * calls,
                slab_edge_max_backward=8 * calls)
    check(launches["profile_train_step"] == want,
          "profile_train_step launches %s, want %s"
          % (launches["profile_train_step"], want))
    check(np.isfinite(train["first_loss"]) and train["grad_ms"] > 0,
          "profile_train_step %s" % train)
    out["profile_train_step"] = train

    # (d) tune_slab_kernels over the default and two variants
    frames = [synthetic_lidar_frame(seed=i, points_per_beam=380)[0]
              for i in range(TUNE_FRAMES)]
    variants = tune_slab_kernels.parse_variants(TUNE_VARIANTS)
    reset_counts()
    rows = tune_slab_kernels.sweep(car, spec, variants, frames, TUNE_FRAMES,
                                   device=device)
    launches["tune_slab_kernels"] = read_counts()
    # default, 2 variants and the recheck, each a 4-frame warm-up and the
    # timed frames, 4 K1 launches a frame
    want_k1 = 4 * (2 + len(variants)) * (4 + TUNE_FRAMES)
    check(launches["tune_slab_kernels"] == dict(zero, slab_edge_max=want_k1),
          "tune_slab_kernels launches %s, want %d slab_edge_max"
          % (launches["tune_slab_kernels"], want_k1))
    out["tune_slab_kernels"] = {
        "variants": [tune_slab_kernels.name_of(t) for t, _ in rows],
        "ms_per_frame": [ms for _, ms in rows],
        "suggested": tune_slab_kernels.suggestion(rows),
        "outputs_bitwise_equal": True}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    report["tools"] = out

    for key, row in vis_runs.items():
        print("phase 17: run_torch.py%s -l %d served %d frame(s) in %.1f s: "
              "launches %s, detections %s, %d vis files, detection image "
              "pixels changed %s; KITTI text equals the run without -l"
              % (" --fast" if key == "fast" else "", row["level"],
                 row["frames"], row["cli_seconds"], row["launches"],
                 row["detections"], row["vis_files"],
                 row["changed_pixels"]), flush=True)
    print("phase 17: profile_inference (car T=3, 24576 / 12288, %d reps): "
          "%s; K1 launches %d" % (PROFILE_REPS, json.dumps(prof),
                                  launches["profile_inference"][
                                      "slab_edge_max"]), flush=True)
    print("phase 17: profile_train_step (car T=3, sgd lr 0.125, %d reps): "
          "%s; K1 %d, K2 %d launches" % (
              TRAIN_PROFILE_REPS, json.dumps(train),
              launches["profile_train_step"]["slab_edge_max"],
              launches["profile_train_step"]["slab_edge_max_backward"]),
          flush=True)
    tune = out["tune_slab_kernels"]
    print("phase 17: tune_slab_kernels (%d frames): %s ms per frame; "
          "outputs bitwise equal to the default's; suggested %s; K1 "
          "launches %d" % (TUNE_FRAMES, dict(zip(tune["variants"],
                                                 tune["ms_per_frame"])),
                           tune["suggested"],
                           launches["tune_slab_kernels"]["slab_edge_max"]),
          flush=True)
    print("phase 17: %.1f s" % out["seconds"], flush=True)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from pointgnn_tpu_torch.nn import cuda_build
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

    from pointgnn_tpu_torch.postprocess import kitti_eval, native

    t0 = time.perf_counter()
    host_lib = native.build_library()
    print("phase 1: host library (NMS, PNG) %s in %.1f s"
          % (os.path.basename(host_lib), time.perf_counter() - t0))
    t0 = time.perf_counter()
    ap_eval = kitti_eval.binary_path()
    report["ap_evaluator_build_s"] = time.perf_counter() - t0
    print("phase 1: KITTI AP evaluator %s in %.1f s"
          % (os.path.basename(ap_eval), report["ap_evaluator_build_s"]))
    built = cuda_build.build_kernels()
    report["build"] = {}
    for name, (path, build_s, log) in built.items():
        ptxas = ptxas_kernels(log)
        report["build"][name] = dict(seconds=build_s, ptxas=ptxas,
                                     cached=not log)
        print("phase 1: %s %s in %.1f s" % (
            "found cached" if not log else "built", os.path.basename(path),
            build_s))
        for kernel, line in ptxas.items():
            print("  %s: %s" % (kernel, line))

    kernel_phase(report, device)
    serving_launches = serving_phase(report, device)
    cpu_parity_phase(report, device)
    backward_kernel_phase(report, device)
    train_k1, train_k2 = train_phase(report, device)
    grad_parity_phase(report, device)
    edge_pipe = edge_kernel_phase(report, device)
    edge = edge_serving_phase(report, device, edge_pipe)
    edge_cpu_parity_phase(report, device)
    kitti, kitti_k1 = kitti_cli_phase(report, device)
    cli_k1, cli_k2, ped_rows = train_cli_phase(report, device)
    eval_k1, smoke_k1, smoke_k2, eval_rows = eval_phase(report, device)
    host = host_graph_phase(report, device)
    # every launch of phase 14's host-graph runs, by kernel (all 0); its
    # smoke's fast pass (device graphs) is counted apart
    sl = host["smoke"]["launches"]
    host_runs = [host["cli"]["launches"], host["train_cli"]["launches"],
                 host["eval_cli"]["launches"], sl["train"], sl["eval"],
                 sl["serve_host"]]
    host_k = {name: sum(r.get(name, 0) for r in host_runs)
              for name in kernel_wrappers()}
    # every launch of phase 15's runs (all 0: no kernel on these paths)
    edge_k = edge_training_phase(report, device)["launches"]
    # phase 16's data-parallel steps (both ranks) and sharded stream
    dp_k = data_parallel_phase(report, device)
    # phase 17's runs, each counted from 0: run_torch.py -l, the profilers
    # and the tuner
    tools_k = tools_phase(report, device)

    n_l1 = 3  # car_auto_T3: one level-0 and three level-1 launches

    def per_frame(lv, key):
        return lv["L0"][key] + n_l1 * lv["L1"][key]

    def bound_by(lv):
        # a frame's bound is the sum of its launches' bounds; name the
        # limit of the level that contributes most of it
        share = {"L0": lv["L0"]["bound_ms"],
                 "L1": n_l1 * lv["L1"]["bound_ms"]}
        return lv[max(share, key=share.get)]["bound_by"]

    keys = ("inradius_pairs", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")
    lv, tl = report["levels"], report["train_levels"]
    lv_ped = report["train_cli"]["ped_cyl_levels"]
    kernels = [{
        "name": "slab_edge_max",
        "route": "cuda",
        "source": "pointgnn_tpu_torch/csrc/slab_edge_max.cu",
        "replaces": "pointgnn_tpu/nn/pallas_kernels.py:573",
        # slab serving (8 frames), training (3 steps), "l1" serving
        # (2 frames), run_torch.py (8 KITTI frames), train_torch.py
        # (4 + 2 car steps, 2 ped_cyl steps), eval_torch.py (3
        # checkpoints x 8 frames) and smoke_train_eval_torch.py
        # (training, evaluation, serving), each counted from 0
        "launches": (serving_launches + train_k1
                     + edge["l1"]["launches"]["slab_edge_max"]
                     + kitti["slab_edge_max"] + cli_k1 + eval_k1
                     + smoke_k1 + host_k["slab_edge_max"]
                     + sl["serve_fast"]["slab_edge_max"]
                     + edge_k["slab_edge_max"]
                     + dp_k["training"]["slab_edge_max"]
                     + dp_k["stream"]["slab_edge_max"]
                     + sum(r["slab_edge_max"] for r in tools_k.values())),
        "launches_by_path": {
            "serving": serving_launches, "training": train_k1,
            "l1_serving": edge["l1"]["launches"]["slab_edge_max"],
            "kitti_cli": kitti["slab_edge_max"], "train_cli": cli_k1,
            "eval_cli": eval_k1, "smoke_train_eval": smoke_k1,
            "host_graph": host_k["slab_edge_max"],
            "host_smoke_fast_pass": sl["serve_fast"]["slab_edge_max"],
            "edge_list_training_and_options": edge_k["slab_edge_max"],
            "data_parallel_training": dp_k["training"]["slab_edge_max"],
            "data_parallel_stream": dp_k["stream"]["slab_edge_max"],
            **{path: r["slab_edge_max"] for path, r in tools_k.items()}},
        # phase 2 (car_T3 serving shapes), phase 11 (the CLI's spec) and
        # phase 13 (an eval step, f32, bitwise)
        "max_abs_err": max([lv["L0"]["max_abs_err"], lv["L1"]["max_abs_err"]]
                           + [row["max_abs_err"] for row in kitti_k1]
                           + [row["max_abs_err"] for row in eval_rows]),
        # per serving frame (bf16): 1 level-0 + 3 level-1 launches
        "ms": per_frame(lv, "ms"),
        "plain_ms": per_frame(lv, "plain_ms"),
        "bound_ms": per_frame(lv, "bound_ms"),
        "bound_by": bound_by(lv),
        "library_ms": None,
        "per_launch": {key: {k: lv[key][k] for k in keys}
                       for key in ("L0", "L1")},
        "per_launch_train_f32": {
            key: dict(tl[key]["fwd_f32"], inradius_pairs=tl[key][
                "inradius_pairs"]) for key in ("L0", "L1")},
        # phase 12: one ped_cyl train step's inputs (f32, bitwise)
        "per_launch_train_ped_cyl_f32": {
            key: dict(lv_ped[key]["K1"], inradius_pairs=lv_ped[key][
                "inradius_pairs"]) for key in lv_ped},
        # phase 13: one eval step on a tree frame at the training spec
        "per_launch_eval_f32": report["eval"]["k1_levels"],
    }, {
        "name": "slab_edge_max_backward",
        "route": "cuda",
        "source": "pointgnn_tpu_torch/csrc/slab_edge_max_bwd.cu",
        "replaces": "pointgnn_tpu/nn/pallas_kernels.py:1230",
        # training (3 steps), train_torch.py and the smoke's training,
        # each counted from 0; eval_torch.py launches none
        "launches": (train_k2 + cli_k2 + smoke_k2
                     + host_k["slab_edge_max_backward"]
                     + edge_k["slab_edge_max_backward"]
                     + dp_k["training"]["slab_edge_max_backward"]
                     + sum(r["slab_edge_max_backward"]
                           for r in tools_k.values())),
        "launches_by_path": {"training": train_k2, "train_cli": cli_k2,
                             "eval_cli": report["eval"]["launches"][
                                 "eval_cli_K2"],
                             "smoke_train_eval": smoke_k2,
                             "host_graph": host_k["slab_edge_max_backward"],
                             "edge_list_training_and_options": edge_k[
                                 "slab_edge_max_backward"],
                             "data_parallel_training": dp_k["training"][
                                 "slab_edge_max_backward"],
                             **{path: r["slab_edge_max_backward"]
                                for path, r in tools_k.items()}},
        # phase 5 (car_T3 training shapes) and phase 12 (ped_cyl's step)
        "max_abs_err": max([tl["L0"]["max_abs_err"], tl["L1"]["max_abs_err"]]
                           + [r["k2_max_abs_err"] for r in ped_rows]),
        # per training frame (f32): 1 level-0 + 3 level-1 launches
        "ms": per_frame(tl, "ms"),
        "plain_ms": per_frame(tl, "plain_ms"),
        "bound_ms": per_frame(tl, "bound_ms"),
        "bound_by": bound_by(tl),
        "library_ms": None,
        "per_launch": {key: {k: tl[key][k] for k in keys}
                       for key in ("L0", "L1")},
        "per_launch_ped_cyl": {
            key: dict(lv_ped[key]["K2"], inradius_pairs=lv_ped[key][
                "inradius_pairs"], winner_entries=lv_ped[key][
                "winner_entries"]) for key in lv_ped},
    }]
    el = report["edge_levels"]
    tail_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    # the layers call K4: no serving path reaches K3 (0 launches), which
    # phase 8 holds against K4 and its plain version
    for name, source, replaces in (
        ("edge_tail_max", "edge_tail_max.cu", ":220"),
        ("fused_edge_max", "fused_edge_max.cu", ":103"),
    ):
        launches = {"edge_serving": edge["edges"]["launches"][name],
                    "l1_serving": edge["l1"]["launches"][name],
                    "kitti_cli": kitti.get(name, 0),
                    "host_graph": host_k[name],
                    "data_parallel_stream": dp_k["stream"][name],
                    "edge_list_training_and_options": edge_k[name],
                    **{path: r[name] for path, r in tools_k.items()}}
        key = "K3" if name == "edge_tail_max" else "K4"
        lv_k = {lvl: dict(el[lvl][key], valid_slots=el[lvl]["valid_slots"])
                for lvl in ("L0", "L1")}
        share = {"L0": lv_k["L0"]["bound_ms"],
                 "L1": n_l1 * lv_k["L1"]["bound_ms"]}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pointgnn_tpu_torch/csrc/" + source,
            "replaces": "pointgnn_tpu/nn/pallas_kernels.py" + replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(lv_k["L0"]["max_abs_err"],
                               lv_k["L1"]["max_abs_err"]),
            # per edge-list serving frame (bf16): 1 level-0 + 3 level-1
            "ms": per_frame(lv_k, "ms"),
            "plain_ms": per_frame(lv_k, "plain_ms"),
            "bound_ms": per_frame(lv_k, "bound_ms"),
            "bound_by": lv_k[max(share, key=share.get)]["bound_by"],
            "library_ms": None,
            "per_launch": {lvl: {k: lv_k[lvl][k] for k in tail_keys + (
                "valid_slots",)} for lvl in ("L0", "L1")},
        })
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
