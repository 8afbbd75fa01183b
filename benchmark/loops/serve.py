"""Serving loop: LiDAR frames through ``InferencePipeline`` on
device-built slab graphs, in one of two closed loops (the mix's
``loop``):

- ``stream``: one ``stream(frames, depth)`` over the pool, cycled, as
  ``run_dataset`` streams a KITTI split; the window counts the frames
  that ``stream`` yields (``serve_fps``).
- ``frame``: ``run_frame`` on one frame after another, one caller; the
  window times each call (``frame_ms_p50``, ``frame_ms_p95``).

Set-up makes the pool and the weights from the seed, builds the
pipeline and serves ``warmup_frames`` frames through the loop itself
(every kernel is built and every shape seen).  The set-up clock leaves
out the reference's forward that calibrates the weights.  The frames to
judge are drawn from the seed before the window: ``sample_frames`` pool
frames and the one of the most points.  A tap on ``device_fn`` keeps
the device program's outputs of the latest calls of each, and the loop
keeps their served detections; after the window the last time each was
served in the window (or, where none was, the window's last frame) is
judged against the reference (``core/judge.py``).
"""

import gc
import itertools
import time

import numpy as np
import torch

from benchmark.core import adapter, judge, lidar
from benchmark.reference import pointgnn as ref
from benchmark.reference.weights import (BASE_SEED, BIAS_LIMIT, FG_LOGIT_BIAS,
                                         JITTER, calibrate_classes,
                                         make_weights)

WINDOW_SPAN = "benchmark.window"


class _Tap:
    """Keeps ``device_fn``'s outputs, keyed by call, of the two latest
    calls from ``start`` on, and of the two latest of each pool frame in
    ``picks`` (call ``c`` serves pool frame ``c % pool``): the latest call
    may be one that ``stream`` runs ahead of the window's end, the one
    before it was served in the window."""

    def __init__(self, pipe, start, pool, picks):
        self.calls = 0
        self.kept = {}
        recent = []
        latest = {p: [] for p in picks}
        inner = pipe.device_fn

        def device_fn(params, packed):
            outs = inner(params, packed)
            c = self.calls
            if c >= start:
                self.kept[c] = outs
                for calls in (recent, latest.get(c % pool)):
                    if calls is not None:
                        calls.append(c)
                        del calls[:-2]
                live = set(recent).union(*latest.values())
                for old in [k for k in self.kept if k not in live]:
                    del self.kept[old]
            self.calls += 1
            return outs

        pipe.device_fn = device_fn


def judge_picks(mix, seed, pool_np):
    """The pool frames to judge, drawn from the seed, with the one of the
    most points."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64),
                                                        11]))
    n = len(pool_np)
    picks = set(rng.choice(n, size=min(int(mix["sample_frames"]), n),
                           replace=False).tolist())
    picks.add(int(np.argmax([len(xyz) for xyz, _ in pool_np])))
    return sorted(picks)


def run_weights(cfg, seed, device, pool_np):
    """``(weights, seconds)``: the run's weights (``reference/weights.py``'s
    recipe, jittered from a seed derived from the run's) with the class
    head calibrated on the pool's first frame by the reference, and the
    seconds that calibration took."""
    wseed = int(np.random.SeedSequence([int(seed) % (1 << 64), 7])
                .generate_state(1, np.uint64)[0] % (1 << 63))
    config = cfg["config"]
    weights = make_weights(config, 1, BASE_SEED, wseed, device, BIAS_LIMIT,
                           JITTER)
    t0 = time.perf_counter()
    xyz, attr = pool_np[0]
    graph = ref.FrameGraph(xyz, config, device)
    probs, _ = ref.forward(graph, attr[:, 0], weights, config)
    calibrate_classes(weights, config, torch.log(probs).mean(dim=0).cpu(),
                      FG_LOGIT_BIAS)
    return weights, time.perf_counter() - t0


def run(ctx):
    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    pool_np = lidar.make_pool(mix, seed)
    pool = [adapter.points(x, a) for x, a in pool_np]
    weights, ref_s = run_weights(cfg, seed, device, pool_np)
    if device.type == "cuda":
        # the calibration's reference forward is the benchmark's, not
        # the program's: the peak is read from here on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    pipe = adapter.serving_pipeline(cfg, adapter.program_params(weights),
                                    device)
    loop = mix["loop"]
    warm = int(mix["warmup_frames"])
    picks = judge_picks(mix, seed, pool_np)
    tap = _Tap(pipe, warm, len(pool), picks)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    dets = {}            # call index -> detections, of the kept calls

    def keep(i, out):
        if i in tap.kept:
            dets[i] = out[:3]
            for c in [c for c in dets if c not in tap.kept]:
                del dets[c]

    lat = []             # frame seconds (frame loop)
    if loop == "stream":
        stream = pipe.stream((pool[i % len(pool)] for i in itertools.count()),
                             depth=int(mix["depth"]))
        for _ in range(warm):
            next(stream)
    elif loop == "frame":
        for i in range(warm):
            pipe.run_frame(pool[i % len(pool)])
    else:
        raise ValueError("unknown loop %r" % loop)
    sync()
    ctx.mark_setup_done(excluded_s=ref_s)

    nms0 = pipe.time_dict.get("nms", 0.0)
    calls0 = tap.calls
    prof = ctx.start_profiler()
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    i = warm
    with ctx.span(WINDOW_SPAN):
        if loop == "stream":
            while True:
                out = next(stream)
                if time.perf_counter() > t_end:
                    break
                keep(i, out)
                i += 1
        else:
            while time.perf_counter() < t_end:
                s = time.perf_counter()
                out = pipe.run_frame(pool[i % len(pool)])
                e = time.perf_counter()
                if e > t_end:
                    break
                lat.append(e - s)
                keep(i, out)
                i += 1
        sync()
    window_s = ctx.seconds
    calls_in_window = (calls0, tap.calls)
    trace = ctx.stop_profiler(prof, WINDOW_SPAN)
    nms_s = pipe.time_dict.get("nms", 0.0) - nms0
    if loop == "stream":
        stream.close()
    sync()
    memory_peak = ctx.memory_peak()

    metrics = {}
    n = i - warm
    if loop == "stream":
        metrics["serve_fps"] = n / window_s
    elif lat:
        ms = 1e3 * np.asarray(lat)
        metrics["frame_ms_p50"] = float(np.percentile(ms, 50))
        metrics["frame_ms_p95"] = float(np.percentile(ms, 95))

    served = sorted(c for c in dets if c in tap.kept)
    last = {c % len(pool): c for c in served if c % len(pool) in picks}
    if served and not last:
        last = {served[-1] % len(pool): served[-1]}
    judged = [(p, tuple(t.detach().cpu().numpy() for t in tap.kept[c]),
               dets[c]) for p, c in sorted(last.items())]

    frames_in_window = [c % len(pool) for c in range(warm, warm + n)]
    k1_frames = [c % len(pool) for c in range(*calls_in_window)]
    del dets, tap, pipe
    if loop == "stream":
        del stream
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    per_layer_ctx = None
    if trace is not None:
        per_layer_ctx = dict(
            trace=trace, window_s=trace.window_s, cfg=cfg, loop=loop,
            frames=frames_in_window, k1_frames=k1_frames,
            pool_counts=ctx.pool_counts(pool_np, cfg, set(frames_in_window)
                                        | set(k1_frames)),
            nms_s=nms_s)

    numbers, detail = check_frames(judged, pool_np, cfg, weights, device)
    return dict(attempted=n, failed=0, e2e=metrics, per_layer=per_layer_ctx,
                memory_peak=memory_peak, numbers=numbers, detail=detail,
                judge="serve", span=WINDOW_SPAN)


def reference_outputs(graph, intensity, weights, config):
    """``{reference: (probs, enc)}`` of one frame, each reference of
    ``judge.REFERENCES``."""
    return {name: ref.forward(graph, intensity, weights, config,
                              precision=name)
            for name in judge.REFERENCES}


def check_frames(judged, pool_np, cfg, weights, device):
    """``(numbers, detail)`` of the judge over ``judged = [(pool index,
    hyps, dets)]``, the references run once per pool frame; each number
    ``judge.NOTHING_JUDGED`` where nothing was judged."""
    if not judged:
        return {name: judge.NOTHING_JUDGED for name in judge.NUMBERS}, {}
    config = cfg["config"]
    frames, cache = [], {}
    for pidx, hyps, dets in judged:
        if pidx not in cache:
            xyz, attr = pool_np[pidx]
            graph = ref.FrameGraph(xyz, config, device)
            cache = {pidx: (graph, reference_outputs(graph, attr[:, 0],
                                                     weights, config))}
        graph, outs = cache[pidx]
        frames.append((hyps, dets, graph, outs))
    return judge.judge_frames(frames, config,
                              cfg["serving"]["max_hypotheses"])


def control_frames(pool_np, cfg, seed, device, frames, precision="fp8",
                   nms_dtype=None):
    """The control: the reference in the program's place, its network at
    ``precision`` (``reference/pointgnn.py``'s ``PRECISIONS``) and its
    merge-NMS in ``nms_dtype``, on pool frames ``frames``; judged like
    the program.  ``nms_dtype`` None leaves the NMS out: it would be the
    judge's own float64 NMS, which cannot differ from itself.  Returns
    ``(numbers, detail)``."""
    config = cfg["config"]
    weights, _ = run_weights(cfg, seed, device, pool_np)
    max_h = cfg["serving"]["max_hypotheses"]
    judged = []
    for pidx in frames:
        xyz, attr = pool_np[pidx]
        graph = ref.FrameGraph(xyz, config, device)
        c_probs, c_enc = ref.forward(graph, attr[:, 0], weights, config,
                                     precision=precision)
        s, c, b, x = ref.hypotheses(graph, c_probs, c_enc, config, max_h)
        hyps = (s, c, b, x.astype(np.float32))
        dets = None if nms_dtype is None else judge.reference_nms(
            s, c, b, config, dtype=nms_dtype)
        judged.append((hyps, dets, graph,
                       reference_outputs(graph, attr[:, 0], weights,
                                         config)))
    return judge.judge_frames(judged, config, max_h)
