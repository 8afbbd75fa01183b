#!/usr/bin/env python3
"""End-to-end acceptance smoke of the PyTorch/CUDA port: train ->
evaluate -> detect -> official KITTI AP.

The counterpart of ``tools/smoke_train_eval.py --device_graph``, with
its recipe: a synthetic KITTI tree (``utils/synthetic_kitti.py``), a
Point-GNN (Car, T=1 by default) overfit on its frames through
``Trainer`` on device-built slab graphs (focal loss, adam at lr 1e-3,
batch 1, no augmentation, frames refetched every 4 servings), the last
checkpoint evaluated by ``Evaluator``, the tree served by
``InferencePipeline.run_dataset`` from that checkpoint, and the
detections scored by the port's KITTI AP evaluator.  Exits non-zero when
the minimum over classes of the BEV moderate AP is below
``--min_bev_ap`` (or the mean 3D moderate AP below ``--min_ap``).

    python3 smoke_train_eval_torch.py [workdir] [--steps N] [--T 1] \
        [--frames F] [--label_method Car] [--min_bev_ap 85] [--device cpu]

Not run: the JAX tool's host-graph pass (the host-built graph is not
ported) and its ``--oracle`` (it needs TensorFlow and the reference's
checkpoints); the script says so, and takes neither ``--oracle`` nor
``--device_graph`` (it always trains on device graphs).  The last line of the output is JSON:
the AP table, the gated values, the wall time of each stage, the
training steps per second, ``run_dataset``'s buckets per frame, the
KITTI conversion per frame and each stage's kernel launches.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

SKIPPED = {
    "host": "the host-built graph (the JAX tool's fast=False pass) is not "
            "ported (ROADMAP.md Queue 1 item 6)",
    "oracle": "the real-weight parity oracle needs TensorFlow and the "
              "reference's trained checkpoints, which the repository does "
              "not hold",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", nargs="?", default="")
    parser.add_argument("--steps", type=int, default=None,
                        help="default 1200 sample-equivalent steps of the "
                             "JAX tool, scaled by frames / 14 and by 2 / "
                             "batch (2400 for Car at batch 1)")
    parser.add_argument("--T", type=int, default=1)
    parser.add_argument("--frames", type=int, default=None,
                        help="default 14 per class of the family: the "
                             "11-point protocol needs >= 41 ground truths "
                             "per class to be able to score 100")
    parser.add_argument("--label_method", default="Car",
                        choices=["Car", "Pedestrian_and_Cyclist"])
    parser.add_argument("--min_ap", type=float, default=-1.0,
                        help="exit non-zero if the classes' mean 3D "
                             "moderate AP is below (report-only by "
                             "default: 3D moderate sits on an IoU knife "
                             "edge)")
    parser.add_argument("--min_bev_ap", type=float, default=85.0,
                        help="exit non-zero if any class's BEV moderate AP "
                             "is below (the min over classes is gated); "
                             "negative disables")
    parser.add_argument("--device", default="cuda",
                        help="Torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    return parser.parse_args(argv)


def recipe(args):
    """``(config, train_config)`` of the JAX tool's ``--device_graph``
    mode; fills ``args.frames`` and ``args.steps`` when unset."""
    from pointgnn_tpu_torch import configs

    n_classes = 2 if args.label_method == "Pedestrian_and_Cyclist" else 1
    if args.frames is None:
        args.frames = 14 * n_classes
    batch = 1  # one frame per device on the device graph
    if args.steps is None:
        args.steps = int(1200 * (args.frames / 14) * (2 / batch))
    config = configs.model_config(args.label_method, T=args.T)
    # focal loss converges on the tiny overfit task in O(100) steps
    config["loss"] = {
        "cls_loss_type": "focal_sigmoid",
        "cls_loss_weight": 1.0,
        "loc_loss_weight": 10.0,
    }
    train_config = configs.train_config(args.label_method)
    steps_per_epoch = args.frames // batch
    train_config.update(
        {
            "batch_size": batch,
            "NUM_GPU": 1,
            "num_load_dataset_workers": 2,
            # refetch (and re-randomize) every few servings: a model fit
            # to one frozen graph per frame fails on the runtime graph
            "load_dataset_every_N_time": 4,
            "max_epoch": max(args.steps // steps_per_epoch, 1),
            "max_steps": args.steps,
            "save_every_epoch": 15,
            "optimizer": "adam",
            "initial_lr": 1e-3,
            "decay_step": args.steps,
            # no augmentation: a clean overfit signal
            "data_aug_configs": [],
            "device_graph": True,
        }
    )
    return config, train_config


def _gt_counts(gt_dir):
    counts = {}
    for fn in os.listdir(gt_dir):
        with open(os.path.join(gt_dir, fn)) as f:
            for line in f:
                counts[line.split()[0]] = counts.get(line.split()[0], 0) + 1
    return counts


def run(args, config, train_config, serve_spec=None) -> int:
    """Train, evaluate, serve and score; returns the exit code.
    ``serve_spec`` sizes the serving graph (the config's runtime spec
    when None)."""
    from pointgnn_tpu_torch import configs
    from pointgnn_tpu_torch.data.kitti import KittiDataset
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.postprocess import kitti_eval
    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.train.evaluator import Evaluator
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.train.trainer import Trainer
    from pointgnn_tpu_torch.utils import synthetic_kitti

    wrappers = {"slab_edge_max": slab.slab_edge_max,
                "slab_edge_max_backward": slab.slab_edge_max_backward}
    launches = {}

    def counted(stage, fn):
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        launches[stage] = {k: w.launches - before[k]
                           for k, w in wrappers.items()}
        return out, seconds

    work = args.workdir or tempfile.mkdtemp(prefix="pointgnn_torch_smoke_")
    kitti_root = os.path.join(work, "kitti")
    train_dir = os.path.join(work, "train_dir")
    gen_classes = (("Pedestrian", "Cyclist")
                   if args.label_method == "Pedestrian_and_Cyclist"
                   else ("Car",))
    if not os.path.isdir(kitti_root):
        synthetic_kitti.main(kitti_root, args.frames, classes=gen_classes)
    train_config = dict(train_config, train_dir=train_dir)
    num_classes = config["num_classes"]
    spec = DatasetSpec.from_kitti_root(kitti_root, num_classes=num_classes)

    trainer = Trainer(config, train_config,
                      FetchSpec(spec, config, train_config),
                      num_frames=args.frames, device=args.device)
    try:
        start_step = trainer.restore()
        print("training %d steps..." % args.steps, flush=True)
        _, train_s = counted("train", trainer.train)
    finally:
        trainer.close()
    steps_run = trainer.global_step - start_step
    step_ms = trainer.step_log["step_ms"]
    frozen_tc = trainer.train_config
    del trainer
    last_step = ckpt.list_checkpoint_steps(train_dir)[-1]
    # a run resumed at its last step trains none
    median_ms = float(np.median(step_ms[1:] or step_ms)) if step_ms else None
    print("trained %d steps in %.1f s (%.2f steps/s; median step %s ms "
          "after the first)" % (
              steps_run, train_s, steps_run / max(train_s, 1e-9),
              median_ms), flush=True)

    # the new evaluator over the last checkpoint: the eval path on a
    # trained model
    eval_config = dict(configs.eval_config(args.label_method),
                       train_dir=train_dir,
                       eval_dir=os.path.join(work, "eval"))
    evaluator = Evaluator(config, eval_config,
                          FetchSpec(spec, config, eval_config, is_eval=True),
                          num_frames=args.frames, train_config=frozen_tc,
                          device=args.device)
    try:
        eval_results, eval_s = counted("eval", lambda: evaluator.eval_once(
            train_dir, eval_config["eval_dir"], last_step))
        eval_fps = evaluator.frames_per_second
    finally:
        evaluator.close()
    print("evaluator, step %d: total_loss %.5f, %s" % (
        last_step, eval_results["total_loss"], ", ".join(
            "%s %.4f" % (k, eval_results[k]) for k in sorted(eval_results)
            if k.startswith(("recall_", "precision_", "mAP_")))), flush=True)

    dataset = KittiDataset(
        os.path.join(kitti_root, "image/training/image_2"),
        os.path.join(kitti_root, "velodyne/training/velodyne"),
        os.path.join(kitti_root, "calib/training/calib"),
        os.path.join(kitti_root, "labels/training/label_2"),
        num_classes=num_classes,
    )
    gt_dir = os.path.join(kitti_root, "labels/training/label_2")
    for cls_name, n in sorted(_gt_counts(gt_dir).items()):
        if n < 41:
            print("WARNING: only %d %s ground truths: the 11-point protocol "
                  "indexes its 41 recall bins by matched-GT scores, so "
                  "perfect detections cap at ~%.1f AP; raise --frames"
                  % (n, cls_name, 100.0 * (n // 4 + 1) / 11))

    for path, why in SKIPPED.items():
        print("%s: skipped (%s)" % (path, why))
    pipeline = InferencePipeline(config, checkpoint_dir=train_dir,
                                 device_spec=serve_spec, device=args.device)
    # the KITTI conversion (projection, clipping, occlusion rescoring)
    # is in no run_dataset bucket: time it per frame
    convert_s, detections = [], []
    to_kitti = pipeline.detections_to_kitti

    def timed_to_kitti(*a, **kw):
        t0 = time.perf_counter()
        labels = to_kitti(*a, **kw)
        convert_s.append(time.perf_counter() - t0)
        detections.append(len(labels))
        return labels

    pipeline.detections_to_kitti = timed_to_kitti
    result_dir = os.path.join(work, "results_fast")
    buckets, serve_s = counted("serve", lambda: pipeline.run_dataset(
        dataset, result_dir))
    results = kitti_eval.evaluate(gt_dir, result_dir)
    label = "fast(on-device)"
    for key in sorted(results):
        print("[%s] %s: AP %.2f  AP_R40 %.2f" % (
            label, key, results[key]["ap"], results[key]["ap_r40"]))
    keys = [k for k in results if k.endswith("_3d_moderate")] or [
        "Car_3d_moderate"]
    ap = float(np.mean([results.get(k, {}).get("ap", 0.0) for k in keys]))
    bev_keys = [k for k in results if k.endswith("_bev_moderate")] or [
        "Car_bev_moderate"]
    # gate on the worst class: one collapsed class fails the run
    bev = float(np.min([results.get(k, {}).get("ap", 0.0)
                        for k in bev_keys]))
    print("3d_moderate AP (mean over classes): fast %.2f  (workdir %s)"
          % (ap, work))
    print("bev_moderate AP (min over classes): fast %.2f" % bev)
    failed = False
    if args.min_ap >= 0 and ap < args.min_ap:
        print("FAIL: 3D %.2f below --min_ap %.2f" % (ap, args.min_ap))
        failed = True
    if args.min_bev_ap >= 0 and bev < args.min_bev_ap:
        print("FAIL: BEV %.2f below --min_bev_ap %.2f"
              % (bev, args.min_bev_ap))
        failed = True
    print(json.dumps({
        "passed": not failed,
        "bev_moderate_min": bev,
        "3d_moderate_mean": ap,
        "ap": results,
        "steps": steps_run,
        "train_s": train_s,
        "steps_per_s": steps_run / max(train_s, 1e-9),
        "median_step_ms_after_first": median_ms,
        "eval_s": eval_s,
        "eval_frames_per_s": eval_fps,
        "eval_total_loss": eval_results["total_loss"],
        "serve_s": serve_s,
        "serve_ms_per_frame": {k: 1e3 * v for k, v in buckets.items()},
        "kitti_conversion_ms_per_frame": [1e3 * s for s in convert_s],
        "detections_per_frame": detections,
        "launches": launches,
    }))
    return 1 if failed else 0


def main(argv=None):
    args = parse_args(argv)
    config, train_config = recipe(args)
    return run(args, config, train_config)


if __name__ == "__main__":
    sys.exit(main())
