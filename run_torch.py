#!/usr/bin/env python3
"""Point-GNN inference on KITTI with the PyTorch/CUDA port.

The counterpart of ``run.py``, with the same flags and defaults plus
``--device`` (``cuda`` unless asked otherwise):

    python3 run_torch.py <checkpoint_path> [--fast] [--dataset_root_dir D] \
        [--dataset_split_file F] [--output_dir O] [--test] [-l LEVEL] \
        [--no-box-merge] [--no-box-score] [--num_frames N] [--device cpu]

The checkpoint directory holds a frozen ``config`` and a checkpoint in
the port's format (``pointgnn_tpu_torch.train.checkpoint``; convert a
JAX one with ``convert_jax_checkpoint.py``).  Detections are written in
KITTI label format to ``<output_dir>/data/*.txt``.  By default each
frame's graph is built on the host and padded to the config family's
runtime capacity (grown to fit), and the network runs on the card in f32
on the segment path; ``--fast`` builds the graphs on the device (the
slab kernels, bf16).  ``-l 1`` also draws each frame's detections over
its camera image and a bird's-eye view into ``<output_dir>/vis/``
(``-l 2`` adds a 3D view: an Open3D render when Open3D imports, else a
second bird's-eye view); it serves frame by frame, also with
``--fast``, and writes the same KITTI text.  The last line of the output is the launch count of
each hand-written kernel in the run, as JSON (all 0 without ``--fast``).
"""

import argparse
import json
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Point-GNN inference on KITTI (PyTorch/CUDA port)"
    )
    parser.add_argument("checkpoint_path", type=str, help="Path to checkpoint")
    parser.add_argument(
        "-l", "--level", type=int, default=0,
        help="Visualization level: 0 off; 1 writes <output_dir>/vis/"
        "<frame>.png and <frame>_bev.png; 2 also <frame>_3d.png",
    )
    parser.add_argument(
        "--fast", dest="fast", action="store_true", default=False,
        help="Build graphs on the device (default: on the host)",
    )
    parser.add_argument(
        "--test", dest="test", action="store_true", default=False,
        help="Run on the test split (no labels)",
    )
    parser.add_argument(
        "--no-box-merge", dest="use_box_merge", action="store_false",
        default=True, help="Disable box merge",
    )
    parser.add_argument(
        "--no-box-score", dest="use_box_score", action="store_false",
        default=True, help="Disable box score",
    )
    parser.add_argument(
        "--dataset_root_dir", type=str, default="../dataset/kitti/",
        help="Path to KITTI dataset",
    )
    parser.add_argument(
        "--dataset_split_file", type=str, default="",
        help="Path to dataset split file (default 3DOP_splits/val.txt)",
    )
    parser.add_argument(
        "--output_dir", type=str, default="",
        help="Detection output dir (default CHECKPOINT_PATH/eval/)",
    )
    parser.add_argument(
        "--num_frames", type=int, default=-1,
        help="Limit the number of frames (debug)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Torch device (default cuda; cpu runs the kernels' plain "
        "versions)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from pointgnn_tpu_torch.data.kitti import KittiDataset
    from pointgnn_tpu_torch.infer import InferencePipeline
    from pointgnn_tpu_torch.nn import edge_tail, slab
    from pointgnn_tpu_torch.utils import config_io

    dataset_dir = args.dataset_root_dir
    split_file = args.dataset_split_file or os.path.join(
        dataset_dir, "3DOP_splits/val.txt"
    )
    output_dir = args.output_dir or os.path.join(
        args.checkpoint_path, "eval"
    )
    config_path = os.path.join(args.checkpoint_path, "config")
    if not os.path.isfile(config_path):
        print("No config file found in %s" % args.checkpoint_path,
              file=sys.stderr)
        return 2
    config = config_io.load_config(config_path)

    if args.test:
        dataset = KittiDataset(
            os.path.join(dataset_dir, "image/testing/image_2"),
            os.path.join(dataset_dir, "velodyne/testing/velodyne/"),
            os.path.join(dataset_dir, "calib/testing/calib/"),
            "",
            num_classes=config["num_classes"],
            is_training=False,
        )
    else:
        dataset = KittiDataset(
            os.path.join(dataset_dir, "image/training/image_2"),
            os.path.join(dataset_dir, "velodyne/training/velodyne/"),
            os.path.join(dataset_dir, "calib/training/calib/"),
            os.path.join(dataset_dir, "labels/training/label_2"),
            split_file,
            num_classes=config["num_classes"],
        )

    pipeline = InferencePipeline(
        config,
        checkpoint_dir=args.checkpoint_path,
        use_box_merge=args.use_box_merge,
        use_box_score=args.use_box_score,
        device=args.device,
        on_device_graph=args.fast,
    )
    print("Restored step %d from %s" % (
        pipeline.restored_step, args.checkpoint_path
    ))
    wrappers = {"slab_edge_max": slab.slab_edge_max,
                "slab_edge_max_backward": slab.slab_edge_max_backward,
                "edge_tail_max": edge_tail.edge_tail_max,
                "fused_edge_max": edge_tail.fused_edge_max}
    before = {k: fn.launches for k, fn in wrappers.items()}
    pipeline.run_dataset(
        dataset, output_dir, num_frames=args.num_frames, is_test=args.test,
        visualization_level=args.level,
    )
    print("Detections written to %s/data" % output_dir)
    print(json.dumps({"launches": {
        k: fn.launches - before[k] for k, fn in wrappers.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
