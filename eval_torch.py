#!/usr/bin/env python3
"""Continuous Point-GNN evaluation on KITTI with the PyTorch/CUDA port.

The counterpart of ``eval.py``, with the same arguments plus
``--device`` (``cuda`` unless asked otherwise):

    python3 eval_torch.py <eval_config_path> [--dataset_root_dir D] \
        [--dataset_split_file F] [--device cpu]

The eval_config names the ``train_dir`` to poll; the ``config`` and
``train_config`` frozen there (``train_torch.py`` writes both) define
the model and the graphs it trained on.  Each checkpoint in the port's
format is evaluated once, its scalars written to the eval_config's
``eval_dir`` (default ``<train_dir>/eval``); the run returns after a
checkpoint at or past ``max_step``.  The last line of the output is the
launch count of each hand-written kernel in the run, as JSON.
"""

import argparse
import json
import os
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Continuous evaluation of Point-GNN (PyTorch/CUDA port)"
    )
    parser.add_argument("eval_config_path", type=str,
                        help="Path to eval_config")
    parser.add_argument(
        "--dataset_root_dir", type=str, default="../dataset/kitti/",
        help="Path to KITTI dataset",
    )
    parser.add_argument(
        "--dataset_split_file", type=str, default="",
        help="Path to the split file "
        "(default DATASET_ROOT_DIR/3DOP_splits/<eval_dataset>)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Torch device (default cuda; cpu runs the kernels' plain "
        "versions)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from pointgnn_tpu_torch.nn import slab
    from pointgnn_tpu_torch.train.evaluator import Evaluator
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.utils import config_io

    eval_config = config_io.load_train_config(args.eval_config_path)
    train_dir = eval_config["train_dir"]
    eval_dir = eval_config.get("eval_dir", os.path.join(train_dir, "eval"))
    config_path = os.path.join(train_dir, "config")
    # wait for training to freeze a config
    while not os.path.isfile(config_path):
        print("No config found in %s, waiting" % train_dir)
        time.sleep(eval_config.get("eval_every_second", 60))
    config_complete = config_io.load_config(config_path)
    config = config_complete.get("eval", config_complete)
    # how the checkpoint was trained: device_graph and the frozen spec
    # decide the graphs it is evaluated on
    train_config_path = os.path.join(train_dir, "train_config")
    train_config = (
        config_io.load_train_config(train_config_path)
        if os.path.isfile(train_config_path) else {}
    )

    split_file = args.dataset_split_file or os.path.join(
        args.dataset_root_dir, "3DOP_splits", eval_config["eval_dataset"]
    )
    spec = DatasetSpec.from_kitti_root(
        args.dataset_root_dir, split_file, num_classes=config["num_classes"]
    )
    num_frames = spec.build().num_files
    if eval_config.get("NUM_TEST_SAMPLE", -1) > 0:
        num_frames = min(num_frames, eval_config["NUM_TEST_SAMPLE"])
    print("Evaluating on %d frames" % num_frames)

    wrappers = {"slab_edge_max": slab.slab_edge_max,
                "slab_edge_max_backward": slab.slab_edge_max_backward}
    evaluator = Evaluator(
        config,
        eval_config,
        FetchSpec(spec, config, eval_config, is_eval=True),
        num_frames=num_frames,
        train_config=train_config,
        device=args.device,
    )
    before = {k: fn.launches for k, fn in wrappers.items()}
    try:
        evaluator.eval_repeat(
            train_dir,
            eval_dir,
            eval_every_second=eval_config.get("eval_every_second", 60),
            max_step=eval_config.get("max_step", -1),
        )
    finally:
        evaluator.close()
    print(json.dumps({"launches": {
        k: fn.launches - before[k] for k, fn in wrappers.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
