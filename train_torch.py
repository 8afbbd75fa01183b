#!/usr/bin/env python3
"""Point-GNN training on KITTI with the PyTorch/CUDA port.

The counterpart of ``train.py``, with the same arguments plus
``--device`` (``cuda`` unless asked otherwise):

    python3 train_torch.py <train_config_path> <config_path> \
        [--dataset_root_dir D] [--dataset_split_file F] [--device cpu]

Config names from the built-in registry (e.g. ``car_auto_T3_train``)
are accepted in place of file paths.  The run trains on device-built
graphs (``"device_graph"`` true, or unset for a config without
normalized MLPs): slab graphs, or capped edge lists with
``"device_graph_slab": false``; or on host-built graphs
(``"device_graph": false``, and unset for a config with a normalized
MLP: the provider's workers build each frame's graph, the step's frames
are unioned and padded to the family's ``frame_capacity``), checkpoints
to the train_config's ``train_dir`` in
the port's format (``run_torch.py`` serves it) and resumes from the
latest checkpoint there.

On the card, the run is data-parallel over ``min(NUM_GPU *
COPY_PER_GPU, cards visible)`` cards: one process per card, joined by
NCCL (``pointgnn_tpu_torch.parallel.mesh.launch``), each taking
``batch_size / n`` frames of every step; rank 0 writes the checkpoints
and prints the epoch log.  One card, a named card (``--device
cuda:1``) or ``--device cpu`` trains in this process.  The last line of the output is JSON: rank 0's launch
count of each hand-written kernel, the steps run and, per step, the host
wall time and the part of it the loop waited for its prefetched batch
(ms) and the total loss; then the number of ranks and every rank's
launch counts.
"""

import argparse
import json
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Training of Point-GNN (PyTorch/CUDA port)"
    )
    parser.add_argument(
        "train_config_path", type=str, help="Path to train_config"
    )
    parser.add_argument("config_path", type=str, help="Path to config")
    parser.add_argument(
        "--dataset_root_dir", type=str, default="../dataset/kitti/",
        help="Path to KITTI dataset",
    )
    parser.add_argument(
        "--dataset_split_file", type=str, default="",
        help="Path to the split file "
        "(default DATASET_ROOT_DIR/3DOP_splits/<train_dataset>)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Torch device (default cuda; cpu runs the kernels' plain "
        "versions)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from pointgnn_tpu_torch.parallel import mesh
    from pointgnn_tpu_torch.train.pipeline import DatasetSpec, FetchSpec
    from pointgnn_tpu_torch.train.trainer import num_ranks, run_training
    from pointgnn_tpu_torch.utils import config_io

    train_config = config_io.load_train_config(args.train_config_path)
    config_complete = config_io.load_config(args.config_path)
    config = config_complete.get("train", config_complete)

    split_file = args.dataset_split_file or os.path.join(
        args.dataset_root_dir,
        "3DOP_splits",
        train_config["train_dataset"],
    )
    spec = DatasetSpec.from_kitti_root(
        args.dataset_root_dir, split_file, num_classes=config["num_classes"]
    )
    num_frames = spec.build().num_files
    if train_config.get("NUM_TEST_SAMPLE", -1) > 0:
        num_frames = min(num_frames, train_config["NUM_TEST_SAMPLE"])
    print("Training on %d frames" % num_frames)

    fetch_spec = FetchSpec(spec, config, train_config)
    n_ranks = num_ranks(train_config, args.device)
    if n_ranks > 1:
        print("Training data-parallel over %d cards" % n_ranks)
        results = mesh.launch(run_training, n_ranks, config, train_config,
                              fetch_spec, num_frames)
    else:
        results = [run_training(None, config, train_config, fetch_spec,
                                num_frames, device=args.device)]
    print(json.dumps(dict(
        results[0], ranks=n_ranks,
        rank_launches=[r["launches"] for r in results])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
