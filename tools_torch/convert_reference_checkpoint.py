#!/usr/bin/env python3
"""Convert a reference (TF1) Point-GNN checkpoint into a port checkpoint.

Input: an ``.npz`` dump of the TF checkpoint variables (see
``pointgnn_tpu_torch/train/convert.py``'s docstring for the one-line dump
recipe) plus the reference config JSON frozen next to the checkpoint.
Output: a checkpoint directory in the port's format (``config`` and
``model-<step>/params.npz``) that ``run_torch.py`` and ``eval_torch.py``
load.  Nothing runs on a card: the arrays are converted on the CPU.

Usage:
    python tools_torch/convert_reference_checkpoint.py car_T3.npz \\
        <reference_checkpoint_dir>/config <output_train_dir> [--step N]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Reference TF checkpoint (.npz dump) -> port checkpoint"
    )
    parser.add_argument("npz", type=str)
    parser.add_argument("config", type=str, help="reference config JSON")
    parser.add_argument("output_dir", type=str)
    parser.add_argument(
        "--step", type=int, default=0,
        help="global step to record (e.g. 1400000)",
    )
    args = parser.parse_args(argv)

    from pointgnn_tpu_torch.train import checkpoint as ckpt
    from pointgnn_tpu_torch.train.convert import convert_reference_weights
    from pointgnn_tpu_torch.utils.config_io import load_config

    config = load_config(args.config)
    tf_vars = dict(np.load(args.npz))
    params = convert_reference_weights(
        tf_vars,
        config["model_kwargs"]["layer_configs"],
        config["num_classes"],
        device="cpu",
    )
    os.makedirs(args.output_dir, exist_ok=True)
    ckpt.save_checkpoint(
        args.output_dir, args.step, {"params": params}, config=config
    )

    def count(node):
        if node is None:
            return 0
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(count(v) for v in node)
        return 1

    print("converted %d arrays -> %s (step %d)"
          % (count(params), args.output_dir, args.step))
    return 0


if __name__ == "__main__":
    sys.exit(main())
