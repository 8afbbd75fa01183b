"""A tiny CPU run of a cell: the harness's look for a chip skipped, the
program on its plain PyTorch kernels, every size small."""

import argparse
import time

import torch

from benchmark.core import harness

TINY = {"serving": {"num_points": 2048, "num_keypoints": 2048,
                    "max_hypotheses": 512},
        "mix": {"points_per_beam": [24, 30], "pool_frames": 3,
                "warmup_frames": 1, "sample_frames": 2}}


def tiny_run(workload, seed=2 ** 31 + 77, trace=0, seconds=10.0, **where):
    torch.set_num_threads(4)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.run_cell(args, time.time(), torch.device("cpu"),
                            overrides=TINY, **where)
