#!/usr/bin/env python3
"""Generate per-class KITTI split files.

The reference ships pre-filtered index lists (train_car.txt,
train_pedestrian_cyclist.txt, trainval_car.txt,
trainval_pedestrian_cyclist.txt): the 3DOP train/trainval frame lists
reduced to frames that hold at least one labeled object of the target
class(es).  This tool makes such lists from any KITTI ``label_2``
directory.

Usage:
    python tools_torch/make_splits.py <dataset_root> --classes Car \\
        [--base-split 3DOP_splits/train.txt] --output splits/train_car.txt

``dataset_root`` is the KITTI root (labels under
``labels/training/label_2``); ``--label-dir`` points anywhere else.
Without ``--base-split`` every labeled frame is considered.
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def frames_with_classes(label_dir, frame_ids, class_names):
    """Frame ids (in the given order) whose label file holds at least one
    object whose type is in ``class_names``."""
    from pointgnn_tpu_torch.data.kitti import parse_label_line

    keep = []
    wanted = set(class_names)
    for fid in frame_ids:
        with open(os.path.join(label_dir, fid + ".txt")) as f:
            labels = [parse_label_line(line) for line in f if line.strip()]
        if any(lab is not None and lab["name"] in wanted for lab in labels):
            keep.append(fid)
    return keep


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Filter a KITTI split to frames containing classes"
    )
    parser.add_argument("dataset_root", type=str)
    parser.add_argument(
        "--classes", nargs="+", required=True,
        help="e.g. Car, or: Pedestrian Cyclist",
    )
    parser.add_argument(
        "--base-split", type=str, default=None,
        help="file of frame ids to filter (default: all labeled frames)",
    )
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument(
        "--label-dir", type=str, default=None,
        help="override the label directory (default "
             "<dataset_root>/labels/training/label_2)",
    )
    args = parser.parse_args(argv)

    label_dir = args.label_dir or os.path.join(
        args.dataset_root, "labels", "training", "label_2"
    )
    if args.base_split:
        with open(args.base_split) as f:
            frame_ids = [
                line.strip().split(".")[0] for line in f if line.strip()
            ]
    else:
        frame_ids = sorted(
            f.split(".")[0] for f in os.listdir(label_dir)
            if f.endswith(".txt")
        )
    keep = frames_with_classes(label_dir, frame_ids, args.classes)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        for fid in keep:
            f.write(fid + "\n")
    print("%d/%d frames contain %s -> %s" % (
        len(keep), len(frame_ids), "/".join(args.classes), args.output
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
