#!/usr/bin/env python3
"""Build the crop-paste augmentation library from a KITTI training set.

Offline step of the crop augmentation: crops every ground-truth object's
point cluster into a JSON library that ``CropAugSampler``
(``pointgnn_tpu_torch/data/crop_aug.py``) samples from at train time
(enable it with a ``crop_aug`` block in the train_config).

Usage:
    python tools_torch/build_crop_library.py <dataset_root> <output.json> \\
        [--split 3DOP_splits/train.txt] [--min_points 10] \\
        [--expand 1.1 1.1 1.1] [--backlist Van Truck]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build crop-aug library")
    parser.add_argument("dataset_root", type=str)
    parser.add_argument("output", type=str)
    parser.add_argument("--split", type=str, default="3DOP_splits/train.txt")
    parser.add_argument("--min_points", type=int, default=10)
    parser.add_argument(
        "--expand", type=float, nargs=3, default=[1.1, 1.1, 1.1]
    )
    parser.add_argument("--backlist", type=str, nargs="*", default=[])
    args = parser.parse_args(argv)

    from pointgnn_tpu_torch.data.crop_aug import save_cropped_boxes
    from pointgnn_tpu_torch.data.kitti import KittiDataset

    dataset = KittiDataset(
        os.path.join(args.dataset_root, "image/training/image_2"),
        os.path.join(args.dataset_root, "velodyne/training/velodyne/"),
        os.path.join(args.dataset_root, "calib/training/calib/"),
        os.path.join(args.dataset_root, "labels/training/label_2"),
        os.path.join(args.dataset_root, args.split),
    )
    save_cropped_boxes(
        dataset,
        args.output,
        expand_factor=tuple(args.expand),
        minimum_points=args.min_points,
        backlist=args.backlist,
    )
    print("crop library written to %s" % args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
