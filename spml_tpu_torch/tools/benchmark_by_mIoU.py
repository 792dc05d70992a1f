"""Benchmark predictions by mean IoU over prediction/GT PNG directories.

The port's counterpart of pyscripts/benchmark/benchmark_by_mIoU.py (the
reference's flags, twke18/SPML: --pred_dir --gt_dir --num_classes
--string_replace; the class-name table and the percent-formatted report).
It reads PNGs on the host and needs no card, so it has no --device:

    python -m spml_tpu_torch.tools.benchmark_by_mIoU \
        --pred_dir OUT/semantic_gray --gt_dir GT --num_classes 21
"""

import argparse
import os

import numpy as np
import PIL.Image

from spml_tpu_torch.utils import metrics

VOC_CLASSES = ['Background', 'Aero', 'Bike', 'Bird', 'Boat', 'Bottle',
               'Bus', 'Car', 'Cat', 'Chair', 'Cow', 'Table', 'Dog',
               'Horse', 'MBike', 'Person', 'Plant', 'Sheep', 'Sofa',
               'Train', 'TV']
DENSEPOSE_CLASSES = ['Background', 'Torso', 'R. Hand', 'L. Hand',
                     'L. Foot', 'R. Foot', 'R. Thigh', 'L. Thigh',
                     'R. Leg', 'L. Leg', 'L. Arm', 'R. Arm',
                     'L. Forearm', 'R. Forearm', 'Head']


def main():
    parser = argparse.ArgumentParser(
        description="Benchmark segmentation predictions")
    parser.add_argument("--pred_dir", type=str, default="")
    parser.add_argument("--gt_dir", type=str, default="")
    parser.add_argument("--num_classes", type=int, default=21)
    parser.add_argument("--string_replace", type=str, default=",")
    args = parser.parse_args()

    assert os.path.isdir(args.pred_dir), args.pred_dir
    assert os.path.isdir(args.gt_dir), args.gt_dir
    print(args.pred_dir)

    meter = metrics.MeanIoU(args.num_classes)
    for dirpath, _, filenames in os.walk(args.pred_dir):
        for filename in filenames:
            predname = os.path.join(dirpath, filename)
            gtname = predname.replace(args.pred_dir, args.gt_dir)
            if args.string_replace:
                stra, strb = args.string_replace.split(",")
                gtname = gtname.replace(stra, strb)
            pred = np.asarray(PIL.Image.open(predname).convert("L"),
                              np.uint8)
            gt = np.asarray(PIL.Image.open(gtname).convert("L"), np.uint8)
            meter.update(pred, gt)

    result = meter.result()
    iou = result["class_iou"] * 100.0
    names = (DENSEPOSE_CLASSES if args.num_classes == 15 else VOC_CLASSES)
    for i in range(min(args.num_classes, len(names))):
        print(f"class {names[i]:10s}: {i:02d}, acc: {iou[i]:4.4f}%")
    print(f"mean IOU: {result['mean_iou'] * 100:4.4f}%")
    print(f"mean Pixel Acc: {result['pixel_accuracy'] * 100:4.4f}%")


if __name__ == "__main__":
    main()
