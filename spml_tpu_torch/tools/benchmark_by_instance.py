"""Benchmark predictions by instance-weighted IoU.

The port's counterpart of pyscripts/benchmark/benchmark_by_instance.py
(the reference's flags, twke18/SPML: --pred_dir --gt_dir --inst_dir
--num_classes --string_replace). It reads PNGs on the host and needs no
card, so it has no --device:

    python -m spml_tpu_torch.tools.benchmark_by_instance \
        --pred_dir OUT/semantic_gray --gt_dir GT --inst_dir INST
"""

import argparse
import os

import numpy as np
import PIL.Image

from spml_tpu_torch.utils import metrics


def main():
    parser = argparse.ArgumentParser(
        description="Benchmark segmentation by instance-weighted IoU")
    parser.add_argument("--pred_dir", type=str, default="")
    parser.add_argument("--gt_dir", type=str, default="")
    parser.add_argument("--inst_dir", type=str, default="")
    parser.add_argument("--num_classes", type=int, default=21)
    parser.add_argument("--string_replace", type=str, default=",")
    args = parser.parse_args()

    meter = metrics.InstanceWeightedIoU(args.num_classes)
    for dirpath, _, filenames in os.walk(args.pred_dir):
        for filename in filenames:
            predname = os.path.join(dirpath, filename)
            gtname = predname.replace(args.pred_dir, args.gt_dir)
            instname = predname.replace(args.pred_dir, args.inst_dir)
            if args.string_replace:
                stra, strb = args.string_replace.split(",")
                gtname = gtname.replace(stra, strb)
                instname = instname.replace(stra, strb)
            pred = np.asarray(PIL.Image.open(predname).convert("L"),
                              np.uint8)
            gt = np.asarray(PIL.Image.open(gtname).convert("L"), np.uint8)
            inst = np.asarray(PIL.Image.open(instname).convert("P"),
                              np.uint8)
            meter.update(pred, gt, inst)

    result = meter.result()
    iou = result["class_iou"] * 100.0
    for i in range(args.num_classes):
        print(f"class {i:02d}, acc: {iou[i]:4.4f}%")
    print(f"mean IOU: {result['mean_iou'] * 100:4.4f}%")


if __name__ == "__main__":
    main()
