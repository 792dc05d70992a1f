"""Segmentation metrics (mIoU, pixel accuracy, instance-weighted IoU).

The port's own copy of spml_tpu/utils/metrics.py (numpy only). Behavioral
reference: pyscripts/benchmark/benchmark_by_mIoU.py:25-117 and
benchmark_by_instance.py:88-115 in twke18/SPML — per-class TP/FP/FN
histograms over prediction PNGs vs ground truth, ignoring label 255.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                     ignore_index: int = 255) -> np.ndarray:
    """[C, C] counts; rows = ground truth, cols = prediction."""
    valid = (gt != ignore_index) & (gt < num_classes)
    p = pred[valid].astype(np.int64)
    g = gt[valid].astype(np.int64)
    p = np.clip(p, 0, num_classes - 1)
    return np.bincount(g * num_classes + p,
                       minlength=num_classes ** 2).reshape(num_classes,
                                                           num_classes)


class MeanIoU:
    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.hist = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        self.hist += confusion_matrix(pred, gt, self.num_classes,
                                      self.ignore_index)

    def result(self) -> dict:
        hist = self.hist.astype(np.float64)
        tp = np.diag(hist)
        fn = hist.sum(1) - tp
        fp = hist.sum(0) - tp
        denom = tp + fn + fp
        iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
        pixel_acc = tp.sum() / max(hist.sum(), 1)
        return {"class_iou": iou, "mean_iou": float(iou.mean()),
                "pixel_accuracy": float(pixel_acc)}


class InstanceWeightedIoU:
    """IoU weighted per ground-truth instance
    (benchmark_by_instance.py:88-115): each (class, instance) region
    contributes its own IoU against the predicted class mask."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.total = np.zeros(num_classes, np.float64)
        self.count = np.zeros(num_classes, np.int64)

    def update(self, pred: np.ndarray, gt_sem: np.ndarray,
               gt_inst: np.ndarray) -> None:
        valid = gt_sem != self.ignore_index
        for cls in np.unique(gt_sem[valid]):
            if cls >= self.num_classes:
                continue
            cls_mask = (gt_sem == cls) & valid
            pred_mask = (pred == cls) & valid
            for inst in np.unique(gt_inst[cls_mask]):
                inst_mask = cls_mask & (gt_inst == inst)
                inter = np.sum(inst_mask & pred_mask)
                union = np.sum(inst_mask | pred_mask)
                if union > 0:
                    self.total[cls] += inter / union
                    self.count[cls] += 1

    def result(self) -> dict:
        present = self.count > 0
        per_class = np.where(present, self.total / np.maximum(self.count, 1),
                             0.0)
        mean = float(per_class[present].mean()) if present.any() else 0.0
        return {"class_iou": per_class, "mean_iou": mean}
