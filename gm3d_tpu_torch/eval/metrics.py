"""Classification accuracy and ShapeNetPart mIoU.

Own copy of ``gm3d_tpu/eval/metrics.py`` (numpy).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """The share of rows whose arg-max is the label."""
    return float((np.asarray(logits).argmax(-1) == np.asarray(labels)).mean())


def part_miou(
    pred: np.ndarray,
    target: np.ndarray,
    cls_labels: np.ndarray,
    seg_classes: Dict[str, Sequence[int]],
    cls_names: Sequence[str],
) -> Dict[str, float]:
    """Category / instance mIoU, Point-MAE segmentation protocol: per shape,
    IoU of each part label valid for its category (union-empty parts count
    as IoU 1), averaged per shape (instance) and per category (class).

    pred, target: (B, N) part labels; cls_labels: (B,) category ids.
    """
    shape_ious = {name: [] for name in seg_classes}
    for i in range(pred.shape[0]):
        cat = cls_names[int(cls_labels[i])]
        parts = seg_classes[cat]
        ious = []
        for part in parts:
            pred_p = pred[i] == part
            targ_p = target[i] == part
            union = np.logical_or(pred_p, targ_p).sum()
            if union == 0:
                ious.append(1.0)
            else:
                ious.append(np.logical_and(pred_p, targ_p).sum() / union)
        shape_ious[cat].append(float(np.mean(ious)))

    all_shape_ious = [iou for lst in shape_ious.values() for iou in lst]
    cat_means = [float(np.mean(lst)) for lst in shape_ious.values() if lst]
    return {
        "instance_miou": float(np.mean(all_shape_ious)) if all_shape_ious else 0.0,
        "class_miou": float(np.mean(cat_means)) if cat_means else 0.0,
        "per_class": {k: float(np.mean(v)) if v else 0.0 for k, v in shape_ious.items()},
    }
