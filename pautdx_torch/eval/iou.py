"""1D interval-IoU evaluation: IoU stats, accuracy@IoU, greedy matching.

The port's own copy of ``pautdx/eval/iou.py`` (host numpy):
- IoU mean/median/std and accuracy@IoU{0.1,0.2,0.3,0.5};
- greedy 1D-IoU > t matching for precision/recall/F1 over detected
  intervals.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def interval_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lo = np.maximum(a[..., 0], b[..., 0])
    hi = np.minimum(a[..., 1], b[..., 1])
    inter = np.maximum(hi - lo, 0.0)
    union = (a[..., 1] - a[..., 0]) + (b[..., 1] - b[..., 0]) - inter
    return inter / np.maximum(union, 1e-8)


def iou_statistics(pred: np.ndarray, target: np.ndarray, mask: np.ndarray,
                   thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.5)
                   ) -> Dict[str, float]:
    keep = np.asarray(mask).reshape(-1) > 0
    p = np.asarray(pred).reshape(-1, 2)[keep]
    t = np.asarray(target).reshape(-1, 2)[keep]
    if p.shape[0] == 0:
        return {"iou_mean": float("nan"), "iou_median": float("nan"),
                "iou_std": float("nan"),
                **{f"acc@{th}": float("nan") for th in thresholds}}
    iou = interval_iou(p, t)
    out = {"iou_mean": float(iou.mean()), "iou_median": float(np.median(iou)),
           "iou_std": float(iou.std())}
    for th in thresholds:
        out[f"acc@{th}"] = float((iou >= th).mean())
    return out


def greedy_match(pred_intervals: List[Tuple[float, float]],
                 gt_intervals: List[Tuple[float, float]],
                 iou_threshold: float = 0.5) -> Tuple[int, int, int]:
    """Greedy best-IoU matching; returns (tp, fp, fn)."""
    gt_used = [False] * len(gt_intervals)
    tp = 0
    for p in pred_intervals:
        best, best_i = 0.0, -1
        for i, g in enumerate(gt_intervals):
            if gt_used[i]:
                continue
            iou = interval_iou(np.asarray(p, np.float32),
                               np.asarray(g, np.float32))
            if iou > best:
                best, best_i = float(iou), i
        if best >= iou_threshold and best_i >= 0:
            gt_used[best_i] = True
            tp += 1
    fp = len(pred_intervals) - tp
    fn = len(gt_intervals) - tp
    return tp, fp, fn


def detection_prf(pred_intervals_per_item, gt_intervals_per_item,
                  iou_threshold: float = 0.5) -> Dict[str, float]:
    tp = fp = fn = 0
    for p, g in zip(pred_intervals_per_item, gt_intervals_per_item):
        a, b, c = greedy_match(list(p), list(g), iou_threshold)
        tp, fp, fn = tp + a, fp + b, fn + c
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"precision": precision, "recall": recall, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn}
