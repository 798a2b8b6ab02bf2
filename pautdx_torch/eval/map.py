"""COCO-style mAP for 2D boxes (mAP@0.5 and mAP@[.5:.95]).

The port's own copy of ``pautdx/eval/map.py`` (numpy): 101-point
interpolated AP per class, greedy IoU matching by descending score, each
prediction matched to the best ground truth not yet taken.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) x (m, 4) -> (n, m) IoU."""
    a = a[:, None, :]
    b = b[None, :, :]
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., 2:], b[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """101-point interpolation (COCO)."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(r, grid, side="left")
    idx = np.clip(idx, 0, p.size - 1)
    return float(p[idx].mean())


def evaluate_map(predictions: List[Dict[str, np.ndarray]],
                 ground_truths: List[Dict[str, np.ndarray]],
                 iou_thresholds: Sequence[float] = (0.5,),
                 num_classes: int = 1) -> Dict[str, float]:
    """predictions[i]: {boxes (n,4) xyxy, scores (n,), classes (n,)};
    ground_truths[i]: {boxes (m,4), classes (m,)}. Images are index-aligned.
    """
    if len(predictions) != len(ground_truths):
        # zip would silently truncate and score the wrong image pairing
        raise ValueError(
            f"predictions ({len(predictions)}) and ground_truths "
            f"({len(ground_truths)}) must be index-aligned")
    ap_per_thresh = []
    for iou_t in iou_thresholds:
        aps = []
        for c in range(num_classes):
            records = []   # (score, is_tp)
            n_gt = 0
            for pred, gt in zip(predictions, ground_truths):
                gt_keep = np.asarray(gt["classes"]).reshape(-1) == c
                gt_boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)[gt_keep]
                n_gt += gt_boxes.shape[0]
                p_keep = np.asarray(pred["classes"]).reshape(-1) == c
                p_boxes = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)[p_keep]
                p_scores = np.asarray(pred["scores"], np.float32).reshape(-1)[p_keep]
                order = np.argsort(-p_scores)
                p_boxes, p_scores = p_boxes[order], p_scores[order]
                used = np.zeros(gt_boxes.shape[0], bool)
                if p_boxes.shape[0] and gt_boxes.shape[0]:
                    ious = box_iou_xyxy(p_boxes, gt_boxes)
                else:
                    ious = np.zeros((p_boxes.shape[0], gt_boxes.shape[0]))
                for i in range(p_boxes.shape[0]):
                    # argmax over UNUSED gts only (COCO/Ultralytics
                    # semantics): a prediction whose best-IoU gt is taken
                    # must still match the best remaining gt above the
                    # threshold, or mAP under-reports on overlapping
                    # defects
                    row = np.where(used, -1.0, ious[i]) \
                        if gt_boxes.shape[0] else ious[i]
                    j = int(np.argmax(row)) if gt_boxes.shape[0] else -1
                    if j >= 0 and row[j] >= iou_t:
                        used[j] = True
                        records.append((p_scores[i], 1))
                    else:
                        records.append((p_scores[i], 0))
            if n_gt == 0:
                continue
            if not records:
                aps.append(0.0)
                continue
            records.sort(key=lambda r: -r[0])
            tps = np.asarray([r[1] for r in records], np.float64)
            cum_tp = np.cumsum(tps)
            cum_fp = np.cumsum(1 - tps)
            recalls = cum_tp / n_gt
            precisions = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
            aps.append(average_precision(recalls, precisions))
        # no class had any ground truth (or no predictions at all): report
        # 0.0 rather than NaN so downstream quality gates can threshold it
        ap_per_thresh.append(float(np.mean(aps)) if aps else 0.0)
    out = {f"mAP@{t}": v for t, v in zip(iou_thresholds, ap_per_thresh)}
    out["mAP"] = float(np.mean(ap_per_thresh)) if ap_per_thresh else 0.0
    return out
