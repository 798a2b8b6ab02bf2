"""Segmentation evaluation: mask IoU + mask mAP@0.5.

Counterpart of ``pautdx/eval/seg.py``, host numpy, the port's own copy. The
capability the reference gets from Ultralytics' seg validator
(`yolo_seg_train.py` path, SURVEY.md §2.1). Masks are binary arrays at a
common resolution (predictions from ``assemble_masks`` are at proto
resolution — upsample or downsample GT to match before calling).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from pautdx_torch.eval.map import average_precision


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, H, W) x (m, H, W) binary -> (n, m) IoU.

    Intersection via matmul: broadcasting (n, m, H*W) booleans costs
    O(n*m*HW) memory (~4 GB at 100x100 640px masks); this is
    O((n+m)*HW + n*m)."""
    a = a.reshape(a.shape[0], -1).astype(np.float32)
    b = b.reshape(b.shape[0], -1).astype(np.float32)
    inter = a @ b.T
    union = a.sum(-1)[:, None] + b.sum(-1)[None, :] - inter
    return inter / np.maximum(union, 1)


def evaluate_mask_map(predictions: List[Dict[str, np.ndarray]],
                      ground_truths: List[Dict[str, np.ndarray]],
                      iou_thresholds: Sequence[float] = (0.5,),
                      num_classes: int = 1,
                      binarize: float = 0.5) -> Dict[str, float]:
    """predictions[i]: {masks (n,H,W) in [0,1], scores (n,), classes (n,)};
    ground_truths[i]: {masks (m,H,W) binary, classes (m,)}."""
    if len(predictions) != len(ground_truths):
        raise ValueError(
            f"predictions ({len(predictions)}) and ground_truths "
            f"({len(ground_truths)}) must be index-aligned")
    out = {}
    aps = []
    for iou_t in iou_thresholds:
        per_class = []
        for c in range(num_classes):
            records = []
            n_gt = 0
            for pred, gt in zip(predictions, ground_truths):
                gk = np.asarray(gt["classes"]).reshape(-1) == c
                g_masks = np.asarray(gt["masks"])[gk]
                n_gt += g_masks.shape[0]
                pk = np.asarray(pred["classes"]).reshape(-1) == c
                p_masks = (np.asarray(pred["masks"])[pk] >= binarize)
                p_scores = np.asarray(pred["scores"]).reshape(-1)[pk]
                order = np.argsort(-p_scores)
                p_masks, p_scores = p_masks[order], p_scores[order]
                used = np.zeros(g_masks.shape[0], bool)
                ious = (mask_iou(p_masks, g_masks)
                        if p_masks.shape[0] and g_masks.shape[0]
                        else np.zeros((p_masks.shape[0], g_masks.shape[0])))
                for i in range(p_masks.shape[0]):
                    # argmax over UNUSED gts (COCO semantics — see
                    # eval/map.py)
                    row = (np.where(used, -1.0, ious[i])
                           if g_masks.shape[0] else ious[i])
                    j = int(np.argmax(row)) if g_masks.shape[0] else -1
                    hit = j >= 0 and row[j] >= iou_t
                    if hit:
                        used[j] = True
                    records.append((p_scores[i], int(hit)))
            if n_gt == 0:
                continue
            if not records:
                per_class.append(0.0)
                continue
            records.sort(key=lambda r: -r[0])
            tps = np.asarray([r[1] for r in records], np.float64)
            cum_tp = np.cumsum(tps)
            cum_fp = np.cumsum(1 - tps)
            rec = cum_tp / n_gt
            prec = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
            per_class.append(average_precision(rec, prec))
        # 0.0 (not NaN) when no class had ground truth — same contract
        # as eval/map.py so quality gates can threshold the result
        aps.append(float(np.mean(per_class)) if per_class else 0.0)
        out[f"mask_mAP@{iou_t}"] = aps[-1]
    out["mask_mAP"] = float(np.mean(aps)) if aps else 0.0
    return out
