"""Frozen plain-PyTorch copy of the port's ``ops/nms.py`` for the
benchmark's reference: every kernel call replaced by its plain math
(``common.py``), nothing of the program imported.

Fixed-shape NMS, batched: fixed-size top-k plus a masked greedy sweep.

Counterpart of ``pautdx/ops/nms.py``. The JAX package ``vmap``s a
single-image ``nms``; here the batch is a leading axis throughout and the
sweep is one launch of ``pautdx_torch.ops.suppress.nms_suppress`` for the
whole batch. Output shapes are fixed: ``max_det`` slots per image, with
``valid`` marking real detections. Nothing here reads a value back to the
host.

Top-k is a stable descending sort, sliced: among equal scores (every score
below the threshold is 0, and saturated sigmoids give 1.0) the lower anchor
index comes first, as ``lax.top_k`` orders them. The order decides which
boxes enter the K candidates and so the class stride below.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import common as suppress


def box_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU."""
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def _top_k(x: torch.Tensor, k: int):
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, iou_threshold: float = 0.45,
                score_threshold: float = 0.25, top_k: int = 300,
                max_det: int = 100) -> Dict[str, torch.Tensor]:
    """boxes (B, A, 4) xyxy; scores (B, A); classes (B, A) int; class-aware
    (a box suppresses only boxes of its own class). Returns
    {"boxes" (B, max_det, 4), "scores", "classes" (-1 where not valid),
    "valid", "indices" (anchor of each slot)}."""
    k = min(top_k, scores.shape[-1])
    if max_det > k:
        raise ValueError(f"max_det={max_det} exceeds the {k} candidates "
                         f"(min(top_k, anchors))")
    scores = torch.where(scores >= score_threshold, scores,
                         torch.zeros_like(scores))
    top_scores, order = _top_k(scores, k)
    top_boxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    top_classes = torch.take_along_dim(classes, order, dim=-1)

    # separate classes by translating boxes apart per class, by
    # (max |coord| + 1) per class id: a fixed large stride would lose
    # sub-pixel precision in f32 and flip near-threshold IoUs
    stride = top_boxes.abs().amax(dim=(-2, -1), keepdim=True) + 1.0
    iou = box_iou_matrix(top_boxes + top_classes.to(torch.float32)[..., None]
                         * stride)
    keep = suppress.nms_suppress(iou, top_scores > 0.0, iou_threshold)

    kept_scores = torch.where(keep > 0.0, top_scores,
                              torch.zeros_like(top_scores))
    final_scores, idx = _top_k(kept_scores, max_det)
    valid = final_scores > 0.0
    return {
        "boxes": torch.take_along_dim(top_boxes, idx[..., None], dim=-2)
        * valid[..., None],
        "scores": final_scores,
        "classes": torch.where(valid,
                               torch.take_along_dim(top_classes, idx, -1),
                               torch.full_like(idx, -1)),
        "valid": valid,
        "indices": torch.take_along_dim(order, idx, dim=-1),
        # the sweep's keep over the score-sorted candidates (the NMS
        # kernel's bound reads it)
        "keep": keep,
    }


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
        **kw) -> Dict[str, torch.Tensor]:
    """Single-image NMS: boxes (A, 4), scores (A,), classes (A,) -> the
    fields of :func:`batched_nms` without the batch axis."""
    out = batched_nms(boxes[None], scores[None], classes[None], **kw)
    return {k: v[0] for k, v in out.items()}


def dense_to_detections(decoded: Dict[str, torch.Tensor],
                        **nms_kw) -> Dict[str, torch.Tensor]:
    """YOLO dense decode {"boxes" (B, A, 4), "scores" (B, A, nc)} ->
    batched final detections; best class per anchor (the first on ties)."""
    best_score, best_cls = decoded["scores"].max(dim=-1)
    return batched_nms(decoded["boxes"], best_score, best_cls, **nms_kw)
