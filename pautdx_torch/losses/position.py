"""The composite position loss and the signal families' objectives.

Counterpart of ``pautdx/losses/position.py``: ``enhanced_position_loss``
(focal L1 + 2 IoU + 0.5 length + consistency) and the family objectives
``detection_loss`` (BCE), ``detection_position_loss`` (BCE + 0.5 masked
SmoothL1), ``two_stage_loss`` (BCE + L1 + 0.05 uncertainty) and
``seq_detector_loss`` (CE + masked L1 + 0.1 anomaly consistency), each
returning ``(loss, components)``. A (B,) sample mask applies as
``sample_mask[:, None]`` over the (B, L) signals.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pautdx_torch.losses.classification import bce, cross_entropy
from pautdx_torch.losses.regression import (
    focal_l1, interval_iou_1d, masked_iou_loss, masked_l1, masked_smooth_l1,
    temporal_consistency, uncertainty_regularizer,
)
from pautdx_torch.mesh.comm import dp_count

Aux = Dict[str, torch.Tensor]


def _sample_mask(sample_mask: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
    return None if sample_mask is None else sample_mask[:, None]


def enhanced_position_loss(pred: torch.Tensor, target: torch.Tensor,
                           mask: torch.Tensor,
                           w_l1: float = 1.0, w_iou: float = 2.0,
                           w_len: float = 0.5, w_cons: float = 1.0
                           ) -> Tuple[torch.Tensor, Aux]:
    l1 = focal_l1(pred, target, mask)
    iou = masked_iou_loss(pred, target, mask)
    pred_len = pred[..., 1] - pred[..., 0]
    tgt_len = target[..., 1] - target[..., 0]
    m = torch.broadcast_to(mask, pred_len.shape).to(pred.dtype)
    denom = dp_count(m.sum(), floor=1.0)
    length = ((pred_len - tgt_len).abs() * m).sum() / denom
    # start below end by a margin
    cons = ((pred[..., 0] - pred[..., 1] + 0.01).clamp(min=0.0)
            * m).sum() / denom
    total = w_l1 * l1 + w_iou * iou + w_len * length + w_cons * cons
    return total, {"l1": l1, "iou": iou, "length": length,
                   "consistency": cons}


def detection_loss(probs: torch.Tensor, labels: torch.Tensor,
                   sample_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Aux]:
    loss = bce(probs, labels, _sample_mask(sample_mask))
    return loss, {"bce": loss}


def detection_position_loss(out: Dict[str, torch.Tensor],
                            labels: torch.Tensor, positions: torch.Tensor,
                            sample_mask: Optional[torch.Tensor] = None,
                            pos_weight: float = 0.5
                            ) -> Tuple[torch.Tensor, Aux]:
    m = _sample_mask(sample_mask)
    cls = bce(out["prob"], labels, m)
    defect_mask = labels if m is None else labels * m
    pos = masked_smooth_l1(out["positions"], positions, defect_mask)
    return cls + pos_weight * pos, {"bce": cls, "position": pos}


def two_stage_loss(out: Dict[str, torch.Tensor], labels: torch.Tensor,
                   positions: torch.Tensor,
                   sample_mask: Optional[torch.Tensor] = None,
                   unc_weight: float = 0.05) -> Tuple[torch.Tensor, Aux]:
    m = _sample_mask(sample_mask)
    cls = bce(out["prob"], labels, m)
    defect_mask = labels if m is None else labels * m
    pos = masked_l1(out["positions"], positions, defect_mask)
    unc = (uncertainty_regularizer(out["cls_uncertainty"])
           + uncertainty_regularizer(out["pos_uncertainty"]))
    total = cls + pos + unc_weight * unc
    return total, {"bce": cls, "position": pos, "uncertainty": unc}


def seq_detector_loss(out: Dict[str, torch.Tensor],
                      class_labels: torch.Tensor, positions: torch.Tensor,
                      sample_mask: Optional[torch.Tensor] = None,
                      anomaly_weight: float = 0.1
                      ) -> Tuple[torch.Tensor, Aux]:
    """``class_labels``: integer (B, L), 0 = Health."""
    m = _sample_mask(sample_mask)
    class_labels = class_labels.long()
    ce = cross_entropy(out["class_logits"], class_labels, mask=m)
    defect = (class_labels > 0).to(out["positions"].dtype)
    if m is not None:
        defect = defect * m
    pos = masked_l1(out["positions"], positions, defect)
    cons = temporal_consistency(out["anomaly"], axis=1)
    total = ce + pos + anomaly_weight * cons
    return total, {"ce": ce, "position": pos, "anomaly_consistency": cons}


def position_accuracy_iou(pred: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor, threshold: float = 0.5
                          ) -> torch.Tensor:
    """Fraction of the masked intervals with IoU >= ``threshold``."""
    iou = interval_iou_1d(pred, target)
    m = torch.broadcast_to(mask, iou.shape).to(iou.dtype)
    hits = ((iou >= threshold).to(iou.dtype) * m).sum()
    return hits / dp_count(m.sum(), floor=1.0)
