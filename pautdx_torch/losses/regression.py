"""Masked regression losses of the defect positions and the 1-d IoU.

Counterpart of ``pautdx/losses/regression.py``. A position mask (B, L)
rides on a trailing axis (``mask[..., None]``) over the (start, end)
pair; healthy signals carry the (0, 0) fallback and are masked out by the
defect labels.
"""

from __future__ import annotations

from typing import Optional

import torch

from pautdx_torch.mesh.comm import dp_count


def interval_iou_1d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., 2) [start, end] intervals."""
    lo = torch.maximum(a[..., 0], b[..., 0])
    hi = torch.minimum(a[..., 1], b[..., 1])
    inter = (hi - lo).clamp(min=0.0)
    union = (a[..., 1] - a[..., 0]) + (b[..., 1] - b[..., 0]) - inter
    return inter / union.clamp(min=1e-8)


def _apply_mask(loss: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    if mask is None:
        return loss.mean()
    mask = torch.broadcast_to(mask, loss.shape).to(loss.dtype)
    return (loss * mask).sum() / dp_count(mask.sum(), floor=1.0)


def _trailing(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else mask[..., None]


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean |pred - target| over the masked (start, end) pairs."""
    return _apply_mask((pred - target).abs(), _trailing(mask))


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     beta: float = 1.0) -> torch.Tensor:
    d = (pred - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _apply_mask(loss, _trailing(mask))


def masked_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean (1 - IoU1D) over the masked intervals."""
    return _apply_mask(1.0 - interval_iou_1d(pred, target), mask)


def focal_l1(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor], gamma: float = 1.0,
             beta: float = 0.1) -> torch.Tensor:
    """L1 with errors above ``beta`` weighted by (err / beta)^gamma."""
    d = (pred - target).abs()
    w = torch.where(d > beta, (d / beta) ** gamma, torch.ones_like(d))
    return _apply_mask(w * d, _trailing(mask))


def temporal_consistency(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Mean squared difference of neighbouring steps along ``axis``."""
    return torch.diff(x, dim=axis).square().mean()


def uncertainty_regularizer(unc: torch.Tensor) -> torch.Tensor:
    """mean(exp(-u) + u)."""
    return (torch.exp(-unc) + unc).mean()
