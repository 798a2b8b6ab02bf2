"""Classification losses (BCE, focal, CE) with an optional element mask.

Counterpart of ``pautdx/losses/classification.py``, term for term:

- ``bce`` on probabilities, clipped to [1e-7, 1 - 1e-7] before the log,
  as the reference's; not ``F.binary_cross_entropy``, which clamps the
  log at -100 instead and differs in value and gradient near 0 and 1;
- ``bce_with_logits`` and ``focal_bce_with_logits`` from logits;
- ``cross_entropy`` over the last axis, normalised by the sum of the
  selected class weights where weights are given.

A mask broadcasts against the elementwise loss as ``jnp.broadcast_to``
does (from the right), and the masked mean divides by at least 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from pautdx_torch.mesh.comm import dp_count

_EPS = 1e-7


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * mask).sum() / dp_count(mask.sum(), floor=1.0)


def bce(probs: torch.Tensor, targets: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE on probabilities (torch ``nn.BCELoss``'s, clipped)."""
    p = probs.clamp(_EPS, 1.0 - _EPS)
    loss = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    return _masked_mean(loss, mask)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Numerically stable BCE from logits."""
    log_p = torch.log1p(torch.exp(-logits.abs())) + (-logits).clamp(min=0.0)
    log_not_p = log_p + logits
    loss = pos_weight * targets * log_p + (1.0 - targets) * log_not_p
    return _masked_mean(loss, mask)


def focal_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                          alpha: float = 0.25, gamma: float = 2.0,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Focal BCE: -a (1 - pt)^gamma log(pt), p clipped at 1e-7."""
    p = torch.where(logits >= 0, 1.0 / (1.0 + torch.exp(-logits)),
                    torch.exp(logits) / (1.0 + torch.exp(logits)))
    p = p.clamp(_EPS, 1.0 - _EPS)
    pos = targets > 0.5
    pt = torch.where(pos, p, 1.0 - p)
    a = torch.where(pos, alpha, 1.0 - alpha)
    loss = -a * (1.0 - pt) ** gamma * torch.log(pt)
    return _masked_mean(loss, mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE over the last axis, integer labels. With ``class_weights`` the
    mean divides by the sum of the selected weights (torch
    ``nn.CrossEntropyLoss(weight=...)``'s mean)."""
    m = logits.amax(-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    labels = labels.long()
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = logz - ll
    if class_weights is not None:
        w = class_weights[labels]
        if mask is not None:
            w = w * mask
        return (loss * w).sum() / dp_count(w.sum(), floor=_EPS)
    return _masked_mean(loss, mask)
