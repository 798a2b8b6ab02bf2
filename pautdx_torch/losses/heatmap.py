"""CenterNet-style 1-d heatmap targets and the DetLoc criterion.

Counterpart of ``pautdx/losses/heatmap.py``: Gaussian heatmaps at the
defect centres on each pyramid scale, and a loss of focal BCE on the
heatmaps, masked SmoothL1 on (tanh offset, log width) at the centre cells
and (1 - IoU1D) of the decoded intervals there, summed over the scales.
The targets are built on the device from the (B, N, 2) positions and the
(B, N) labels, as the reference builds them inside its jitted step.

``torch.round`` rounds half to even, as ``jnp.round`` does; which cell a
centre falls in decides ``pos_mask``, so it must.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from pautdx_torch.losses.classification import focal_bce_with_logits
from pautdx_torch.losses.regression import interval_iou_1d
from pautdx_torch.mesh.comm import dp_count
from pautdx_torch.models.signal.detloc1d import STRIDES


def gaussian_heatmap_1d(centers: torch.Tensor, widths: torch.Tensor,
                        valid: torch.Tensor, n_cells: int, stride: int,
                        signal_length: int) -> torch.Tensor:
    """(B, N) centres and widths in samples -> (B, N, n_cells) heatmap."""
    cell_centers = (torch.arange(n_cells, dtype=centers.dtype,
                                 device=centers.device) + 0.5) * stride
    sigma = (widths / 6.0).clamp(min=stride / 2.0)
    d = cell_centers - centers[..., None]
    hm = torch.exp(-0.5 * (d / sigma[..., None]).square())
    return hm * valid[..., None]


def detloc_targets(labels: torch.Tensor, positions: torch.Tensor,
                   signal_length: int, n_cells: Tuple[int, ...],
                   strides: Tuple[int, ...] = STRIDES
                   ) -> List[Dict[str, torch.Tensor]]:
    """Per scale: heatmap, centre offset, log width and positive mask."""
    start = positions[..., 0] * signal_length
    end = positions[..., 1] * signal_length
    centers = 0.5 * (start + end)
    widths = (end - start).clamp(min=1.0)
    valid = labels.to(positions.dtype)
    out = []
    for nc, s in zip(n_cells, strides):
        hm = gaussian_heatmap_1d(centers, widths, valid, nc, s,
                                 signal_length)
        cell_idx = torch.round(centers / s - 0.5).clamp(0, nc - 1)
        cells = torch.arange(nc, dtype=positions.dtype,
                             device=positions.device)
        is_center = cells == cell_idx[..., None]
        pos_mask = is_center.to(positions.dtype) * valid[..., None]
        offset = (centers / s - 0.5)[..., None] - cells
        log_w = torch.log(widths / s)[..., None] * torch.ones_like(offset)
        out.append({"heatmap": hm, "offset": offset, "log_width": log_w,
                    "pos_mask": pos_mask})
    return out


def _smooth(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def detloc_criterion(outs: List[Dict[str, torch.Tensor]],
                     labels: torch.Tensor, positions: torch.Tensor,
                     signal_length: int,
                     strides: Tuple[int, ...] = STRIDES,
                     w_reg: float = 1.0, w_iou: float = 1.0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    n_cells = tuple(o["cls"].shape[-1] for o in outs)
    targets = detloc_targets(labels, positions, signal_length, n_cells,
                             strides)
    total_cls = total_reg = total_iou = 0.0
    for out, tgt, stride in zip(outs, targets, strides):
        total_cls = total_cls + focal_bce_with_logits(out["cls"],
                                                      tgt["heatmap"])
        pm = tgt["pos_mask"]
        denom = dp_count(pm.sum(), floor=1.0)
        # tanh on the offset, as decode_1d decodes it
        pred_off = torch.tanh(out["reg"][..., 0])
        pred_lw = out["reg"][..., 1]
        d_off = (pred_off - tgt["offset"]).abs()
        d_lw = (pred_lw - tgt["log_width"]).abs()
        total_reg = total_reg + ((_smooth(d_off) + _smooth(d_lw))
                                 * pm).sum() / denom
        # IoU of the decoded intervals at the positive cells
        cells = torch.arange(out["cls"].shape[-1], dtype=pred_off.dtype,
                             device=pred_off.device)
        center = (cells + 0.5 + pred_off) * stride
        width = torch.exp(pred_lw.clamp(-4.0, 4.0)) * stride
        pred_iv = torch.stack([center - width / 2, center + width / 2], -1)
        tgt_iv = torch.stack(
            [torch.broadcast_to(positions[..., 0:1] * signal_length,
                                center.shape),
             torch.broadcast_to(positions[..., 1:2] * signal_length,
                                center.shape)], -1)
        iou = interval_iou_1d(pred_iv, tgt_iv)
        total_iou = total_iou + ((1.0 - iou) * pm).sum() / denom
    total = total_cls + w_reg * total_reg + w_iou * total_iou
    return total, {"heatmap": total_cls, "reg": total_reg, "iou": total_iou}
