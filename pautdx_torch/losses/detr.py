"""DETR-family criterion of D-FINE: Hungarian matcher + VFL/L1/GIoU + FGL
and DDF losses.

Counterpart of ``pautdx/losses/detr.py``, term for term, with every
``stop_gradient`` of the reference as a ``.detach()`` at the same place and
``scatter_reduce(..., "amax")`` for its ``.at[].max``. One difference of
placement: the reference solves each head's assignment on the device as it
goes; here :func:`dfine_criterion` builds the costs of all heads first (the
decoder layers, the pre-head and the encoder head), copies them to the host
in ONE transfer, solves them together with ``ops.lapjv`` and then finishes
the losses. The costs are the same, and so are the matches.

Ground truths are padded to M boxes; padded columns carry a uniform cost of
0 and are masked out of every term.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pautdx_torch.mesh.comm import dp_count
from pautdx_torch.models.vision.dfine import weighting_function
from pautdx_torch.ops.lapjv import lapjv_batch
from pautdx_torch.utils.profiling import span

SOLVE_SPAN = "hungarian_solve"


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _inter_union(a: torch.Tensor, b: torch.Tensor):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    return inter, area_a + area_b - inter


def iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise plain IoU for aligned (..., 4) xyxy boxes."""
    inter, union = _inter_union(a, b)
    return inter / union.clamp(min=1e-9)


def giou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise generalized IoU for aligned (..., 4) xyxy boxes."""
    inter, union = _inter_union(a, b)
    iou = inter / union.clamp(min=1e-9)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = (erb - elt).clamp(min=0.0)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=1e-9)
    return iou - (enclose - union) / enclose


def pairwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Q, 4) x (..., M, 4) xyxy -> (..., Q, M)."""
    return giou_xyxy(a[..., :, None, :], b[..., None, :, :])


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """Assignment of every gt column to a query: cost (..., Q, M) ->
    (..., M) int64 query indices, on ``cost``'s device. One copy to the
    host and one back, whatever the leading dims."""
    c = torch.nan_to_num(cost.detach().float(), nan=1e4, posinf=1e4,
                         neginf=-1e4)
    # the solver wants rows = the small side (gt columns): (..., M, Q)
    c = c.transpose(-1, -2).cpu().numpy()
    # a host span of the solve alone, which device_profile reads
    with span(SOLVE_SPAN):
        match = lapjv_batch(c)
    return torch.from_numpy(match.astype(np.int64)).to(cost.device)


def build_cost(logits: torch.Tensor, boxes: torch.Tensor,
               gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
               gt_mask: torch.Tensor,
               cls_weight: float = 2.0, l1_weight: float = 5.0,
               giou_weight: float = 2.0, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """Per-image focal-style matching cost (B, Q, M), padded columns 0."""
    prob = torch.sigmoid(logits)                               # (B, Q, C)
    Q = prob.shape[1]
    cls = gt_classes.long().clamp(min=0)[:, None, :].expand(-1, Q, -1)
    p = torch.take_along_dim(prob, cls, dim=-1)                # (B, Q, M)
    pos_cost = alpha * ((1 - p) ** gamma) * (-torch.log(p + 1e-8))
    neg_cost = (1 - alpha) * (p ** gamma) * (-torch.log(1 - p + 1e-8))
    cost_cls = pos_cost - neg_cost
    cost_l1 = (boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    cost_giou = -pairwise_giou(box_cxcywh_to_xyxy(boxes),
                               box_cxcywh_to_xyxy(gt_boxes))
    cost = (cls_weight * cost_cls + l1_weight * cost_l1
            + giou_weight * cost_giou)
    return torch.where(gt_mask[:, None, :] > 0, cost,
                       torch.zeros_like(cost))


def _fgl_loss(pred_corners: torch.Tensor, target_dist: torch.Tensor,
              project: torch.Tensor, weight: torch.Tensor,
              max_num_bins: int) -> torch.Tensor:
    """Fine-grained localization loss: two-bin interpolated CE on the
    non-uniform bin grid. pred_corners (N, 4*(bins+1)); target_dist (N, 4)
    in W(n) units; weight (N,) IoU-based."""
    n_bins = max_num_bins + 1
    logits = pred_corners.reshape(-1, 4, n_bins)
    t = target_dist.reshape(-1, 4)
    idx = (torch.searchsorted(project, t.contiguous(), right=True) - 1
           ).clamp(0, n_bins - 2)
    left = project[idx]
    right = project[idx + 1]
    wr = ((t - left) / (right - left).clamp(min=1e-8)).clamp(0.0, 1.0)
    wl = 1.0 - wr
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, idx[..., None], dim=-1)[..., 0]
    lr = torch.take_along_dim(logits, (idx + 1)[..., None], dim=-1)[..., 0]
    ce = wl * (logz - ll) + wr * (logz - lr)
    return (ce.mean(-1) * weight).sum()


def _ddf_loss(student_corners: torch.Tensor, teacher_corners: torch.Tensor,
              weight: torch.Tensor, pos_mask: torch.Tensor,
              max_num_bins: int, temperature: float = 5.0) -> torch.Tensor:
    """Decoupled distillation focal (GO-LSD self-distillation):
    temperature-KL of every query's corner bins to the teacher's, weighted,
    matched and unmatched means combined with sqrt-count weights."""
    n_bins = max_num_bins + 1
    B, Q = pos_mask.shape
    s = student_corners.reshape(B, Q, 4, n_bins) / temperature
    t = teacher_corners.detach().reshape(B, Q, 4, n_bins) / temperature
    q = torch.softmax(t, dim=-1)
    kl = (q * (F.log_softmax(t, -1) - F.log_softmax(s, -1))).sum(-1)
    kl = (temperature ** 2) * kl.mean(-1) * weight.detach()
    pos = pos_mask.sum()
    counts = torch.stack([pos, B * Q - pos])
    floor = dp_count(counts, floor=1.0)
    mean_pos = (kl * pos_mask).sum() / floor[0]
    mean_neg = (kl * (1.0 - pos_mask)).sum() / floor[1]
    wp, wn = dp_count(counts).sqrt()
    return (mean_pos * wp + mean_neg * wn) / (wp + wn).clamp(min=1e-8)


def _scatter_max(target: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``target.at[index].max(src)`` for a flat int64 ``index``."""
    return target.reshape(-1).scatter_reduce(
        0, index.reshape(-1), src.reshape(-1), "amax",
        include_self=True).reshape(target.shape)


def dfine_criterion(outputs: Dict, gt_boxes: torch.Tensor,
                    gt_classes: torch.Tensor, gt_mask: torch.Tensor,
                    num_labels: int, max_num_bins: int = 32,
                    reg_scale: float = 4.0, up: float = 0.5,
                    cls_weight: float = 1.0, l1_weight: float = 5.0,
                    giou_weight: float = 2.0, fgl_weight: float = 0.15,
                    ddf_weight: float = 1.5, legacy_vfl: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full D-FINE training loss over final + auxiliary heads.

    outputs: ``DFine.forward(images, train=True)``'s dict; gt_boxes
    (B, M, 4) cxcywh normalized, gt_classes (B, M), gt_mask (B, M).
    ``legacy_vfl`` is the reference's diagnostic pre-fix objective (VFL
    target clipped GIoU, not detached)."""
    dev = gt_boxes.device
    gt_mask = gt_mask.to(torch.float32)
    project = weighting_function(max_num_bins, up, reg_scale).to(dev)
    num_boxes = dp_count(gt_mask.sum(), floor=1.0)
    B, M = gt_mask.shape
    b_idx = torch.arange(B, device=dev)[:, None]
    cls_idx = gt_classes.long().clamp(min=0)
    xy_g = box_cxcywh_to_xyxy(gt_boxes)

    # every head, in the reference's order: decoder heads (the pre-head
    # first, the final layer last), then the encoder head
    logits_l: List[torch.Tensor] = list(outputs["intermediate_logits"])
    boxes_l: List[torch.Tensor] = list(outputs["intermediate_boxes"])
    all_corners = outputs["intermediate_corners"]
    n_heads = len(logits_l)
    n_extra = n_heads - len(all_corners)
    corners_l: List[Optional[torch.Tensor]] = [
        all_corners[i - n_extra] if i >= n_extra else None
        for i in range(n_heads)]
    refs_l: List[Optional[torch.Tensor]] = [
        outputs["initial_references"][i - n_extra] if i >= n_extra else None
        for i in range(n_heads)]
    if "enc_topk_logits" in outputs:
        logits_l.append(outputs["enc_topk_logits"])
        boxes_l.append(outputs["enc_topk_bboxes"])
        corners_l.append(None)
        refs_l.append(None)

    costs = [build_cost(lg, bx, gt_boxes, gt_classes, gt_mask)
             for lg, bx in zip(logits_l, boxes_l)]
    matches = hungarian_match(torch.stack(costs))           # (H, B, M)

    def one_head(logits, boxes, match, corners, refs):
        Q, C = logits.shape[1:]
        m_boxes = boxes[b_idx, match]                       # (B, M, 4)
        xy_p = box_cxcywh_to_xyxy(m_boxes)
        giou = giou_xyxy(xy_p, xy_g)
        if legacy_vfl:
            iou = giou.clamp(min=0.0)
        else:
            iou = iou_xyxy(xy_p, xy_g).detach()

        # varifocal classification: target q = IoU at matched slots
        q_val = torch.where(gt_mask > 0, iou * gt_mask,
                            torch.zeros_like(iou))
        t_cls = _scatter_max(logits.new_zeros((B, Q, C)),
                             (b_idx * Q + match) * C + cls_idx, q_val)
        prob = torch.sigmoid(logits)
        if not legacy_vfl:
            prob = prob.detach()
        weight = 0.75 * prob ** 2.0 * (t_cls <= 0) + t_cls
        logz = torch.log1p(torch.exp(-logits.abs())) + (-logits).clamp(min=0)
        bce = t_cls * logz + (1 - t_cls) * (logz + logits)
        loss_cls = (bce * weight).sum() / num_boxes

        l1 = (m_boxes - gt_boxes).abs().sum(-1)
        loss_l1 = (l1 * gt_mask).sum() / num_boxes
        loss_giou = ((1.0 - giou) * gt_mask).sum() / num_boxes
        head_total = (cls_weight * loss_cls + l1_weight * loss_l1
                      + giou_weight * loss_giou)

        if corners is not None:
            # FGL: distances from initial reference centers to gt corners
            # in weighting-function units
            ref = refs[b_idx, match]                         # (B, M, 4)
            rs = abs(reg_scale)
            rw = ref[..., 2].clamp(min=1e-6)
            rh = ref[..., 3].clamp(min=1e-6)
            d_l = (ref[..., 0] - xy_g[..., 0]) * rs / rw - 0.5 * rs
            d_t = (ref[..., 1] - xy_g[..., 1]) * rs / rh - 0.5 * rs
            d_r = (xy_g[..., 2] - ref[..., 0]) * rs / rw - 0.5 * rs
            d_b = (xy_g[..., 3] - ref[..., 1]) * rs / rh - 0.5 * rs
            tdist = torch.stack([d_l, d_t, d_r, d_b], -1)
            m_corners = corners[b_idx, match]
            w = (iou * gt_mask).reshape(-1)
            fgl = _fgl_loss(m_corners.reshape(-1, corners.shape[-1]),
                            tdist.reshape(-1, 4), project, w, max_num_bins)
            head_total = head_total + fgl_weight * fgl / num_boxes
        return head_total, loss_cls, loss_l1, loss_giou, iou

    aux: Dict[str, torch.Tensor] = {}
    total = 0.0
    # DDF teacher: the FINAL layer's corner distributions / confidences
    teacher_corners = all_corners[-1] if len(all_corners) else None
    teacher_conf = torch.sigmoid(logits_l[n_heads - 1]).max(-1).values.detach()
    loss_ddf = None
    for i in range(len(logits_l)):
        match = matches[i]
        ht, lc, ll, lg, iou = one_head(logits_l[i], boxes_l[i], match,
                                       corners_l[i], refs_l[i])
        total = total + ht
        if i == n_heads - 1:
            aux.update({"cls": lc, "l1": ll, "giou": lg})
        # DDF: distil every EARLIER decoder layer's corner bins toward the
        # final layer's (the final layer is the teacher)
        if corners_l[i] is not None and i < n_heads - 1:
            Q = teacher_conf.shape[1]
            flat_idx = b_idx * Q + match
            pos_mask = _scatter_max(torch.zeros_like(teacher_conf),
                                    flat_idx, gt_mask)
            w_at = teacher_conf[b_idx, match]
            w = teacher_conf.clone()
            w[b_idx, match] = torch.where(gt_mask > 0, iou.detach(), w_at)
            ddf = _ddf_loss(corners_l[i], teacher_corners, w, pos_mask,
                            max_num_bins)
            loss_ddf = ddf if loss_ddf is None else loss_ddf + ddf
    if loss_ddf is not None:
        total = total + ddf_weight * loss_ddf
        aux["ddf"] = loss_ddf
    aux["total"] = total
    return total, aux

