"""YOLO training criterion: task-aligned assigner + CIoU + DFL + BCE, and the
seg variant's prototype-mask BCE.

Counterpart of ``pautdx/losses/yolo.py``. Ground truths are padded to M
boxes an image and the assigner is dense (A anchors x M gts), batched over
the images where the reference maps one image at a time. Two orderings
follow the reference's: the per-gt top-k takes tied metrics lowest anchor
first (``jax.lax.top_k``; here a stable descending sort, sliced), and an
anchor claimed by several gts goes to the first of the highest IoU
(``argmax``). Everything is plain PyTorch: the reference computes the
criterion, its mask product included, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from pautdx_torch.mesh.comm import dp_count
from pautdx_torch.models.vision.yolo import YoloConfig, decode_boxes


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., A, 4) x (..., M, 4) -> (..., A, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp(min=1e-9)


def ciou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise complete IoU between aligned (..., 4) boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    wa = (a[..., 2] - a[..., 0]).clamp(min=1e-9)
    ha = (a[..., 3] - a[..., 1]).clamp(min=1e-9)
    wb = (b[..., 2] - b[..., 0]).clamp(min=1e-9)
    hb = (b[..., 3] - b[..., 1]).clamp(min=1e-9)
    union = wa * ha + wb * hb - inter
    iou = inter / union.clamp(min=1e-9)
    # enclosing box diagonal
    ewh = torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2],
                                                                b[..., :2])
    c2 = ewh.square().sum(-1) + 1e-9
    ca = 0.5 * (a[..., :2] + a[..., 2:])
    cb = 0.5 * (b[..., :2] + b[..., 2:])
    rho2 = (ca - cb).square().sum(-1)
    v = (4 / math.pi ** 2) * (torch.atan(wb / hb)
                              - torch.atan(wa / ha)).square()
    alpha = v / (1.0 - iou + v).clamp(min=1e-9)
    return iou - rho2 / c2 - alpha * v


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, ties lowest
    index first."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def task_aligned_assign(cls_probs: torch.Tensor, pred_boxes: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                        gt_mask: torch.Tensor, anchor_pts: torch.Tensor,
                        topk: int = 10, alpha: float = 0.5, beta: float = 6.0
                        ) -> Dict[str, torch.Tensor]:
    """Batched TAL: cls_probs (B, A, nc), pred_boxes (B, A, 4), gt_boxes
    (B, M, 4), gt_classes (B, M), gt_mask (B, M), anchor_pts (A, 2) ->
    {"target_scores" (B, A, nc), "target_boxes" (B, A, 4), "fg" (B, A),
    "target_gt_idx" (B, A)}."""
    B, A, nc = cls_probs.shape
    M = gt_boxes.shape[1]
    iou = pairwise_iou_xyxy(pred_boxes, gt_boxes)               # (B, A, M)
    cls_at_gt = torch.gather(
        cls_probs, 2, gt_classes.long().clamp(min=0)[:, None, :].expand(
            B, A, M))
    metric = cls_at_gt.pow(alpha) * iou.pow(beta)
    px, py = anchor_pts[None, :, None, 0], anchor_pts[None, :, None, 1]
    inside = ((px >= gt_boxes[:, None, :, 0]) & (px < gt_boxes[:, None, :, 2])
              & (py >= gt_boxes[:, None, :, 1])
              & (py < gt_boxes[:, None, :, 3]))
    valid = inside & (gt_mask[:, None, :] > 0)
    metric = torch.where(valid, metric, torch.zeros_like(metric))

    # top-k anchors per gt
    topk_metric, topk_idx = _top_k(metric.transpose(1, 2), min(topk, A))
    cand = torch.zeros((B, M, A), dtype=torch.bool, device=metric.device)
    cand.scatter_(2, topk_idx, topk_metric > 0)
    cand = cand.transpose(1, 2) & valid                         # (B, A, M)

    # conflicts: anchor claimed by several gts -> highest IoU wins
    iou_masked = torch.where(cand, iou, torch.full_like(iou, -1.0))
    best_gt = iou_masked.argmax(-1)                             # (B, A)
    fg = iou_masked.amax(-1) > 0.0

    tgt_boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, A, 4))
    tgt_cls = torch.gather(gt_classes.long(), 1, best_gt).clamp(min=0)
    # normalized target score (align metric scaled by per-gt max IoU)
    pos_metric = torch.where(cand, metric, torch.zeros_like(metric))
    per_gt_max_metric = pos_metric.amax(1)                      # (B, M)
    per_gt_max_iou = torch.where(cand, iou, torch.zeros_like(iou)).amax(1)
    norm = per_gt_max_iou / per_gt_max_metric.clamp(min=1e-9)
    anchor_metric = torch.gather(pos_metric, 2, best_gt[..., None])[..., 0]
    score = anchor_metric * torch.gather(norm, 1, best_gt)
    target_scores = torch.zeros((B, A, nc), dtype=cls_probs.dtype,
                                device=cls_probs.device)
    target_scores.scatter_(2, tgt_cls[..., None],
                           torch.where(fg, score, torch.zeros_like(score))
                           [..., None])
    return {"target_scores": target_scores, "target_boxes": tgt_boxes,
            "fg": fg.to(cls_probs.dtype), "target_gt_idx": best_gt}


def _dfl_loss(box_logits: torch.Tensor, target_ltrb: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Distribution focal loss: CE to the two integer bins around the
    target. box_logits (..., 4*reg_max); target_ltrb (..., 4) in stride
    units. Returns the (...,) per-anchor loss, the mean over the 4 sides."""
    t = target_ltrb.clamp(0.0, reg_max - 1.001)
    tl = torch.floor(t)
    wr = t - tl
    wl = 1.0 - wr
    logits = box_logits.reshape(box_logits.shape[:-1] + (4, reg_max))
    logz = torch.logsumexp(logits, dim=-1)
    il = tl.long()
    ll = torch.gather(logits, -1, il[..., None])[..., 0]
    lr = torch.gather(logits, -1, (il + 1).clamp(max=reg_max - 1)[..., None]
                      )[..., 0]
    ce = wl * (logz - ll) + wr * (logz - lr)
    return ce.mean(-1)


def _log1p_exp_neg(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(-x)) in the reference's stable form."""
    return torch.log1p(torch.exp(-x.abs())) + (-x).clamp(min=0)


def yolo_loss(result: Dict, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
              gt_mask: torch.Tensor, cfg: YoloConfig,
              img_size: Tuple[int, int] = (320, 320),
              gt_masks: Optional[torch.Tensor] = None,
              box_w: float = 7.5, cls_w: float = 0.5, dfl_w: float = 1.5,
              seg_w: float = 1.0) -> Tuple[torch.Tensor, Dict]:
    """Batched YOLO training loss over the model's raw outputs: (total,
    {"box", "cls", "dfl"[, "seg"]}).

    gt_boxes (B, M, 4) xyxy px (padded); gt_classes (B, M); gt_mask (B, M);
    gt_masks (B, M, Hp, Wp) binary at proto resolution when cfg.seg."""
    decoded = decode_boxes(result, img_size, cfg)
    pts, strs = decoded["anchor_points"], decoded["anchor_strides"]
    levels = result["levels"]
    B = levels[0]["cls"].shape[0]
    cls_logits = torch.cat([lvl["cls"].reshape(B, -1, cfg.num_classes)
                            for lvl in levels], dim=1)
    box_logits = torch.cat([lvl["box"].reshape(B, -1, 4 * cfg.reg_max)
                            for lvl in levels], dim=1)

    # the assignment sees DETACHED predictions (Ultralytics:
    # pd_scores.detach().sigmoid(), pd_bboxes.detach()): targets,
    # per-anchor weights and score_sum are constants of the parameters
    assign = task_aligned_assign(decoded["scores"].detach(),
                                 decoded["boxes"].detach(), gt_boxes,
                                 gt_classes, gt_mask, pts)
    tgt_scores = assign["target_scores"]
    fg = assign["fg"]
    score_sum = dp_count(tgt_scores.sum(), floor=1.0)

    # cls BCE with soft targets over all anchors
    logz = _log1p_exp_neg(cls_logits)
    bce = tgt_scores * logz + (1 - tgt_scores) * (logz + cls_logits)
    loss_cls = bce.sum() / score_sum

    # box CIoU on the foreground, weighted by the target score
    w = tgt_scores.sum(-1)                                      # (B, A)
    tb = assign["target_boxes"]
    ciou = ciou_xyxy(decoded["boxes"], tb)
    loss_box = ((1.0 - ciou) * w * fg).sum() / score_sum

    # DFL to the target ltrb in stride units
    ltrb = torch.cat([pts[None, :, 0:1] - tb[..., 0:1],
                      pts[None, :, 1:2] - tb[..., 1:2],
                      tb[..., 2:3] - pts[None, :, 0:1],
                      tb[..., 3:4] - pts[None, :, 1:2]],
                     dim=-1) / strs[None, :, None]
    dfl = _dfl_loss(box_logits, ltrb, cfg.reg_max)
    loss_dfl = (dfl * w * fg).sum() / score_sum

    total = box_w * loss_box + cls_w * loss_cls + dfl_w * loss_dfl
    aux = {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl}

    if cfg.seg and gt_masks is not None:
        # Ultralytics-style mask loss on the foreground: TAL picks at most
        # topk (10) anchors a gt, so the top 10*M weighted anchors hold
        # every anchor of nonzero weight; BCE cropped to the target box
        # and divided by its area at proto resolution (``ultralytics
        # loss.py single_mask_loss``)
        coeffs = decoded["coeffs"]                              # (B, A, P)
        protos = result["protos"]                               # (B, Hp, Wp, P)
        A = fg.shape[1]
        sel_w, sel_idx = _top_k(w * fg, min(10 * gt_boxes.shape[1], A))
        sel_coeffs = torch.gather(
            coeffs, 1, sel_idx[..., None].expand(-1, -1, coeffs.shape[-1]))
        pred_m = torch.einsum("bhwp,bkp->bkhw", protos, sel_coeffs)
        gt_idx = torch.gather(assign["target_gt_idx"], 1, sel_idx)
        Hp, Wp = protos.shape[1:3]
        tgt_m = torch.gather(
            gt_masks.to(pred_m.dtype), 1,
            gt_idx[..., None, None].expand(-1, -1, Hp, Wp))     # (B, k, Hp, Wp)
        tgt_b = torch.gather(tb, 1, sel_idx[..., None].expand(-1, -1, 4))
        sx, sy = Wp / img_size[1], Hp / img_size[0]
        x0, y0 = tgt_b[..., 0] * sx, tgt_b[..., 1] * sy         # (B, k)
        x1, y1 = tgt_b[..., 2] * sx, tgt_b[..., 3] * sy
        xs = torch.arange(Wp, dtype=torch.float32,
                          device=protos.device)[None, None, None, :]
        ys = torch.arange(Hp, dtype=torch.float32,
                          device=protos.device)[None, None, :, None]
        crop = ((xs >= x0[..., None, None]) & (xs < x1[..., None, None])
                & (ys >= y0[..., None, None]) & (ys < y1[..., None, None]))
        area = ((x1 - x0) * (y1 - y0)).clamp(min=1.0)           # (B, k)
        mlogz = _log1p_exp_neg(pred_m)
        mbce = tgt_m * mlogz + (1 - tgt_m) * (mlogz + pred_m)
        per_anchor = (mbce * crop).sum((-1, -2)) / area
        loss_seg = (per_anchor * sel_w).sum() / score_sum
        total = total + seg_w * loss_seg
        aux["seg"] = loss_seg

    return total, aux
