"""Contrastive denoising groups for D-FINE training, at static shapes.

Counterpart of ``pautdx/losses/denoising.py``. Noised copies of the ground
truths are fed to the decoder as extra queries: positives must reconstruct
their ground truth, negatives (heavier box noise) must predict background,
and an additive attention mask keeps the groups from each other and the
matching queries from the groups. With the ground truths padded to M, the
layout is static: ``2 * M * groups`` queries, padded slots are negatives
of zero loss weight.

The four random draws come from the caller's ``torch.Generator``
(:func:`make_denoising_queries`); :func:`denoising_queries_from_draws` is
the deterministic rest, so the same draws give the reference's queries.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pautdx_torch.losses.detr import box_cxcywh_to_xyxy, giou_xyxy
from pautdx_torch.mesh.comm import dp_count
from pautdx_torch.models.vision.dfine import inverse_sigmoid

NEG_INF = -1e9      # the additive mask's blocked entry


def denoising_group_size(max_boxes: int, num_denoising: int = 100
                         ) -> Tuple[int, int]:
    """(num_groups, total_dn_queries), static given the GT padding M."""
    groups = max(1, num_denoising // max(max_boxes, 1))
    return groups, 2 * max_boxes * groups


def make_denoising_queries(gen: torch.Generator, gt_boxes: torch.Tensor,
                           gt_classes: torch.Tensor, gt_mask: torch.Tensor,
                           num_labels: int, num_queries: int,
                           num_denoising: int = 100,
                           label_noise: float = 0.5,
                           box_noise: float = 1.0) -> Dict[str, torch.Tensor]:
    """Draw the noise from ``gen`` (on the ground truths' device) and build
    the group: see :func:`denoising_queries_from_draws`. gt_boxes (B, M, 4)
    normalized cxcywh, gt_classes (B, M), gt_mask (B, M)."""
    B, M, _ = gt_boxes.shape
    _, D = denoising_group_size(M, num_denoising)
    dev = gt_boxes.device
    flip_u = torch.rand((B, D), generator=gen, device=dev)
    rand_label = torch.randint(0, num_labels, (B, D), generator=gen,
                               device=dev)
    sign = torch.randint(0, 2, (B, D, 4), generator=gen,
                         device=dev).float() * 2.0 - 1.0
    part = torch.rand((B, D, 4), generator=gen, device=dev)
    return denoising_queries_from_draws(
        flip_u, rand_label, sign, part, gt_boxes, gt_classes, gt_mask,
        num_labels, num_queries, label_noise, box_noise)


def denoising_queries_from_draws(
        flip_u: torch.Tensor, rand_label: torch.Tensor, sign: torch.Tensor,
        part: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
        gt_mask: torch.Tensor, num_labels: int, num_queries: int,
        label_noise: float = 0.5, box_noise: float = 1.0
) -> Dict[str, torch.Tensor]:
    """The denoising group from its draws: ``flip_u`` (B, D) uniform [0, 1)
    (a label is redrawn where it is below ``label_noise / 2``),
    ``rand_label`` (B, D) the redrawn labels, ``sign`` (B, D, 4) of ±1 and
    ``part`` (B, D, 4) uniform [0, 1) for the corner noise.

    Returns {"class_ids" (B, D), "box_logits" (B, D, 4), "attn_mask"
    (D+Q, D+Q) additive (0 attends, -1e9 blocks), "is_positive" (B, D),
    "gt_index" (B, D), "weight" (B, D)}, with D = 2*M*groups laid out as
    [positives (M), negatives (M)] x groups."""
    B, M, _ = gt_boxes.shape
    D = flip_u.shape[1]
    groups = D // (2 * M)
    dev = gt_boxes.device
    tiled_boxes = gt_boxes.repeat(1, 2 * groups, 1)              # (B, D, 4)
    tiled_classes = gt_classes.repeat(1, 2 * groups)
    tiled_mask = gt_mask.repeat(1, 2 * groups)
    real = tiled_mask > 0
    is_negative = (torch.arange(D, device=dev) // M) % 2 == 1    # (D,)
    is_positive = ~is_negative[None, :] & real

    # label noise: a random label with probability label_noise / 2
    flip = flip_u < label_noise * 0.5
    class_ids = torch.where(flip & real, rand_label,
                            tiled_classes.clamp(min=0))
    # padded slots take the embedding's padding id
    class_ids = torch.where(real, class_ids,
                            torch.full_like(class_ids, num_labels))

    # box noise in corner space: positives within 0.5*wh, negatives 1-2x
    corners = box_cxcywh_to_xyxy(tiled_boxes)
    diff = (tiled_boxes[..., 2:] * 0.5).repeat(1, 1, 2) * box_noise
    part = torch.where(is_negative[None, :, None], part + 1.0, part)
    noised = (corners + sign * part * diff).clamp(0.0, 1.0)
    cx = (noised[..., 0] + noised[..., 2]) / 2
    cy = (noised[..., 1] + noised[..., 3]) / 2
    w = noised[..., 2] - noised[..., 0]
    h = noised[..., 3] - noised[..., 1]
    box_logits = inverse_sigmoid(torch.stack([cx, cy, w, h], -1))

    # the matching queries do not see the groups, a group sees only itself
    # (a positive and a negative block); [group -> matching] stays open
    L = D + num_queries
    mask = torch.zeros((L, L), device=dev)
    mask[D:, :D] = NEG_INF
    q_block = torch.arange(D, device=dev) // (2 * M)
    mask[:D, :D] = torch.where(q_block[:, None] == q_block[None, :],
                               0.0, NEG_INF)
    gt_index = (torch.arange(D, device=dev) % M).expand(B, D)
    return {"class_ids": class_ids, "box_logits": box_logits,
            "attn_mask": mask, "is_positive": is_positive,
            "gt_index": gt_index, "weight": tiled_mask}


def denoising_loss(dn_logits: torch.Tensor, dn_boxes: torch.Tensor,
                   dn: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                   gt_classes: torch.Tensor,
                   cls_weight: float = 1.0, l1_weight: float = 5.0,
                   giou_weight: float = 2.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The index-matched loss (no Hungarian) of one head's denoising
    outputs: dn_logits (B, D, C), dn_boxes (B, D, 4) cxcywh. Positives
    reconstruct their source ground truth; negatives train toward
    background; padded slots weigh nothing. ``num_pos`` is summed over the
    whole batch; the focal weight reads a detached sigmoid."""
    B, D, C = dn_logits.shape
    b_idx = torch.arange(B, device=dn_logits.device)[:, None]
    src_boxes = gt_boxes[b_idx, dn["gt_index"]]
    src_classes = gt_classes[b_idx, dn["gt_index"]].long().clamp(min=0)
    pos = dn["is_positive"].float()
    num_pos = dp_count(pos.sum(), floor=1.0)

    t_cls = F.one_hot(src_classes, C).to(dn_logits.dtype) * pos[..., None]
    logz = torch.log1p(torch.exp(-dn_logits.abs())) \
        + (-dn_logits).clamp(min=0)
    bce = t_cls * logz + (1 - t_cls) * (logz + dn_logits)
    prob = torch.sigmoid(dn_logits).detach()
    weight = ((0.75 * prob ** 2.0 * (t_cls <= 0) + t_cls)
              * dn["weight"][..., None])
    loss_cls = (bce * weight).sum() / num_pos

    l1 = (dn_boxes - src_boxes).abs().sum(-1)
    loss_l1 = (l1 * pos).sum() / num_pos
    giou = giou_xyxy(box_cxcywh_to_xyxy(dn_boxes),
                     box_cxcywh_to_xyxy(src_boxes))
    loss_giou = ((1.0 - giou) * pos).sum() / num_pos
    total = cls_weight * loss_cls + l1_weight * loss_l1 \
        + giou_weight * loss_giou
    return total, {"dn_cls": loss_cls, "dn_l1": loss_l1, "dn_giou": loss_giou}
