"""Temporal D-FINE: cross-frame fusion over B-scan sequences.

Counterpart of ``pautdx/models/vision/temporal_dfine.py``: the three
variants with the reference's semantics.

- **v1**: a frozen D-FINE trunk; a post-norm transformer fuses each
  decoder query across the T frames, and heads copied from the trunk's
  last class/bbox heads (:func:`init_heads_from_trunk`) re-decode the
  fused features, projected on the trunk's non-uniform FDR grid.
- **v2**: a fresh class head of ``num_temporal_labels`` (defects + 1
  no-object) and the copied bbox head, on the uniform grid
  ``arange(bins + 1) * |up| / |reg_scale|``.
- **v3**: v2 plus a temporal attention pool (d -> 256 -> 1, softmax over
  T), a BiGRU context aggregator with its projector, and an anomaly MLP
  (d -> 256 -> 128 -> defects) whose scores are added to the defect
  logits (the no-object logit passes through); the heads read
  ``fused * attn + context``.

Input is one sequence of T frames (T, H, W, 3), the trunk's batch. The
trunk always runs in eval mode, whatever the temporal module's mode.
``forward`` is the trunk's call followed by :meth:`TemporalDFine.fuse`,
the fusion and heads on its ``last_hidden_state`` and last
``initial_references``. v1 and v2 cut the graph at the trunk's outputs
(``.detach()`` where the reference has ``stop_gradient``); v3 does not.

Module names mirror the reference's parameter tree (``trunk``,
``temporal_encoder.layer_{i}``, ``temporal_attention.0``/``.2``,
``context_aggregator``, ``context_projector``, ``class_head``,
``bbox_head``, ``anomaly_detector.0``/``.2``/``.4``), so weights move
through ``compat.jax_weights``.

Training: :func:`trainable_mask` is each variant's trainable set by
parameter name, :func:`temporal_consistency_loss` v3's anomaly term; the
recipe around them is ``train/temporal.py``. Under ``model.train()`` the
temporal encoder's dropout (0.1) is active; the trunk stays in eval mode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.dfine import (
    DFine, DFineConfig, Dense, MLPHead, distance2bbox, integral,
    weighting_function,
)
from pautdx_torch.models.vision.hgnet import init_params
from pautdx_torch.nn.recurrent import BiGRU
from pautdx_torch.nn.transformer import Encoder

VARIANTS = ("v1", "v2", "v3")


class TemporalDFine(nn.Module):
    """``forward(frames)`` takes (T, H, W, 3) images and returns
    ``pred_boxes`` (T, Q, 4) normalized cxcywh in float32, ``logits``
    (T, Q, head_labels), the trunk's own ``trunk_logits`` and
    ``trunk_boxes``, and for v3 ``anomaly`` (T, Q, defects)."""

    def __init__(self, cfg: DFineConfig = DFineConfig(), variant: str = "v1",
                 num_temporal_labels: Optional[int] = None,
                 num_temporal_layers: int = 4, temporal_heads: int = 8,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"TemporalDFine: variant {variant!r}, want one "
                             f"of {VARIANTS}")
        self.cfg = cfg
        self.variant = variant
        self.num_temporal_labels = num_temporal_labels
        dev = resolve_device(device)
        self.trunk = DFine(cfg, device=dev, seed=seed)
        d = cfg.d_model
        with torch.device(dev):
            heads = nn.Module()
            heads.temporal_encoder = Encoder(
                num_temporal_layers, d, temporal_heads, 4 * d, dropout=0.1)
            if variant == "v3":
                heads.temporal_attention = nn.Sequential(
                    Dense(d, 256), nn.ReLU(), Dense(256, 1))
                heads.context_aggregator = BiGRU(d, d)
                heads.context_projector = Dense(2 * d, d)
            heads.class_head = Dense(d, self.head_labels)
            heads.bbox_head = MLPHead(d, d, 4 * (cfg.max_num_bins + 1), 3)
            if variant == "v3":
                heads.anomaly_detector = nn.Sequential(
                    Dense(d, 256), nn.ReLU(), Dense(256, 128), nn.ReLU(),
                    Dense(128, self.n_defects))
        init_params(heads, seed)
        for name, module in heads.named_children():
            self.add_module(name, module)
        self.eval()
        self._project: Dict[torch.device, torch.Tensor] = {}

    @property
    def head_labels(self) -> int:
        if self.variant == "v1" or self.num_temporal_labels is None:
            return self.cfg.num_labels
        return self.num_temporal_labels

    @property
    def n_defects(self) -> int:
        return max(self.head_labels - 1, 1)

    @property
    def stop_trunk_gradient(self) -> bool:
        return self.variant in ("v1", "v2")

    def project(self, device: torch.device) -> torch.Tensor:
        """The FDR projection grid: the trunk's non-uniform one for v1,
        the uniform ``arange(bins + 1) * |up| / |reg_scale|`` for v2/v3."""
        if device not in self._project:
            c = self.cfg
            if self.variant == "v1":
                grid = weighting_function(c.max_num_bins, c.up, c.reg_scale)
            else:
                grid = (torch.arange(c.max_num_bins + 1, dtype=torch.float32)
                        * abs(c.up) / abs(c.reg_scale))
            self._project[device] = grid.to(device)
        return self._project[device]

    def forward(self, frames: torch.Tensor) -> Dict[str, Any]:
        trunk_out = self.trunk(frames, train=False)
        hidden = trunk_out["last_hidden_state"]         # (T, Q, D)
        init_refs = trunk_out["initial_references"][-1]
        if self.stop_trunk_gradient:
            hidden = hidden.detach()
            init_refs = init_refs.detach()
        out = self.fuse(hidden, init_refs)
        out["trunk_logits"] = trunk_out["logits"]
        out["trunk_boxes"] = trunk_out["pred_boxes"]
        return out

    def fuse(self, hidden: torch.Tensor, init_refs: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """The trunk's (T, Q, D) last hidden state and (T, Q, 4) initial
        references -> ``pred_boxes``, ``logits`` and (v3) ``anomaly``."""
        c = self.cfg
        # fuse across time: queries become the batch axis
        fused = self.temporal_encoder(hidden.transpose(0, 1))  # (Q, T, D)
        if self.variant == "v3":
            attn = torch.softmax(self.temporal_attention(fused), dim=-2)
            context = self.context_projector(self.context_aggregator(fused))
            feats = (fused * attn + context).transpose(0, 1)
        else:
            feats = fused.transpose(0, 1)
        scores = self.class_head(feats)
        corners = torch.nan_to_num(self.bbox_head(feats), nan=0.0,
                                   posinf=1.0, neginf=0.0)
        boxes = distance2bbox(
            init_refs, integral(corners, self.project(feats.device),
                                c.max_num_bins), c.reg_scale)
        out = {"pred_boxes": torch.nan_to_num(boxes, nan=0.5).clamp(0.0, 1.0)}
        if self.variant == "v3":
            n = self.n_defects
            anomaly = self.anomaly_detector(feats)
            out["anomaly"] = anomaly
            scores = torch.cat([scores[..., :n] + anomaly, scores[..., n:]],
                               dim=-1)
        out["logits"] = torch.nan_to_num(scores.clamp(-20.0, 20.0), nan=0.0,
                                         posinf=20.0, neginf=-20.0)
        return out


@torch.no_grad()
def init_heads_from_trunk(model: TemporalDFine) -> TemporalDFine:
    """The reference's post-init, in place: copy the trunk's last class
    head into ``class_head`` when their shapes match (v1; a v2/v3 with as
    many labels as the trunk), always copy the full 3-layer last
    ``bbox_embed`` into ``bbox_head``, and rescale every weight of rank
    >= 2 of the temporal encoder to std 1e-3 (the population std, as
    ``jnp.std``); its biases and LayerNorms stay as they are."""
    trunk = model.trunk
    cls_src = trunk.class_embed[-1]
    if model.class_head.weight.shape == cls_src.weight.shape:
        model.class_head.load_state_dict(cls_src.state_dict())
    model.bbox_head.load_state_dict(trunk.bbox_embed[-1].state_dict())
    for p in model.temporal_encoder.parameters():
        if p.dim() >= 2:
            p.mul_(1e-3 / (p.std(correction=0) + 1e-12))
    return model


def temporal_consistency_loss(anomaly: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of consecutive frames' anomaly scores
    (weight 0.1 in v3, ``temp_dfine_over_improved.py:292-301``)."""
    return (anomaly[1:] - anomaly[:-1]).square().mean()


def trainable_mask(variant: str, model: TemporalDFine) -> Dict[str, bool]:
    """Which parameters train, by dotted name: v1 the temporal encoder
    only (``temporal_dfine.py:133-139``); v2 also the fresh class head
    (``temp_dfine_over.py:150-172``); v3 everything but the trunk's
    backbone, ``trunk.model.backbone.model`` (``temp_dfine_over_improved.py:
    152-157``)."""
    if variant not in VARIANTS:
        raise ValueError(f"trainable_mask: variant {variant!r}, want one of "
                         f"{VARIANTS}")

    def decide(name: str) -> bool:
        top = name.split(".", 1)[0]
        if variant == "v1":
            return top == "temporal_encoder"
        if variant == "v2":
            return top in ("temporal_encoder", "class_head")
        return not name.startswith("trunk.model.backbone.model.")

    return {name: decide(name) for name, _ in model.named_parameters()}
