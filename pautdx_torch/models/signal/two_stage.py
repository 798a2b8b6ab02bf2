"""TwoStageDetector: a binary classifier stage and a position stage.

Counterpart of ``pautdx/models/signal/two_stage.py``: multi-scale convs
(k3/5/7/11, concatenated), the mean over the samples, a plain transformer
for context; stage 1 a classifier with a softplus uncertainty, stage 2
positions from [context, probability] with their own uncertainty,
scaled by the probability.

Output ``{"prob", "positions", "cls_uncertainty", "pos_uncertainty"}``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.nn.blocks import MLP, MultiScaleConv1D
from pautdx_torch.nn.transformer import Encoder


class TwoStageDetector(nn.Module):
    def __init__(self, d_model: int = 128, num_heads: int = 4,
                 num_layers: int = 2, dropout: float = 0.1,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.ms_encoder = MultiScaleConv1D(1, d_model // 4, (3, 5, 7, 11),
                                           norm=norm)
        self.proj = MLP(d_model, (d_model,))
        self.context = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.classifier = MLP(d_model, (64, 1), dropout=dropout)
        self.cls_uncertainty = MLP(d_model, (64, 1))
        self.position = MLP(d_model + 1, (128, 64, 2), dropout=dropout)
        self.pos_uncertainty = MLP(d_model, (64, 2))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, N, S = signals.shape
        x = self.ms_encoder(signals.reshape(B * N, 1, S)).mean(dim=-1)
        h = self.context(self.proj(x).view(B, N, self.d_model))
        prob = torch.sigmoid(self.classifier(h)[..., 0])
        cls_unc = F.softplus(self.cls_uncertainty(h)[..., 0])
        pos = torch.sigmoid(self.position(
            torch.cat([h, prob[..., None]], dim=-1)))
        return {"prob": prob, "positions": pos * prob[..., None],
                "cls_uncertainty": cls_unc,
                "pos_uncertainty": F.softplus(self.pos_uncertainty(h))}
