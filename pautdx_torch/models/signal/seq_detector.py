"""SignalSequenceDetector (v1) and its Enhanced variant.

Counterpart of ``pautdx/models/signal/seq_detector.py``. v1 over (B, L,
S):
1. per-signal conv encoder 1 -> 64 -> 128 -> 256 (k7/5/3), pooled to 4
   samples, ``fc`` -> d = 128, ReLU;
2. sinusoidal position encoding, a 4-layer plain transformer;
3. ``ContextAggregator`` (two BiGRUs, ``proj``); a per-step health MLP
   d -> d/2 -> d/4 -> d;
4. a softmax over the sequence of an MLP score d -> d/4 -> 1; enhanced =
   features x score + context;
5. an anomaly score, sigmoid of an MLP over [enhanced, health];
6. class logits (class 0 = Health) and sigmoid (start, end) from MLPs;
7. the anomaly score added to every non-health logit.

The Enhanced variant (d 256, 8 heads, 6 layers): dilated branches (d/8
each), a residual block (dilation 2), a pyramid of two stride-2 convs
(``down1``, ``down2``, SAME padding), the three scales' means fused, then
the transformer, ``QueryAttentionAggregator``, cross-attention of the
features to the per-step context, softplus uncertainties on the class and
the positions, and the probability deflated by the class uncertainty.

Output: ``{"class_logits", "positions", "anomaly", "prob"}`` (+
``"class_uncertainty"``, ``"position_uncertainty"`` for Enhanced).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.nn.attention import SinusoidalPositionEncoding, TinyMHA
from pautdx_torch.nn.blocks import (
    MLP, ConvStack1D, DilatedBranches1D, ResidualBlock1D, SameConv1d,
    adaptive_avg_pool1d,
)
from pautdx_torch.nn.recurrent import (
    ContextAggregator, QueryAttentionAggregator,
)
from pautdx_torch.nn.transformer import Encoder


def _add_anomaly(cls_logits: torch.Tensor, anomaly: torch.Tensor
                 ) -> torch.Tensor:
    """``cls_logits.at[..., 1:].add(anomaly[..., None])``."""
    return torch.cat([cls_logits[..., :1],
                      cls_logits[..., 1:] + anomaly[..., None]], dim=-1)


class SignalEncoder(nn.Module):
    """Per-signal conv stack -> a d-wide descriptor: (B, L, S) -> (B, L,
    d)."""

    def __init__(self, d_model: int = 128, norm: str = "batch"):
        super().__init__()
        self.d_model = d_model
        self.conv = ConvStack1D(1, (64, 128, 256), (7, 5, 3), norm=norm)
        self.fc = nn.Linear(256 * 4, d_model)

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, L, S = signals.shape
        x = self.conv(signals.reshape(B * L, 1, S))
        # the reference flattens its (4, 256) channels-last pool
        x = adaptive_avg_pool1d(x, 4).transpose(1, 2).reshape(B * L, -1)
        return F.relu(self.fc(x)).view(B, L, self.d_model)


class SignalSequenceDetector(nn.Module):
    def __init__(self, num_classes: int = 2, d_model: int = 128,
                 num_heads: int = 4, num_layers: int = 4,
                 dropout: float = 0.1, norm: str = "batch",
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        d = d_model
        self.encoder = SignalEncoder(d, norm)
        self.pos_enc = SinusoidalPositionEncoding(d)
        self.transformer = Encoder(num_layers, d, num_heads, 4 * d, dropout)
        self.context = ContextAggregator(d)
        self.health_extractor = MLP(d, (d // 2, d // 4, d))
        self.seq_attention = MLP(d, (d // 4, 1))
        self.anomaly = MLP(2 * d, (d, 1))
        self.class_head = MLP(d, (d, num_classes))
        self.position_head = MLP(d, (d, 2))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.transformer(self.pos_enc(self.encoder(signals)))
        context = self.context(h)
        health = self.health_extractor(h)
        attn = torch.softmax(self.seq_attention(h), dim=-2)
        enhanced = h * attn + context
        anomaly = torch.sigmoid(self.anomaly(
            torch.cat([enhanced, health], dim=-1))[..., 0])
        cls_logits = _add_anomaly(self.class_head(enhanced), anomaly)
        positions = torch.sigmoid(self.position_head(enhanced))
        return {"class_logits": cls_logits, "positions": positions,
                "anomaly": anomaly,
                "prob": 1.0 - torch.softmax(cls_logits, dim=-1)[..., 0]}


class EnhancedSignalSequenceDetector(nn.Module):
    def __init__(self, num_classes: int = 2, d_model: int = 256,
                 num_heads: int = 8, num_layers: int = 6,
                 dropout: float = 0.1, norm: str = "batch",
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        d = d_model
        self.d_model = d
        # the residual block's input is the four branches' d / 8 each;
        # the branches keep their BatchNorm whatever ``norm`` says, as the
        # reference's do
        self.multi_scale = DilatedBranches1D(1, d // 8)
        self.res1 = ResidualBlock1D(d // 2, d // 2, dilation=2, norm=norm)
        self.down1 = SameConv1d(d // 2, d // 2, 3, stride=2)
        self.down2 = SameConv1d(d // 2, d // 2, 3, stride=2)
        self.fuse = nn.Linear(3 * (d // 2), d)
        self.pos_enc = SinusoidalPositionEncoding(d)
        self.transformer = Encoder(num_layers, d, num_heads, 4 * d, dropout)
        self.context = QueryAttentionAggregator(d, num_heads // 2)
        self.cross_attn = TinyMHA(d, num_heads)
        self.integrate = nn.Linear(2 * d, d)
        self.class_head = MLP(d, (d, num_classes))
        self.class_uncertainty = MLP(d, (64, 1))
        self.position_head = MLP(d, (d, 2))
        self.position_uncertainty = MLP(d, (64, 2))
        self.anomaly = MLP(2 * d, (d, 1))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, L, S = signals.shape
        p1 = self.res1(self.multi_scale(signals.reshape(B * L, 1, S)))
        p2 = self.down1(p1)
        p3 = self.down2(p2)
        pooled = torch.cat([p.mean(dim=-1) for p in (p1, p2, p3)], dim=-1)
        feats = F.relu(self.fuse(pooled)).view(B, L, self.d_model)
        h = self.transformer(self.pos_enc(feats))
        per_step, pooled_ctx = self.context(h)
        cross = self.cross_attn(h, per_step)
        fused = F.relu(self.integrate(torch.cat([h, cross], dim=-1)))
        cls_logits = self.class_head(fused)
        cls_unc = F.softplus(self.class_uncertainty(fused)[..., 0])
        positions = torch.sigmoid(self.position_head(fused))
        pos_unc = F.softplus(self.position_uncertainty(fused))
        anomaly_in = torch.cat(
            [fused, pooled_ctx[..., None, :].expand_as(fused)], dim=-1)
        anomaly = torch.sigmoid(self.anomaly(anomaly_in)[..., 0])
        cls_logits = _add_anomaly(cls_logits, anomaly)
        probs = torch.softmax(cls_logits, dim=-1)
        confidence = (1.0 - probs[..., 0]) / (1.0 + cls_unc)
        return {"class_logits": cls_logits, "positions": positions,
                "anomaly": anomaly, "class_uncertainty": cls_unc,
                "position_uncertainty": pos_unc, "prob": confidence}
