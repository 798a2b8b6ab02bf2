"""The detection-model zoo: per-signal binary detectors.

Counterpart of ``pautdx/models/signal/detection_zoo.py``. Each model
takes (B, N, S) and returns per-signal defect probabilities (B, N), or a
dict with positions where the reference's has them. ``MODEL_ZOO`` holds
the reference's 21 names, each at its published default widths.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.models.signal.enhanced_position import (
    EnhancedPositionMSC, FixedEnhancedPositionMSC, HybridModel,
)
from pautdx_torch.models.signal.hybrid_binary import HybridBinaryModel
from pautdx_torch.models.signal.msc import (
    ConvMultiSignalClassifier, MultiSignalClassifier, SetTransformer,
    SignalClassifierMLP,
)
from pautdx_torch.models.signal.msc_n import MSC3Out, MSC_N, ImprovedMSC
from pautdx_torch.models.signal.two_stage import TwoStageDetector
from pautdx_torch.nn.attention import RelativePositionEncoding
from pautdx_torch.nn.blocks import (
    MLP, ConvStack1D, MultiScaleConv1D, RMSNorm, SameConv1d, SqueezeExcite1D,
    adaptive_avg_pool1d,
)
from pautdx_torch.nn.transformer import Encoder


def _pooled_descriptor(x: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """Conv features (B*N, C, S) -> pooled to 128 samples, mean over the
    channels: (B, N, 128)."""
    return adaptive_avg_pool1d(x, 128).mean(dim=1).view(B, N, 128)


class SimpleDetectionModel(nn.Module):
    """Linear projection + a deep, wide transformer (8 layers, 16 heads,
    learned position encoding of 1000)."""

    def __init__(self, d_model: int = 128, num_heads: int = 16,
                 num_layers: int = 8, dropout: float = 0.1,
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.proj = nn.Linear(signal_length, d_model)
        self.pos_enc = RelativePositionEncoding(d_model, 1000)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.head = nn.Linear(d_model, 1)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        h = self.encoder(self.pos_enc(self.proj(signals)))
        return torch.sigmoid(self.head(h)[..., 0])


class ComplexDetectionModel(nn.Module):
    """Multi-scale conv (k3/7/15) + pool to 128 + a 4-layer transformer."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.1,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.ms = MultiScaleConv1D(1, 32, (3, 7, 15), norm=norm)
        self.proj = nn.Linear(128, d_model)
        self.pos_enc = RelativePositionEncoding(d_model, 1000)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.head = MLP(d_model, (64, 1), dropout=dropout)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        h = _pooled_descriptor(self.ms(signals.reshape(B * N, 1, S)), B, N)
        h = self.encoder(self.pos_enc(self.proj(h)))
        return torch.sigmoid(self.head(h)[..., 0])


class NoiseRobustModel(nn.Module):
    """Large-kernel denoising front end (k7/5/9/17/5), hybrid encoder."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.15,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.denoise = ConvStack1D(1, (16, 32, 32, 64, 64), (7, 5, 9, 17, 5),
                                   norm=norm)
        # the pooled descriptor is 128 wide; another d_model projects it
        self.proj = nn.Linear(128, d_model) if d_model != 128 else None
        self.pos_enc = RelativePositionEncoding(d_model, 1200)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout, flavour="hybrid")
        self.head = nn.Linear(d_model, 1)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        h = _pooled_descriptor(self.denoise(signals.reshape(B * N, 1, S)),
                               B, N)
        if self.proj is not None:
            h = self.proj(h)
        h = self.encoder(self.pos_enc(h))
        return torch.sigmoid(self.head(h)[..., 0])


class DirectDefectModel(nn.Module):
    """4-conv stack + deep projection + transformer + deep classifier."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 3, dropout: float = 0.15,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.conv = ConvStack1D(1, (32, 64, 64, 64), (3, 3, 5, 5),
                                norm=norm, dropout=dropout)
        self.projection = MLP(128, (256, 192, d_model), dropout=dropout)
        self.pos_enc = RelativePositionEncoding(d_model, 1200)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.classifier = MLP(d_model, (128, 64, 1), dropout=dropout)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        h = _pooled_descriptor(self.conv(signals.reshape(B * N, 1, S)), B, N)
        h = self.encoder(self.pos_enc(self.projection(h)))
        return torch.sigmoid(self.classifier(h)[..., 0])


class FluctuationRobustModel(nn.Module):
    """Small-kernel conv + a 6-layer, 12-head transformer."""

    def __init__(self, d_model: int = 96, num_heads: int = 12,
                 num_layers: int = 6, dropout: float = 0.1,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.conv = ConvStack1D(1, (16, 32, 48), (3, 3, 3), norm=norm)
        self.proj = nn.Linear(48, d_model)
        self.pos_enc = RelativePositionEncoding(d_model, 1000)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.head = nn.Linear(d_model, 1)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.conv(signals.reshape(B * N, 1, S)).mean(dim=-1)
        h = self.proj(x).view(B, N, self.d_model)
        h = self.encoder(self.pos_enc(h))
        return torch.sigmoid(self.head(h)[..., 0])


class PatternEmbeddingModel(nn.Module):
    """A learned background reference; classification with the cosine
    similarity to it beside the transformer's features."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 2, dropout: float = 0.1,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.conv = ConvStack1D(1, (32, 64), (5, 5), norm=norm)
        self.proj = nn.Linear(64, d_model)
        self.background_reference = nn.Parameter(
            torch.randn(d_model) * 0.02)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.head = MLP(d_model + 1, (64, 1))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.conv(signals.reshape(B * N, 1, S)).mean(dim=-1)
        h = self.proj(x).view(B, N, self.d_model)
        ref = self.background_reference
        sim = (h * ref).sum(-1, keepdim=True) / (
            h.norm(dim=-1, keepdim=True) * ref.norm() + 1e-8)
        h = self.encoder(h)
        return torch.sigmoid(self.head(torch.cat([h, sim], -1))[..., 0])


class EnhancedPatternModel(nn.Module):
    """5 background prototypes, softmax similarity, a defect
    discriminator on the residual from the background, a fusion head."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 2, num_prototypes: int = 5,
                 dropout: float = 0.1, norm: str = "batch",
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.conv = ConvStack1D(1, (32, 64), (5, 5), norm=norm)
        self.proj = nn.Linear(64, d_model)
        self.background_prototypes = nn.Parameter(
            torch.randn(num_prototypes, d_model) * 0.02)
        self.discriminator = MLP(d_model, (64, d_model))
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.fusion_head = MLP(2 * d_model + num_prototypes, (128, 1))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.conv(signals.reshape(B * N, 1, S)).mean(dim=-1)
        h = self.proj(x).view(B, N, self.d_model)
        protos = self.background_prototypes
        sim = (h @ protos.t()) / (h.norm(dim=-1, keepdim=True)
                                  * protos.norm(dim=-1) + 1e-8)
        sim = torch.softmax(sim, dim=-1)
        disc = self.discriminator(h - sim @ protos)
        fused = torch.cat([self.encoder(h), disc, sim], dim=-1)
        return torch.sigmoid(self.fusion_head(fused)[..., 0])


class PositionLocalizationModel(nn.Module):
    """Position-only dual head: start and width; ``prob`` is all ones."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 3, dropout: float = 0.15,
                 norm: str = "batch", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.conv = ConvStack1D(1, (32, 64, 64), (3, 5, 5), norm=norm)
        self.proj = nn.Linear(128, d_model)
        self.pos_enc = RelativePositionEncoding(d_model, 1200)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.start_head = MLP(d_model, (64, 1))
        self.width_head = MLP(d_model, (64, 1))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, N, S = signals.shape
        h = _pooled_descriptor(self.conv(signals.reshape(B * N, 1, S)), B, N)
        h = self.encoder(self.pos_enc(self.proj(h)))
        start = torch.sigmoid(self.start_head(h)[..., 0])
        width = torch.sigmoid(self.width_head(h)[..., 0])
        end = (start + width).clamp(0.0, 1.0)
        return {"positions": torch.stack([start, end], dim=-1),
                "prob": torch.ones_like(start)}


class ModernHybridBinary(nn.Module):
    """RMSNorm + squeeze-excite + SiLU front end, hybrid encoder."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.1,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = SameConv1d(1, 32, 3)
        self.rms1 = RMSNorm(32)
        self.se1 = SqueezeExcite1D(32)
        self.conv2 = SameConv1d(32, 64, 5)
        self.rms2 = RMSNorm(64)
        self.se2 = SqueezeExcite1D(64)
        self.proj = nn.Linear(256, d_model)
        self.pos_enc = RelativePositionEncoding(d_model, 1200)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout, flavour="hybrid")
        self.head = nn.Linear(d_model, 1)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.se1(F.silu(self.rms1(self.conv1(
            signals.reshape(B * N, 1, S)))))
        x = self.se2(F.silu(self.rms2(self.conv2(x))))
        seq = _pooled_descriptor(x, B, N)
        h = self.proj(torch.cat([seq, seq - seq.mean(dim=1, keepdim=True)],
                                dim=-1))
        h = self.encoder(self.pos_enc(h))
        return torch.sigmoid(self.head(h)[..., 0])


# the reference's model-zoo dict, name for name
MODEL_ZOO = {
    "Simple": SimpleDetectionModel,
    "Complex": ComplexDetectionModel,
    "NoiseRobust": NoiseRobustModel,
    "DirectDefect": DirectDefectModel,
    "FluctuationRobust": FluctuationRobustModel,
    "PatternEmbedding": PatternEmbeddingModel,
    "EnhancedPattern": EnhancedPatternModel,
    "PositionLocalization": PositionLocalizationModel,
    "HybridBinary": HybridBinaryModel,
    "ModernHybridBinary": ModernHybridBinary,
    "MSC": MultiSignalClassifier,
    "ConvMSC": ConvMultiSignalClassifier,
    "MSC3Out": MSC3Out,
    "MSC_N": MSC_N,
    "ImprovedMSC": ImprovedMSC,
    "EnhancedPosition": EnhancedPositionMSC,
    "FixedEnhancedPosition": FixedEnhancedPositionMSC,
    "Hybrid": HybridModel,
    "TwoStage": TwoStageDetector,
    "SetTransformer": SetTransformer,
    "MLP": SignalClassifierMLP,
}
