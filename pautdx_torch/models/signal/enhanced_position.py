"""EnhancedPosition MSC and HybridModel: a detection path and a position
path.

Counterpart of ``pautdx/models/signal/enhanced_position.py``:
- ``EnhancedPositionMSC``: chained dual-scale background removal (k15,
  BatchNorm, k31), a detection head, a deep fine-position head over
  [shared, transformer, probability] and a coarse head, blended 0.7/0.3,
  then ``constrain_positions``;
- ``FixedEnhancedPositionMSC``: separate detection and position
  transformer stacks;
- ``HybridModel``: ImprovedMSC's detection path and a position module
  conditioned on its confidence; signals at 0.5 or below keep the
  detection path's positions.

Output ``{"prob", "positions"}`` (and ``"coarse_positions"`` for
EnhancedPositionMSC).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.models.signal.msc_n import ConvDescriptor, ImprovedMSC
from pautdx_torch.nn.attention import RelativePositionEncoding
from pautdx_torch.nn.blocks import MLP
from pautdx_torch.nn.transformer import Encoder


def constrain_positions(pos: torch.Tensor, min_gap: float = 0.01
                        ) -> torch.Tensor:
    """Sigmoid, then (start, end) sorted, with end >= start + ``min_gap``
    and end clipped to [0, 1]."""
    pos = torch.sigmoid(pos)
    start = torch.minimum(pos[..., 0], pos[..., 1])
    end = torch.maximum(pos[..., 0], pos[..., 1])
    end = torch.maximum(end, start + min_gap)
    return torch.stack([start, end.clamp(0.0, 1.0)], dim=-1)


class EnhancedPositionMSC(nn.Module):
    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.15,
                 max_len: int = 300, norm: str = "batch",
                 fine_weight: float = 0.7, signal_length: int = 320,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.fine_weight = fine_weight
        self.descriptor = ConvDescriptor(signal_length, (16, 32), (3, 3),
                                         d_model, norm, bg_kernels=(15, 31),
                                         bg_chained=True, dropout=dropout)
        self.pos_enc = RelativePositionEncoding(d_model, max_len)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout, flavour="hybrid",
                               local_kernels=(9, 0))
        self.detection_head = MLP(d_model, (64, 1), dropout=dropout)
        self.fine_position_head = MLP(2 * d_model + 1, (256, 128, 64, 2),
                                      dropout=dropout)
        self.coarse_position_head = MLP(d_model, (64, 2), dropout=dropout)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        shared = self.descriptor(signals)
        h = self.encoder(self.pos_enc(shared))
        prob = torch.sigmoid(self.detection_head(h)[..., 0])
        fine = self.fine_position_head(
            torch.cat([shared, h, prob[..., None]], dim=-1))
        coarse = self.coarse_position_head(h)
        w = self.fine_weight
        return {"prob": prob,
                "positions": constrain_positions(w * fine + (1 - w) * coarse),
                "coarse_positions": constrain_positions(coarse)}


class FixedEnhancedPositionMSC(nn.Module):
    """Separate transformer stacks for detection and position."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.15,
                 max_len: int = 300, norm: str = "batch",
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.descriptor = ConvDescriptor(signal_length, (16, 32), (3, 3),
                                         d_model, norm, bg_kernels=(15, 31),
                                         bg_chained=True, dropout=dropout)
        self.pos_enc = RelativePositionEncoding(d_model, max_len)
        for name in ("det_encoder", "pos_encoder"):
            self.add_module(name, Encoder(num_layers, d_model, num_heads,
                                          4 * d_model, dropout,
                                          flavour="hybrid",
                                          local_kernels=(9, 0)))
        self.detection_head = MLP(d_model, (64, 1), dropout=dropout)
        self.position_head = MLP(d_model, (128, 64, 2), dropout=dropout)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        shared = self.pos_enc(self.descriptor(signals))
        det = self.detection_head(self.det_encoder(shared))[..., 0]
        pos = self.position_head(self.pos_encoder(shared))
        return {"prob": torch.sigmoid(det),
                "positions": constrain_positions(pos)}


class HybridModel(nn.Module):
    """ImprovedMSC's detection path + a confidence-conditioned position
    module (``detection`` and ``position_*`` are the reference's two
    parameter groups)."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 dropout: float = 0.15, norm: str = "batch",
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.detection = ImprovedMSC(d_model=d_model, num_heads=num_heads,
                                     dropout=dropout, norm=norm,
                                     signal_length=signal_length,
                                     device="cpu")
        self.position_descriptor = ConvDescriptor(signal_length, (16, 32),
                                                  (3, 3), d_model, norm)
        self.position_head = MLP(d_model + 1, (256, 128, 2),
                                 dropout=dropout)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        det = self.detection(signals)
        prob = det["prob"]
        cond = torch.cat([self.position_descriptor(signals),
                          prob[..., None]], dim=-1)
        pos = constrain_positions(self.position_head(cond))
        pos = torch.where(prob[..., None] > 0.5, pos, det["positions"])
        return {"prob": prob, "positions": pos}
