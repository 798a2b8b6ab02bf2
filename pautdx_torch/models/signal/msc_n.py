"""MSC conv 3-output models (gen 1.5) and ImprovedMSC (gen 2).

Counterpart of ``pautdx/models/signal/msc_n.py``:
- ``MSC3Out``: conv 1 -> 8 -> 16, mean over the channels, MLP, position
  encoding, cross-shift transformer -> a sigmoid probability and (start,
  end) as 0.5 * tanh + 0.5;
- ``MSC_N``: a background extractor (depthwise k11) subtracted from the
  conv features, LocalAttention (one depthwise k5) in place of the
  cross-attention, no conv norm;
- ``ImprovedMSC``: MSC_N scaled up (conv 1 -> 16 -> 32 with BatchNorm, bg
  k15, local k9, 4 hybrid layers), positions clamped, not squashed.

Output ``{"prob": (B, N), "positions": (B, N, 2)}``. The descriptor's MLP
reads the channel-mean signal, so these models take ``signal_length``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.nn.attention import RelativePositionEncoding
from pautdx_torch.nn.blocks import MLP, BackgroundExtractor, ConvStack1D
from pautdx_torch.nn.transformer import Encoder


class ConvDescriptor(nn.Module):
    """Per-signal conv stack, optional background subtraction on the
    conv features over the sample axis, mean over the channels, shared
    MLP S -> 2d -> d with a trailing ReLU: (B, N, S) -> (B, N, d)."""

    def __init__(self, signal_length: int, conv_features: Sequence[int],
                 conv_kernels: Sequence[int], d_model: int,
                 norm: str = "batch", bg_kernels: Sequence[int] = (),
                 bg_chained: bool = False, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.conv = ConvStack1D(1, conv_features, conv_kernels, norm=norm,
                                dropout=dropout)
        self.bg = (BackgroundExtractor(conv_features[-1], tuple(bg_kernels),
                                       chained=bg_chained)
                   if bg_kernels else None)
        self.proj = MLP(signal_length, (2 * d_model, d_model),
                        dropout=dropout, final_act=F.relu)

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.conv(signals.reshape(B * N, 1, S))
        if self.bg is not None:
            x = self.bg(x)
        return self.proj(x.mean(dim=1)).view(B, N, self.d_model)


class MSC3Out(nn.Module):
    """3-output MSC over a cross-shift transformer."""

    def __init__(self, d_model: int = 128, num_heads: int = 4,
                 num_layers: int = 2, dropout: float = 0.1,
                 max_len: int = 300, norm: str = "none",
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.descriptor = ConvDescriptor(signal_length, (8, 16), (3, 3),
                                         d_model, norm)
        self.pos_enc = RelativePositionEncoding(d_model, max_len)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout, flavour="cross_shift")
        self.head = nn.Linear(d_model, 3)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.encoder(self.pos_enc(self.descriptor(signals)))
        out = self.head(h)
        return {"prob": torch.sigmoid(out[..., 0]),
                "positions": 0.5 * torch.tanh(out[..., 1:3]) + 0.5}


class MSC_N(nn.Module):
    """LocalAttention variant with background subtraction."""

    def __init__(self, d_model: int = 128, num_heads: int = 4,
                 num_layers: int = 2, dropout: float = 0.1,
                 max_len: int = 300, bg_kernel: int = 11, norm: str = "none",
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.descriptor = ConvDescriptor(signal_length, (8, 16), (3, 3),
                                         d_model, norm,
                                         bg_kernels=(bg_kernel,))
        self.pos_enc = RelativePositionEncoding(d_model, max_len)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout, flavour="hybrid",
                               local_kernels=(5, 0))
        self.head = nn.Linear(d_model, 3)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.encoder(self.pos_enc(self.descriptor(signals)))
        out = self.head(h)
        return {"prob": torch.sigmoid(out[..., 0]),
                "positions": 0.5 * torch.tanh(out[..., 1:3]) + 0.5}


class ImprovedMSC(nn.Module):
    """Scaled-up MSC_N, the detection path of ``HybridModel``."""

    def __init__(self, d_model: int = 128, num_heads: int = 8,
                 num_layers: int = 4, dropout: float = 0.15,
                 max_len: int = 300, bg_kernel: int = 15,
                 norm: str = "batch", signal_length: int = 320,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.descriptor = ConvDescriptor(signal_length, (16, 32), (3, 3),
                                         d_model, norm,
                                         bg_kernels=(bg_kernel,),
                                         dropout=dropout)
        self.pos_enc = RelativePositionEncoding(d_model, max_len)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout, flavour="hybrid",
                               local_kernels=(9, 0))
        self.head = nn.Linear(d_model, 3)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.encoder(self.pos_enc(self.descriptor(signals)))
        out = self.head(h)
        return {"prob": torch.sigmoid(out[..., 0]),
                "positions": out[..., 1:3].clamp(0.0, 1.0)}
