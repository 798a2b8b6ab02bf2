"""The generation-1 MultiSignalClassifier family.

Counterpart of ``pautdx/models/signal/msc.py``:
- ``MultiSignalClassifier``: per-signal MLP, one MHA over the sequence, a
  sigmoid head on the attention output (no residual), the layout of the
  reference's ``MultiSignalClassifier_model*.pth``;
- ``ConvMultiSignalClassifier``: Conv1d 1 -> 64 -> 128 -> 128, global
  average pool, a 4-layer transformer (d 128, 4 heads), MLP head;
- ``SetTransformer``: Linear, 2 attention blocks, mean pool: one
  defect flag a sequence, (B,);
- ``SignalClassifierMLP``: a per-signal MLP baseline;
- ``DenseAutoencoder``: 64-32-16-32-64 over the whole signal, anomaly
  by reconstruction error.

All take (B, N, S). The models whose first layer reads the raw samples
take the signal length ``S`` (``signal_length``, 320 by default, the
recipe's).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.nn.attention import TinyMHA
from pautdx_torch.nn.blocks import MLP, ConvStack1D
from pautdx_torch.nn.transformer import LN_EPS, Encoder


class MultiSignalClassifier(nn.Module):
    """Per-signal MLP -> MHA across the signals -> per-signal sigmoid."""

    def __init__(self, hidden: Sequence[int] = (128, 64, 32),
                 num_heads: int = 4, return_logits: bool = False,
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.return_logits = return_logits
        self.embed = MLP(signal_length, hidden[:2])
        self.attn = TinyMHA(hidden[1], num_heads)
        self.head = MLP(hidden[1], (hidden[2], 1))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        a = self.attn(F.relu(self.embed(signals)))
        logits = self.head(a)[..., 0]
        return logits if self.return_logits else torch.sigmoid(logits)


class ConvMultiSignalClassifier(nn.Module):
    """Conv1D features, global average pool, transformer over the
    sequence."""

    def __init__(self, d_model: int = 128, num_heads: int = 4,
                 num_layers: int = 4, dropout: float = 0.1,
                 norm: str = "batch", return_logits: bool = False,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        self.return_logits = return_logits
        self.conv = ConvStack1D(1, (64, 128, d_model), (7, 5, 3), norm=norm)
        self.encoder = Encoder(num_layers, d_model, num_heads, 4 * d_model,
                               dropout)
        self.head = MLP(d_model, (64, 1), dropout=dropout)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.conv(signals.reshape(B * N, 1, S)).mean(dim=-1)
        x = self.encoder(x.view(B, N, self.d_model))
        logits = self.head(x)[..., 0]
        return logits if self.return_logits else torch.sigmoid(logits)


class SetTransformer(nn.Module):
    """A sequence-level defect flag: (B, N, S) -> (B,) probability."""

    def __init__(self, d_model: int = 128, num_heads: int = 4,
                 return_logits: bool = False, signal_length: int = 320,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.return_logits = return_logits
        self.embed = nn.Linear(signal_length, d_model)
        for i in range(2):
            self.add_module(f"mab_{i}", TinyMHA(d_model, num_heads))
            self.add_module(f"norm_{i}", nn.LayerNorm(d_model, eps=LN_EPS))
        self.head = MLP(d_model, (64, 1))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        h = self.embed(signals)
        for i in range(2):
            h = getattr(self, f"norm_{i}")(h + getattr(self, f"mab_{i}")(h))
        logits = self.head(h.mean(dim=-2))[..., 0]
        return logits if self.return_logits else torch.sigmoid(logits)


class SignalClassifierMLP(nn.Module):
    """Per-signal MLP baseline, no context across signals."""

    def __init__(self, hidden: Sequence[int] = (128, 64),
                 return_logits: bool = False, signal_length: int = 320,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.return_logits = return_logits
        self.mlp = MLP(signal_length, tuple(hidden) + (1,))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        h = self.mlp(signals)[..., 0]
        return h if self.return_logits else torch.sigmoid(h)


class DenseAutoencoder(nn.Module):
    """Dense autoencoder over each signal, (B, N, S) -> (B, N, S); trained
    on healthy signals, its reconstruction error scores anomalies."""

    def __init__(self, bottleneck: Sequence[int] = (64, 32, 16),
                 signal_length: int = 320, device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        widths = [signal_length, *bottleneck,
                  *reversed(bottleneck[:-1]), signal_length]
        self.n = len(widths) - 1
        for i in range(self.n):
            self.add_module(f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        h = signals
        for i in range(self.n - 1):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.n - 1}")(h)

    @staticmethod
    def anomaly_score(recon: torch.Tensor, signals: torch.Tensor
                      ) -> torch.Tensor:
        return (recon - signals).square().mean(dim=-1)
