"""HybridBinary, the reference's best-validated per-signal defect detector.

Counterpart of ``pautdx/models/signal/hybrid_binary.py``. Over (B, N, S),
N signals of S samples a sequence:
1. per-signal conv stack 1 -> 32 -> 64 -> 64 (k3/3/5), pooled to 128
   samples, mean over the channels: a 128-d descriptor a signal;
2. concat[x, x - mean over N] -> 256-d;
3. shared MLP 256 -> 256 -> 128 (dropout, ReLU);
4. learned position encoding (max_len 1200);
5. 4 hybrid encoder layers (MHA + LocalAttention k11 then k5 + FFN 48);
6. linear -> sigmoid: per-signal defect probability (B, N).

Step 2's mean runs over the request's own N: a request answered at its
exact shape sees no padding (``serve.endpoints.SignalEndpoint``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.nn.attention import RelativePositionEncoding
from pautdx_torch.nn.blocks import ConvStack1D, adaptive_avg_pool1d
from pautdx_torch.nn.transformer import Encoder


class HybridBinaryModel(nn.Module):
    def __init__(self, hidden_sizes: Sequence[int] = (256, 128, 48),
                 num_heads: int = 8, dropout: float = 0.15,
                 num_transformer_layers: int = 4, pooled_len: int = 128,
                 max_len: int = 1200, norm: str = "batch",
                 return_logits: bool = False,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.pooled_len = pooled_len
        self.return_logits = return_logits
        self.conv = ConvStack1D(1, (32, 64, 64), (3, 3, 5), norm=norm,
                                dropout=dropout)
        self.shared1 = nn.Linear(2 * pooled_len, hidden_sizes[0])
        self.shared2 = nn.Linear(hidden_sizes[0], hidden_sizes[1])
        self.drop = nn.Dropout(dropout)
        self.pos_enc = RelativePositionEncoding(hidden_sizes[1], max_len)
        self.encoder = Encoder(num_transformer_layers, hidden_sizes[1],
                               num_heads, hidden_sizes[2], dropout,
                               flavour="hybrid")
        self.classifier = nn.Linear(hidden_sizes[1], 1)
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        B, N, S = signals.shape
        x = self.conv(signals.reshape(B * N, 1, S))
        x = adaptive_avg_pool1d(x, self.pooled_len).mean(dim=1)
        seq = x.view(B, N, self.pooled_len)
        seq = torch.cat([seq, seq - seq.mean(dim=1, keepdim=True)], dim=-1)
        h = F.relu(self.drop(self.shared1(seq)))
        h = F.relu(self.drop(self.shared2(h)))
        h = self.encoder(self.pos_enc(h))
        logits = self.classifier(h)[..., 0]
        return logits if self.return_logits else torch.sigmoid(logits)
