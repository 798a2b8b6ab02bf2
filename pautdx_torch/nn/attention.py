"""Attention primitives and position encodings.

Counterpart of ``pautdx/nn/attention.py``:
- ``TinyMHA``, explicit-QKV multi-head attention: self-attention, and
  cross-attention to ``kv`` with an optional boolean ``mask`` (logits
  filled with -1e9 where it is False);
- ``LocalAttention``, depthwise convolutions over the sequence axis (k11
  then k5 in HybridBinary; one conv, k5 or k9, in MSC_N and ImprovedMSC);
- ``RelativePositionEncoding``, learned additive embeddings sliced to the
  sequence length, and ``SinusoidalPositionEncoding``.
``AttentionPool`` waits with the signal models' training half (ROADMAP.md,
queue 1, item 11b).

The attention is plain batched matmuls and a softmax, as the reference's
is einsums outside any Pallas kernel: sequences here are a few dozen
steps long.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from pautdx_torch.nn.blocks import DepthwiseConv1D


class TinyMHA(nn.Module):
    """Multi-head attention with separate q/k/v/out projections of width
    ``d``; dropout on the attention weights in training mode."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"d_model {d} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.dropout = nn.Dropout(dropout)

    def forward(self, q: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Queries (..., Lq, d) attend to ``kv`` (..., Lk, d), by default
        ``q`` itself; ``mask`` broadcasts against the (..., h, Lq, Lk)
        logits."""
        kv = q if kv is None else kv
        h = self.num_heads
        dh = q.shape[-1] // h

        def split(t):                    # (..., L, d) -> (..., h, L, dh)
            return t.unflatten(-1, (h, dh)).transpose(-3, -2)

        Q = split(self.q_proj(q))
        K = split(self.k_proj(kv))
        V = split(self.v_proj(kv))
        logits = Q @ K.transpose(-1, -2) / math.sqrt(dh)
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e9)
        w = self.dropout(torch.softmax(logits, dim=-1))
        out = (w @ V).transpose(-3, -2).flatten(-2)
        return self.out_proj(out)


class LocalAttention(nn.Module):
    """Depthwise convolutions ``local1`` (k ``kernel_size``) and, unless
    ``kernel_size2`` is 0, ``local2`` over the sequence axis of
    (B, N, d); one transpose each way around both."""

    def __init__(self, d: int, kernel_size: int = 11, kernel_size2: int = 5):
        super().__init__()
        self.local1 = DepthwiseConv1D(d, kernel_size)
        self.local2 = (DepthwiseConv1D(d, kernel_size2) if kernel_size2
                       else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.local1(x.transpose(-1, -2))
        if self.local2 is not None:
            x = self.local2(x)
        return x.transpose(-1, -2)


class RelativePositionEncoding(nn.Module):
    """x + encoding[:N] over (..., N, d); ``encoding`` (max_len, d) is
    learned, initialised N(0, 1) as the reference's."""

    def __init__(self, d: int, max_len: int = 1200):
        super().__init__()
        self.encoding = nn.Parameter(torch.randn(max_len, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.encoding[:x.shape[-2]]


class SinusoidalPositionEncoding(nn.Module):
    """x + the fixed sin/cos table (sin on even, cos on odd features),
    sliced to N; the table is a buffer outside the state dict, as the
    reference holds it outside its parameters."""

    def __init__(self, d: int, max_len: int = 5000):
        super().__init__()
        pos = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
        pe = np.zeros((max_len, d), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)[:, : d // 2]
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[:x.shape[-2]]
