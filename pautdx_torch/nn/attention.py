"""Attention primitives.

Counterpart of ``pautdx/nn/attention.py``. Ported: ``TinyMHA``, the
explicit-QKV multi-head attention of the temporal encoder, as the
self-attention it runs there. Its cross-attention and mask, which only the
signal models use, and the signal domain's ``LocalAttention`` and position
encodings wait for ROADMAP.md, queue 1, item 11.

The attention is plain batched matmuls and a softmax, as the reference's
is einsums outside any Pallas kernel: sequences here are a few dozen
steps long.
"""

from __future__ import annotations

import math
import torch
from torch import nn


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Self-attention over (..., L, d)."""
        h = self.num_heads
        dh = x.shape[-1] // h

        def split(t):                    # (..., L, d) -> (..., h, L, dh)
            return t.unflatten(-1, (h, dh)).transpose(-3, -2)

        Q = split(self.q_proj(x))
        K = split(self.k_proj(x))
        V = split(self.v_proj(x))
        logits = Q @ K.transpose(-1, -2) / math.sqrt(dh)
        w = self.dropout(torch.softmax(logits, dim=-1))
        out = (w @ V).transpose(-3, -2).flatten(-2)
        return self.out_proj(out)
