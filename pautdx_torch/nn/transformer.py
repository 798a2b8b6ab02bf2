"""Transformer encoder stacks.

Counterpart of ``pautdx/nn/transformer.py``, in its three flavours:
- ``plain``: the post-norm ``EncoderLayer`` (torch
  ``nn.TransformerEncoderLayer`` semantics), the temporal D-FINE's and
  most signal models' encoder;
- ``hybrid``: ``HybridEncoderLayer``, MHA, then ``LocalAttention``, then
  the FFN, each with a residual and a post-norm (HybridBinary, MSC_N,
  ImprovedMSC and their kin);
- ``cross_shift``: ``CrossShiftEncoderLayer``, self-attention, then
  cross-attention to the sequence rolled right by one step (MSC3Out).

Module names mirror the reference's parameter tree (``layer_{i}``,
``self_attn``, ``cross_attn``, ``local_attn``, ``norm1``..``norm3`` and
the auto-named FFN ``Dense_0`` / ``Dense_1``), so weights move leaf by
leaf. Its LayerNorms are the JAX one's
default, eps 1e-6, unlike D-FINE's 1e-5. Dropout follows the module's
training mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.nn.attention import LocalAttention, TinyMHA

LN_EPS = 1e-6       # the reference's LayerNorm default


class EncoderLayer(nn.Module):
    """Post-norm encoder layer: x = LN(x + MHA(x)); x = LN(x + FFN(x))."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = TinyMHA(d, num_heads, dropout)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d, ffn_dim)
        self.Dense_1 = nn.Linear(ffn_dim, d)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x)))
        h = self.drop(F.relu(self.Dense_0(x)))
        return self.norm2(x + self.drop(self.Dense_1(h)))


class HybridEncoderLayer(nn.Module):
    """x = LN(x + MHA(x)); x = LN(x + Local(x)); x = LN(x + FFN(x)), the
    FFN's dropout before its ReLU, as the reference's."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.15, local_kernel: int = 11,
                 local_kernel2: int = 5):
        super().__init__()
        self.self_attn = TinyMHA(d, num_heads, dropout)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.local_attn = LocalAttention(d, local_kernel, local_kernel2)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d, ffn_dim)
        self.Dense_1 = nn.Linear(ffn_dim, d)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x)))
        x = self.norm2(x + self.drop(self.local_attn(x)))
        h = F.relu(self.drop(self.Dense_0(x)))
        return self.norm3(x + self.drop(self.Dense_1(h)))


class CrossShiftEncoderLayer(nn.Module):
    """x = LN(x + MHA(x)); x = LN(x + MHA(x, roll(x, 1))); x = LN(x +
    FFN(x)), the roll along the sequence axis."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = TinyMHA(d, num_heads, dropout)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn = TinyMHA(d, num_heads, dropout)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d, ffn_dim)
        self.Dense_1 = nn.Linear(ffn_dim, d)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x)))
        shifted = torch.roll(x, shifts=1, dims=-2)
        x = self.norm2(x + self.drop(self.cross_attn(x, shifted)))
        h = self.Dense_1(F.relu(self.Dense_0(x)))
        return self.norm3(x + self.drop(h))


class Encoder(nn.Module):
    """A stack of ``num_layers`` encoder layers of one ``flavour`` over
    (..., L, d). ``local_kernels`` (hybrid only): the (k1, k2) of each
    layer's ``LocalAttention``, k2 = 0 for a single conv; (11, 5) is
    HybridBinary's, MSC_N passes (5, 0) and ImprovedMSC (9, 0)."""

    def __init__(self, num_layers: int, d: int, num_heads: int,
                 ffn_dim: int, dropout: float = 0.1, flavour: str = "plain",
                 local_kernels: tuple = (11, 5)):
        super().__init__()
        if flavour not in ("plain", "hybrid", "cross_shift"):
            raise ValueError(f"unknown encoder flavour {flavour!r}")
        self.num_layers = num_layers
        for i in range(num_layers):
            if flavour == "hybrid":
                layer = HybridEncoderLayer(d, num_heads, ffn_dim, dropout,
                                           *local_kernels)
            elif flavour == "cross_shift":
                layer = CrossShiftEncoderLayer(d, num_heads, ffn_dim, dropout)
            else:
                layer = EncoderLayer(d, num_heads, ffn_dim, dropout)
            self.add_module(f"layer_{i}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x
