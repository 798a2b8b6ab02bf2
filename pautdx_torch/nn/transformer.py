"""Transformer encoder stacks.

Counterpart of ``pautdx/nn/transformer.py``. Ported: the post-norm
``EncoderLayer`` (torch ``nn.TransformerEncoderLayer`` semantics) and the
``Encoder`` stack of its ``plain`` flavour, the temporal D-FINE's
encoder. The ``hybrid`` and ``cross_shift`` flavours belong to the signal
models (ROADMAP.md, queue 1, item 11).

Module names mirror the reference's parameter tree (``layer_{i}``,
``self_attn``, ``norm1``/``norm2`` and the auto-named FFN ``Dense_0`` /
``Dense_1``), so weights move leaf by leaf. Its LayerNorms are the JAX one's
default, eps 1e-6, unlike D-FINE's 1e-5. Dropout follows the module's
training mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.nn.attention import TinyMHA

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


class Encoder(nn.Module):
    """A stack of ``num_layers`` encoder layers over (..., L, d)."""

    def __init__(self, num_layers: int, d: int, num_heads: int,
                 ffn_dim: int, dropout: float = 0.1, flavour: str = "plain"):
        super().__init__()
        if flavour != "plain":
            raise NotImplementedError(
                f"encoder flavour {flavour!r} is not ported yet; only "
                f"'plain' is (ROADMAP.md, queue 1, item 11)")
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}",
                            EncoderLayer(d, num_heads, ffn_dim, dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x
