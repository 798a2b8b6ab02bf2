"""1-d strided backbone with an FPN, FiLM modulation and decoupled
detection/localisation heads.

Counterpart of ``pautdx/nn/fpn1d.py``:
- ``BackboneFPN1D``: five stride-2 ``ConvBlock1D`` (/2, /4, then C3 /8,
  C4 /16, C5 /32), 1-wide lateral convs, a top-down sum through
  ``_upsample2`` and a 3-wide smoothing conv a level: P3, P4, P5;
- ``FiLM1D``: features x (1 + gamma) + beta, (gamma, beta) a Dense of a
  context vector;
- ``Head1D``: a class logit and (centre offset, log width) a cell;
- ``decode_1d``: cells -> (score, normalised (start, end)).

Layout: (N, C, L), channels first, as ``nn.blocks``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pautdx_torch.nn.blocks import ConvBlock1D, SameConv1d


def _upsample2(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Nearest-neighbour x2 along the length axis, sliced to
    ``out_len``."""
    return x.repeat_interleave(2, dim=-1)[..., :out_len]


class BackboneFPN1D(nn.Module):
    def __init__(self, width: int = 64, norm: str = "group"):
        super().__init__()
        c = width
        ins = (1, c, c, 2 * c, 4 * c)
        outs = (c, c, 2 * c, 4 * c, 8 * c)
        for i, (ci, co, k) in enumerate(zip(ins, outs, (7, 3, 3, 3, 3))):
            self.add_module(f"ConvBlock1D_{i}",
                            ConvBlock1D(ci, co, k, stride=2, norm=norm))
        self.lat5 = SameConv1d(8 * c, 2 * c, 1)
        self.lat4 = SameConv1d(4 * c, 2 * c, 1)
        self.lat3 = SameConv1d(2 * c, 2 * c, 1)
        for name in ("out3", "out4", "out5"):
            self.add_module(name, SameConv1d(2 * c, 2 * c, 3))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.ConvBlock1D_1(self.ConvBlock1D_0(x))
        c3 = self.ConvBlock1D_2(x)
        c4 = self.ConvBlock1D_3(c3)
        c5 = self.ConvBlock1D_4(c4)
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _upsample2(p5, c4.shape[-1])
        p3 = self.lat3(c3) + _upsample2(p4, c3.shape[-1])
        return self.out3(p3), self.out4(p4), self.out5(p5)


class FiLM1D(nn.Module):
    """(N, C, L) features modulated by an (N, d) context."""

    def __init__(self, d_context: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(d_context, 2 * features)

    def forward(self, feat: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        gamma, beta = self.Dense_0(context).chunk(2, dim=-1)
        return feat * (1.0 + gamma[..., None]) + beta[..., None]


class Head1D(nn.Module):
    """(N, C, L) -> class logits (N, L) and (offset, log width) (N, L,
    2)."""

    def __init__(self, in_features: int, width: int = 128,
                 norm: str = "group"):
        super().__init__()
        self.cls_conv = ConvBlock1D(in_features, width, 3, norm=norm)
        self.cls_out = SameConv1d(width, 1, 1)
        self.reg_conv = ConvBlock1D(in_features, width, 3, norm=norm)
        self.reg_out = SameConv1d(width, 2, 1)

    def forward(self, x: torch.Tensor):
        cls = self.cls_out(self.cls_conv(x))[:, 0]
        reg = self.reg_out(self.reg_conv(x)).transpose(1, 2)
        return cls, reg


def decode_1d(cls_logits: torch.Tensor, reg: torch.Tensor, stride: int,
              signal_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell predictions -> (score, normalised (start, end)): centre
    (cell + 0.5 + tanh(offset)) x stride, width exp(clip(log w, -4, 4)) x
    stride."""
    cells = torch.arange(cls_logits.shape[-1], dtype=reg.dtype,
                         device=reg.device)
    center = (cells + 0.5 + torch.tanh(reg[..., 0])) * stride
    width = torch.exp(reg[..., 1].clamp(-4.0, 4.0)) * stride
    start = ((center - width / 2) / signal_length).clamp(0.0, 1.0)
    end = ((center + width / 2) / signal_length).clamp(0.0, 1.0)
    return torch.sigmoid(cls_logits), torch.stack([start, end], dim=-1)
