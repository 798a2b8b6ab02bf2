"""Hybrid1DDetLoc, the anchor-free 1-d detector with an FPN and FiLM.

Counterpart of ``pautdx/models/signal/detloc1d.py``: a per-signal
backbone with a /8 /16 /32 pyramid (``nn.fpn1d``), a context transformer
across the N signals over each signal's pooled pyramid descriptor, FiLM
modulation of every level by that context and decoupled heads a level.
Trained with ``losses.heatmap.detloc_criterion``.

Output a scale: ``{"cls": (B, N, Ls), "reg": (B, N, Ls, 2)}``, strides
(8, 16, 32); ``decode`` picks each signal's best cell over all scales.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from pautdx_torch.device import Device, resolve_device
from pautdx_torch.nn.fpn1d import BackboneFPN1D, FiLM1D, Head1D, decode_1d
from pautdx_torch.nn.transformer import Encoder

STRIDES = (8, 16, 32)


class Hybrid1DDetLoc(nn.Module):
    """The context transformer's dropout is the encoder's default 0.1, as
    the reference fixes it."""

    def __init__(self, width: int = 64, d_context: int = 128,
                 num_heads: int = 8, num_context_layers: int = 2,
                 norm: str = "group", device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_context = d_context
        c = 2 * width
        self.backbone = BackboneFPN1D(width, norm)
        self.ctx_proj = nn.Linear(3 * c, d_context)
        self.seq_context = Encoder(num_context_layers, d_context, num_heads,
                                   4 * d_context)
        for i in range(3):
            self.add_module(f"film_{i}", FiLM1D(d_context, c))
            self.add_module(f"head_{i}", Head1D(c, c, norm))
        self.to(dev).eval()

    def forward(self, signals: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        B, N, S = signals.shape
        levels = self.backbone(signals.reshape(B * N, 1, S))
        desc = torch.cat([p.mean(dim=-1) for p in levels], dim=-1)
        ctx = self.seq_context(self.ctx_proj(desc).view(B, N,
                                                        self.d_context))
        ctx = ctx.reshape(B * N, self.d_context)
        outs = []
        for i, p in enumerate(levels):
            p = getattr(self, f"film_{i}")(p, ctx)
            cls, reg = getattr(self, f"head_{i}")(p)
            outs.append({"cls": cls.reshape(B, N, -1),
                         "reg": reg.reshape(B, N, -1, 2)})
        return outs

    @staticmethod
    def decode(outs: List[Dict[str, torch.Tensor]], signal_length: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each signal's best-scoring cell over every level -> (prob (B,
        N), (start, end) (B, N, 2)); ties go to the lowest index and to
        the earlier level, as with the reference's ``argmax`` and strict
        ``>``."""
        best_score = best_pos = None
        for out, stride in zip(outs, STRIDES):
            score, pos = decode_1d(out["cls"], out["reg"], stride,
                                   signal_length)
            idx = score.argmax(dim=-1)       # the first maximum, as jnp's
            top = torch.gather(score, -1, idx[..., None])[..., 0]
            top_pos = torch.gather(
                pos, -2, idx[..., None, None].expand(*idx.shape, 1, 2)
            )[..., 0, :]
            if best_score is None:
                best_score, best_pos = top, top_pos
            else:
                better = top > best_score
                best_score = torch.where(better, top, best_score)
                best_pos = torch.where(better[..., None], top_pos, best_pos)
        return best_score, best_pos

