"""Reusable 1-d conv building blocks of the signal models.

Counterpart of ``pautdx/nn/blocks.py``: conv + norm + ReLU stacks,
background extractors (a depthwise low-pass estimate subtracted from the
features), multi-scale and dilated parallel convolutions, residual blocks,
squeeze-excitation, RMSNorm, the dense ``MLP`` and the torch
``AdaptiveAvgPool1d`` bins.

Layout: the reference's sequence tensors are channels-last (N, L, C); the
blocks here take and return torch's channels-first (N, C, L), so a model
reshapes its (B, N, S) signals to (B*N, 1, S) and no block transposes.
Module and parameter names mirror the reference's parameter tree
(``Conv_0``, ``Norm1D_0.BatchNorm_0``, ``bg_k15``, ``branch_k3``, ...), so
``compat.jax_weights.load_jax_variables`` fills them leaf by leaf.

Convolutions pad as the JAX ``padding="SAME"`` does: for an output of
``ceil(L / stride)`` steps, the total padding ``(out - 1) * stride +
(k - 1) * dilation + 1 - L`` splits with its floor half before the
sequence and the rest after it, which is asymmetric for even kernels.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.models.vision.hgnet import BatchNorm

GN_EPS = 1e-6       # the reference's GroupNorm and LayerNorm default
LN_EPS = 1e-6
GN_GROUPS = 8       # the reference's most GroupNorm groups


def same_padding(length: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1) -> Tuple[int, int]:
    """(before, after) padding of the JAX ``"SAME"`` convolution."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (kernel_size - 1) * dilation + 1
                - length, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """``nn.Conv1d`` over (N, C, L) with the JAX ``"SAME"`` padding; the
    symmetric case goes through the convolution's own padding, the
    asymmetric one through ``F.pad``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1):
        super().__init__(in_features, features, kernel_size, stride=stride,
                         dilation=dilation, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        lo, hi = same_padding(x.shape[-1], self.kernel_size[0],
                              self.stride[0], self.dilation[0])
        if lo != hi:
            x = F.pad(x, (lo, hi))
            lo = 0
        return F.conv1d(x, self.weight, self.bias, self.stride, lo,
                        self.dilation, self.groups)


class Norm1D(nn.Module):
    """Switchable norm over the channels of (N, C, L): ``batch`` (the
    reference's BatchNorm: eps 1e-5, momentum 0.99, biased variance),
    ``group`` (at most 8 groups, the largest count that divides C),
    ``layer`` (per position over C) or ``none``; eps 1e-6 for the group
    and layer norms, as the reference's."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        self.kind = kind
        if kind == "batch":
            self.BatchNorm_0 = BatchNorm(features, eps=1e-5, momentum=0.99)
        elif kind == "group":
            g = min(GN_GROUPS, features)
            while features % g:
                g -= 1
            self.GroupNorm_0 = nn.GroupNorm(g, features, eps=GN_EPS)
        elif kind == "layer":
            self.LayerNorm_0 = nn.LayerNorm(features, eps=LN_EPS)
        elif kind != "none":
            raise ValueError(f"unknown norm kind {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "batch":
            return self.BatchNorm_0(x)
        if self.kind == "group":
            return self.GroupNorm_0(x)
        if self.kind == "layer":
            return self.LayerNorm_0(x.transpose(1, 2)).transpose(1, 2)
        return x


class ConvBlock1D(nn.Module):
    """Conv1d -> norm -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, norm: str = "batch"):
        super().__init__()
        self.Conv_0 = SameConv1d(in_features, features, kernel_size, stride,
                                 dilation)
        self.Norm1D_0 = Norm1D(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Norm1D_0(self.Conv_0(x)))


class ConvStack1D(nn.Module):
    """A sequence of ``ConvBlock1D`` and an optional trailing dropout."""

    def __init__(self, in_features: int, features: Sequence[int],
                 kernels: Sequence[int], norm: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.n = len(features)
        c = in_features
        for i, (f, k) in enumerate(zip(features, kernels)):
            self.add_module(f"ConvBlock1D_{i}", ConvBlock1D(c, f, k,
                                                            norm=norm))
            c = f
        self.drop = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"ConvBlock1D_{i}")(x)
        return self.drop(x)


class DepthwiseConv1D(nn.Module):
    """Depthwise (groups = channels) 1-d convolution over (N, C, L)."""

    def __init__(self, features: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.Conv_0 = SameConv1d(features, features, kernel_size,
                                 dilation=dilation, groups=features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class BackgroundExtractor(nn.Module):
    """Subtract a depthwise low-pass background estimate from the
    features: the mean of parallel convolutions, or, ``chained``, the
    convolutions in sequence with a norm between them."""

    def __init__(self, features: int, kernel_sizes: Tuple[int, ...] = (15,),
                 chained: bool = False, norm: str = "batch"):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.chained = chained
        for i, k in enumerate(self.kernel_sizes):
            self.add_module(f"bg_k{k}", DepthwiseConv1D(features, k))
            if chained and i < len(self.kernel_sizes) - 1:
                self.add_module(f"Norm1D_{i}", Norm1D(norm, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.chained:
            bg = x
            for i, k in enumerate(self.kernel_sizes):
                bg = getattr(self, f"bg_k{k}")(bg)
                if i < len(self.kernel_sizes) - 1:
                    bg = getattr(self, f"Norm1D_{i}")(bg)
            return x - bg
        bg = torch.zeros_like(x)
        for k in self.kernel_sizes:
            bg = bg + getattr(self, f"bg_k{k}")(x)
        return x - bg / len(self.kernel_sizes)


class MultiScaleConv1D(nn.Module):
    """Parallel ``ConvBlock1D`` of several kernel sizes, concatenated over
    the channels."""

    def __init__(self, in_features: int, features: int,
                 kernel_sizes: Sequence[int] = (3, 5, 7, 11),
                 norm: str = "batch"):
        super().__init__()
        self.names = [f"branch_k{k}" for k in kernel_sizes]
        for name, k in zip(self.names, kernel_sizes):
            self.add_module(name, ConvBlock1D(in_features, features, k,
                                              norm=norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, n)(x) for n in self.names], dim=1)


class DilatedBranches1D(nn.Module):
    """Parallel dilated ``ConvBlock1D`` (d = 1, 2, 4, 8), concatenated."""

    def __init__(self, in_features: int, features: int,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 kernel_size: int = 3, norm: str = "batch"):
        super().__init__()
        self.names = [f"dil_{d}" for d in dilations]
        for name, d in zip(self.names, dilations):
            self.add_module(name, ConvBlock1D(in_features, features,
                                              kernel_size, dilation=d,
                                              norm=norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, n)(x) for n in self.names], dim=1)


class ResidualBlock1D(nn.Module):
    """relu(x + norm(conv(ConvBlock1D(x)))), x projected by a 1-wide conv
    where its width differs."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dilation: int = 1, norm: str = "batch"):
        super().__init__()
        self.ConvBlock1D_0 = ConvBlock1D(in_features, features, kernel_size,
                                         dilation=dilation, norm=norm)
        self.Conv_0 = SameConv1d(features, features, kernel_size,
                                 dilation=dilation)
        self.Norm1D_0 = Norm1D(norm, features)
        self.Conv_1 = (SameConv1d(in_features, features, 1)
                       if in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Norm1D_0(self.Conv_0(self.ConvBlock1D_0(x)))
        if self.Conv_1 is not None:
            x = self.Conv_1(x)
        return F.relu(x + h)


class SqueezeExcite1D(nn.Module):
    """Channel gating of (N, C, L) by a two-layer MLP over the mean over
    L."""

    def __init__(self, features: int, reduction: int = 4):
        super().__init__()
        self.Dense_0 = nn.Linear(features, max(1, features // reduction))
        self.Dense_1 = nn.Linear(max(1, features // reduction), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Dense_0(x.mean(dim=-1)))
        return x * torch.sigmoid(self.Dense_1(s)).unsqueeze(-1)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the channels of (N, C, L) with a learned
    ``scale``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ms = x.square().mean(dim=1, keepdim=True)
        return x * torch.rsqrt(ms + self.eps) * self.scale[:, None]


class MLP(nn.Module):
    """Dense stack over the last axis, ReLU and dropout between layers,
    ``final_act`` after the last."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dropout: float = 0.0,
                 final_act: Optional[Callable] = None):
        super().__init__()
        self.n = len(features)
        c = in_features
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(c, f))
            c = f
        self.drop = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1:
                x = self.drop(F.relu(x))
        return x if self.final_act is None else self.final_act(x)


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., C, L) -> (..., C, out_len): output bin i averages input
    [floor(i*L/out), ceil((i+1)*L/out)), the bins the reference builds by
    hand (non-uniform, 2-3 wide, at L = 320 and 360 for 128 bins)."""
    lead = x.shape[:-1]
    return F.adaptive_avg_pool1d(x.reshape(-1, 1, x.shape[-1]),
                                 out_len).view(*lead, out_len)
