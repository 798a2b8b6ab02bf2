"""Frozen plain-PyTorch copy of the port's ``models/vision/yolo.py`` for the
benchmark's reference: every kernel call replaced by its plain math
(``common.py``), nothing of the program imported.

YOLO detector/segmenter: the v8, v5u, v9c and v11 flavours, det and seg,
at inference and in training (``losses/yolo.py`` is the criterion).

Counterpart of ``pautdx/models/vision/yolo.py``. Module paths mirror the
JAX module tree (``backbone.c1.m.0.cv1.conv``, ``head.cv2.0.2``,
``proto.upsample``, ``mask_head.cv4.1.0``), so ``<path>.kernel`` there is
``<path>.weight`` here (see ``pautdx_torch.compat.jax_weights``); inside a
layer the names are Ultralytics' own (``pautdx_torch.compat.yolo_import``
loads their state dicts). Public functions take and return NHWC tensors
like the reference; inside, convolutions run NCHW on the same memory (an
NHWC tensor permuted to NCHW is ``channels_last``).

Ported: ``YoloConfig`` whole, ``ConvBnSiLU`` (float path, with ``act`` and
``groups``), ``Bottleneck``, ``C2f``, ``C3``, ``SPPF``, the GELAN blocks
(``RepConvN``, ``RepNBottleneck``, ``RepNCSP``, ``RepNCSPELAN4``,
``ADown``, ``SPPELAN``), the v11 blocks (``C3k``, ``C3k2``,
``PSAAttention``, ``PSABlock``, ``C2PSA``), the ``Backbone`` and ``Neck``
of all four flavours, ``DetectHead`` (with v11's DWConv cls branch),
``ProtoNet``, ``MaskCoeffHead``, ``YOLO``, ``anchor_points``,
``dfl_expectation`` and ``decode_boxes``. An unknown flavour raises
``ValueError``. The mask decode is
``pautdx_torch.ops.masks.assemble_masks``; ``ConvBnSiLU``'s int8 serving
branch is ``ops.qconv``'s (``serve.quantize`` calibrates it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Int8Site, init_params, resolve_device

STRIDES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 1
    scale: str = "n"                 # n | s | m
    flavour: str = "v8"              # v8 (C2f) | v5 (C3, v5u layout)
    #                                | v9c (GELAN) | v11 (C3k2+C2PSA)
    reg_max: int = 16                # DFL bins
    num_protos: int = 32             # seg mask coefficients (nm)
    seg: bool = False

    @property
    def depth_mult(self) -> float:
        if self.flavour == "v9c":
            return 1.0               # yolov9c.yaml: unscaled
        if self.flavour == "v11":
            return 0.5               # yolo11.yaml scales: all 0.50
        return {"n": 1 / 3, "s": 1 / 3, "m": 2 / 3}[self.scale]

    @property
    def width_mult(self) -> float:
        if self.flavour == "v9c":
            return 1.0
        if self.flavour == "v11":
            return {"n": 0.25, "s": 0.5, "m": 1.0}[self.scale]
        return {"n": 0.25, "s": 0.5, "m": 0.75}[self.scale]

    @property
    def max_channels(self) -> int:
        """Ultralytics per-scale max_channels clamp (yolov8/yolo11 yaml)."""
        if self.flavour == "v9c":
            return 1024
        if self.flavour == "v11":
            return {"n": 1024, "s": 1024, "m": 512}[self.scale]
        return {"n": 1024, "s": 1024, "m": 768}[self.scale]

    @property
    def stage_depths(self) -> Tuple[int, int, int, int]:
        # yolov8.yaml: (3, 6, 6, 3); yolov5.yaml: (3, 6, 9, 3);
        # yolo11.yaml: (2, 2, 2, 2)
        if self.flavour == "v11":
            return (2, 2, 2, 2)
        return (3, 6, 6, 3) if self.flavour == "v8" else (3, 6, 9, 3)

    @property
    def c3k(self) -> bool:
        """v11: C3k inner blocks everywhere at m+ scales."""
        return self.scale in ("m", "l", "x")

    def width(self, w: int) -> int:
        # make_divisible(min(w, max_channels) * width_mult, 8)
        return max(8, math.ceil(
            min(w, self.max_channels) * self.width_mult / 8) * 8)

    def depth(self, d: int) -> int:
        return max(1, round(d * self.depth_mult))

    @property
    def proto_channels(self) -> int:
        """Ultralytics Segment npr = 256 * width."""
        return self.width(256)


FLAVOURS = ("v8", "v5", "v9c", "v11")


class ConvBnSiLU(Int8Site):
    """Ultralytics ``Conv``: conv (no bias) + BN (eps 1e-3, momentum 0.97 as
    ``pautdx/models/vision/yolo.py:149`` sets it) + SiLU; padding
    (k-1)//2 unless given. ``act=False`` gives the activation-free form
    (``RepConvN``'s branches, the PSA's qkv/proj/pe), ``groups=features``
    gives ``DWConv``. An int8 site (``ops.qconv.Int8Site``): with a scale
    set, in eval mode, the convolution runs s8 x s8 -> s32."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1,
                 stride: int = 1, padding: Optional[int] = None,
                 act: bool = True, groups: int = 1):
        super().__init__()
        p = (kernel - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, features, kernel, stride, p,
                              groups=groups, bias=False)
        self.bn = BatchNorm(features, eps=1e-3, momentum=0.97)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.site_conv(self.conv, x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two convs, residual when the widths match: C2f's (3, 3), C3's
    (1, 3) with ``kernel1=1``, C3k2's plain form with ``e=0.5``."""

    def __init__(self, in_channels: int, features: int,
                 shortcut: bool = True, kernel1: int = 3, e: float = 1.0):
        super().__init__()
        c_ = max(1, int(features * e))
        self.cv1 = ConvBnSiLU(in_channels, c_, kernel1)
        self.cv2 = ConvBnSiLU(c_, features, 3)
        self.add = shortcut and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cv2(self.cv1(x))
        return x + h if self.add else h


class C2f(nn.Module):
    """v8 cross-stage partial with dense skip concatenation."""

    def __init__(self, in_channels: int, features: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c = features // 2
        self.cv1 = ConvBnSiLU(in_channels, 2 * c, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut) for _ in range(n))
        self.cv2 = ConvBnSiLU((2 + n) * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.cv1(x).chunk(2, dim=1))
        for block in self.m:
            parts.append(block(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class _CSP(nn.Module):
    """The C3 layout: ``m`` over ``cv1(x)``, concatenated with ``cv2(x)``,
    then ``cv3``. Subclasses fill ``m``."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        c = features // 2
        self.cv1 = ConvBnSiLU(in_channels, c, 1)
        self.cv2 = ConvBnSiLU(in_channels, c, 1)
        self.cv3 = ConvBnSiLU(2 * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for block in self.m:
            a = block(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class C3(_CSP):
    """v5 CSP block: Bottlenecks of kernels (1, 3)."""

    def __init__(self, in_channels: int, features: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__(in_channels, features)
        c = features // 2
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, kernel1=1)
                               for _ in range(n))


class SPPF(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        c = in_channels // 2
        self.cv1 = ConvBnSiLU(in_channels, c, 1)
        self.cv2 = ConvBnSiLU(4 * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(_pool_chain(self.cv1(x)))


def _pool_chain(x: torch.Tensor) -> torch.Tensor:
    """``x`` and three chained 5x5 stride-1 SAME max-pools of it (-inf
    padding, as ``nn.max_pool`` pads), concatenated on channels."""
    pools = [x]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return torch.cat(pools, dim=1)


# --- v9 (GELAN) blocks -----------------------------------------------------


class RepConvN(nn.Module):
    """Ultralytics ``RepConvN`` in its train (unfused) form, as pretrained
    ``.pt`` files ship it: 3x3 conv+BN plus 1x1 conv+BN, summed, SiLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = ConvBnSiLU(in_channels, features, 3, act=False)
        self.conv2 = ConvBnSiLU(in_channels, features, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x))


class RepNBottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 shortcut: bool = True):
        super().__init__()
        self.cv1 = RepConvN(in_channels, features)
        self.cv2 = ConvBnSiLU(features, features, 3)
        self.add = shortcut and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cv2(self.cv1(x))
        return x + h if self.add else h


class RepNCSP(_CSP):
    """CSP over RepNBottlenecks (the C3 layout with Rep blocks)."""

    def __init__(self, in_channels: int, features: int, n: int = 1):
        super().__init__(in_channels, features)
        c = features // 2
        self.m = nn.ModuleList(RepNBottleneck(c, c) for _ in range(n))


class RepNCSPELAN4(nn.Module):
    """GELAN unit: split, two sequential RepNCSP+Conv branches, dense
    concat. ``cv2``/``cv3`` are Ultralytics' ``Sequential(RepNCSP, Conv)``
    (paths ``cv2.0.*``, ``cv2.1.*``)."""

    def __init__(self, in_channels: int, features: int, mid: int,
                 branch: int, n: int = 1):
        super().__init__()
        self.cv1 = ConvBnSiLU(in_channels, mid, 1)
        self.cv2 = nn.Sequential(RepNCSP(mid // 2, branch, n),
                                 ConvBnSiLU(branch, branch, 3))
        self.cv3 = nn.Sequential(RepNCSP(branch, branch, n),
                                 ConvBnSiLU(branch, branch, 3))
        self.cv4 = ConvBnSiLU(mid + 2 * branch, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, dim=1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, dim=1))


class ADown(nn.Module):
    """v9 downsampler: 2x2 stride-1 VALID avg-pool, split; a 3x3/s2 conv
    on one half, a 3x3/s2 max-pool (padding 1, -inf) and a 1x1 conv on
    the other."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        c = features // 2
        self.cv1 = ConvBnSiLU(in_channels // 2, c, 3, 2)
        self.cv2 = ConvBnSiLU(in_channels // 2, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = F.avg_pool2d(x, 2, 1).chunk(2, dim=1)
        return torch.cat([self.cv1(x1),
                          self.cv2(F.max_pool2d(x2, 3, 2, 1))], dim=1)


class SPPELAN(nn.Module):
    """v9 SPP: 1x1 in, three chained 5x5 max-pools, concat, 1x1 out."""

    def __init__(self, in_channels: int, features: int, mid: int):
        super().__init__()
        self.cv1 = ConvBnSiLU(in_channels, mid, 1)
        self.cv5 = ConvBnSiLU(4 * mid, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv5(_pool_chain(self.cv1(x)))


# --- v11 blocks ------------------------------------------------------------


class C3k(_CSP):
    """C3 with 3x3-kernel bottlenecks (v11 inner block)."""

    def __init__(self, in_channels: int, features: int, n: int = 2,
                 shortcut: bool = True):
        super().__init__(in_channels, features)
        c = features // 2
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut) for _ in range(n))


class C3k2(nn.Module):
    """v11 cross-stage partial: the C2f layout whose inner blocks are
    plain Bottlenecks (e=0.5, k=3) or, with ``c3k``, C3k units."""

    def __init__(self, in_channels: int, features: int, n: int = 1,
                 c3k: bool = False, e: float = 0.5, shortcut: bool = True):
        super().__init__()
        c = max(1, int(features * e))
        self.cv1 = ConvBnSiLU(in_channels, 2 * c, 1)
        self.m = nn.ModuleList(
            C3k(c, c, 2, shortcut) if c3k
            else Bottleneck(c, c, shortcut, e=0.5) for _ in range(n))
        self.cv2 = ConvBnSiLU((2 + n) * c, features, 1)

    forward = C2f.forward


class PSAAttention(nn.Module):
    """v11 ``Attention``: per-head q, k, v from a 1x1 conv, softmax
    attention over the spatial axis, plus a depthwise 3x3 positional
    branch on v. The qkv channels lie head-major, q, k and v inside each
    head. Plain matmuls: the reference computes it with ``einsum``,
    outside any kernel."""

    def __init__(self, channels: int, num_heads: int,
                 attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.key_dim = max(1, int(self.head_dim * attn_ratio))
        h = channels + 2 * self.key_dim * num_heads
        self.qkv = ConvBnSiLU(channels, h, 1, act=False)
        self.pe = ConvBnSiLU(channels, channels, 3, act=False,
                             groups=channels)
        self.proj = ConvBnSiLU(channels, channels, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        kd = self.key_dim
        q, k, v = self.qkv(x).reshape(
            B, self.num_heads, 2 * kd + self.head_dim, H * W).split(
            [kd, kd, self.head_dim], dim=2)
        attn = torch.softmax((q.transpose(-2, -1) @ k) * kd ** -0.5, dim=-1)
        v_img = v.reshape(B, C, H, W)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v_img))


class PSABlock(nn.Module):
    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.attn = PSAAttention(channels, num_heads)
        self.ffn = nn.Sequential(
            ConvBnSiLU(channels, 2 * channels, 1),
            ConvBnSiLU(2 * channels, channels, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """v11 partial self-attention stage (after SPPF): PSA blocks of
    max(1, c // 64) heads on one half of the split."""

    def __init__(self, in_channels: int, features: int, n: int = 1):
        super().__init__()
        c = features // 2
        self.cv1 = ConvBnSiLU(in_channels, 2 * c, 1)
        self.m = nn.ModuleList(PSABlock(c, max(1, c // 64))
                               for _ in range(n))
        self.cv2 = ConvBnSiLU(2 * c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, dim=1)
        for block in self.m:
            b = block(b)
        return self.cv2(torch.cat([a, b], dim=1))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW map (each pixel repeated 2x2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Backbone(nn.Module):
    """stem, down1, c1, down2, c2 (P3), down3, c3 (P4), down4, c4, sppf
    and, for v11, psa (P5). ``channels`` are the widths of P3-P5."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        w, d = cfg.width, cfg.depth
        d1, d2, d3, d4 = cfg.stage_depths
        self.psa = nn.Identity()
        if cfg.flavour == "v9c":
            # yolov9c.yaml: unscaled widths, GELAN stages, ADown
            self.stem = ConvBnSiLU(3, 64, 3, 2)                        # /2
            self.down1 = ConvBnSiLU(64, 128, 3, 2)                     # /4
            self.c1 = RepNCSPELAN4(128, 256, 128, 64)
            self.down2 = ADown(256, 256)                               # /8
            self.c2 = RepNCSPELAN4(256, 512, 256, 128)
            self.down3 = ADown(512, 512)                               # /16
            self.c3 = RepNCSPELAN4(512, 512, 512, 256)
            self.down4 = ADown(512, 512)                               # /32
            self.c4 = RepNCSPELAN4(512, 512, 512, 256)
            self.sppf = SPPELAN(512, 512, 256)
            self.channels = (512, 512, 512)
            return
        if cfg.flavour == "v5":
            # yolov5.yaml: 6x6 stride-2 pad-2 stem
            self.stem = ConvBnSiLU(3, w(64), 6, 2, padding=2)          # /2
        else:
            self.stem = ConvBnSiLU(3, w(64), 3, 2)                     # /2
        self.down1 = ConvBnSiLU(w(64), w(128), 3, 2)                   # /4
        if cfg.flavour == "v11":
            c3k = cfg.c3k
            self.c1 = C3k2(w(128), w(256), d(d1), c3k, 0.25)
            self.down2 = ConvBnSiLU(w(256), w(256), 3, 2)              # /8
            self.c2 = C3k2(w(256), w(512), d(d2), c3k, 0.25)
            self.down3 = ConvBnSiLU(w(512), w(512), 3, 2)              # /16
            self.c3 = C3k2(w(512), w(512), d(d3), True)
            self.down4 = ConvBnSiLU(w(512), w(1024), 3, 2)             # /32
            self.c4 = C3k2(w(1024), w(1024), d(d4), True)
            self.sppf = SPPF(w(1024), w(1024))
            self.psa = C2PSA(w(1024), w(1024), d(2))
            self.channels = (w(512), w(512), w(1024))
            return
        block = C2f if cfg.flavour == "v8" else C3
        self.c1 = block(w(128), w(128), d(d1))
        self.down2 = ConvBnSiLU(w(128), w(256), 3, 2)                  # /8
        self.c2 = block(w(256), w(256), d(d2))
        self.down3 = ConvBnSiLU(w(256), w(512), 3, 2)                  # /16
        self.c3 = block(w(512), w(512), d(d3))
        self.down4 = ConvBnSiLU(w(512), w(1024), 3, 2)                 # /32
        self.c4 = block(w(1024), w(1024), d(d4))
        self.sppf = SPPF(w(1024), w(1024))
        self.channels = (w(256), w(512), w(1024))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.c1(self.down1(self.stem(x)))
        p3 = self.c2(self.down2(x))
        p4 = self.c3(self.down3(p3))
        p5 = self.psa(self.sppf(self.c4(self.down4(p4))))
        return p3, p4, p5


class Neck(nn.Module):
    """PAN: concat(upsample, skip) top-down, then concat(downsample,
    lateral) bottom-up. The v5u layout adds yolov5.yaml's lateral 1x1
    convs ``lat5``/``lat4``, whose outputs also feed the bottom-up
    concats; elsewhere the laterals are the maps themselves. ``channels``
    are the widths of the three outputs."""

    def __init__(self, cfg: YoloConfig, channels: Sequence[int]):
        super().__init__()
        w, d = cfg.width, cfg.depth
        p3c, p4c, p5c = channels
        self.lat5 = self.lat4 = nn.Identity()
        if cfg.flavour == "v9c":
            self.td4 = RepNCSPELAN4(p5c + p4c, 512, 512, 256)
            self.td3 = RepNCSPELAN4(512 + p3c, 256, 256, 128)
            self.d3 = ADown(256, 256)
            self.bu4 = RepNCSPELAN4(256 + 512, 512, 512, 256)
            self.d4 = ADown(512, 512)
            self.bu5 = RepNCSPELAN4(512 + p5c, 512, 512, 256)
            self.channels = (256, 512, 512)
            return
        if cfg.flavour == "v11":
            c3k = cfg.c3k
            self.td4 = C3k2(p5c + p4c, w(512), d(2), c3k)
            self.td3 = C3k2(w(512) + p3c, w(256), d(2), c3k)
            self.d3 = ConvBnSiLU(w(256), w(256), 3, 2)
            self.bu4 = C3k2(w(256) + w(512), w(512), d(2), c3k)
            self.d4 = ConvBnSiLU(w(512), w(512), 3, 2)
            self.bu5 = C3k2(w(512) + p5c, w(1024), d(2), True)
            self.channels = (w(256), w(512), w(1024))
            return
        block = C2f if cfg.flavour == "v8" else C3
        l5c, l4c = p5c, w(512)
        if cfg.flavour == "v5":
            self.lat5 = ConvBnSiLU(p5c, w(512), 1)
            l5c = w(512)
        self.td4 = block(l5c + p4c, w(512), d(3), shortcut=False)
        if cfg.flavour == "v5":
            self.lat4 = ConvBnSiLU(w(512), w(256), 1)
            l4c = w(256)
        self.td3 = block(l4c + p3c, w(256), d(3), shortcut=False)
        self.d3 = ConvBnSiLU(w(256), w(256), 3, 2)
        self.bu4 = block(w(256) + l4c, w(512), d(3), shortcut=False)
        self.d4 = ConvBnSiLU(w(512), w(512), 3, 2)
        self.bu5 = block(w(512) + l5c, w(1024), d(3), shortcut=False)
        self.channels = (w(256), w(512), w(1024))

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        p3, p4, p5 = feats
        l5 = self.lat5(p5)
        h4 = self.td4(torch.cat([_upsample2x(l5), p4], dim=1))
        l4 = self.lat4(h4)
        h3 = self.td3(torch.cat([_upsample2x(l4), p3], dim=1))
        n4 = self.bu4(torch.cat([self.d3(h3), l4], dim=1))
        n5 = self.bu5(torch.cat([self.d4(n4), l5], dim=1))
        return h3, n4, n5


def _branch(cin: int, mid: int, out: int) -> nn.ModuleList:
    """conv3 -> conv3 -> plain 1x1 conv with bias (``cv2.i``, ``cv3.i``,
    ``cv4.i`` of the Ultralytics heads)."""
    return nn.ModuleList([ConvBnSiLU(cin, mid, 3), ConvBnSiLU(mid, mid, 3),
                          nn.Conv2d(mid, out, 1)])


def _run(branch: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in branch:
        x = layer(x)
    return x


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DetectHead(nn.Module):
    """Decoupled anchor-free head (Ultralytics ``Detect`` widths, from the
    P3 channel count, shared by all levels): per level a dict of NHWC
    ``box`` (4 * reg_max DFL logits) and ``cls`` logits."""

    def __init__(self, cfg: YoloConfig, channels: Sequence[int]):
        super().__init__()
        c2 = max(16, channels[0] // 4, 4 * cfg.reg_max)
        c3 = max(channels[0], min(cfg.num_classes, 100))
        self.cv2 = nn.ModuleList(_branch(c, c2, 4 * cfg.reg_max)
                                 for c in channels)
        if cfg.flavour == "v11":
            # Detect(legacy=False): DWConv + 1x1 pairs in the cls branch
            self.cv3 = nn.ModuleList(nn.ModuleList([
                nn.Sequential(ConvBnSiLU(c, c, 3, groups=c),
                              ConvBnSiLU(c, c3, 1)),
                nn.Sequential(ConvBnSiLU(c3, c3, 3, groups=c3),
                              ConvBnSiLU(c3, c3, 1)),
                nn.Conv2d(c3, cfg.num_classes, 1)]) for c in channels)
        else:
            self.cv3 = nn.ModuleList(_branch(c, c3, cfg.num_classes)
                                     for c in channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[Dict]:
        return [{"box": _nhwc(_run(bb, f)), "cls": _nhwc(_run(cb, f))}
                for f, bb, cb in zip(feats, self.cv2, self.cv3)]


class ProtoNet(nn.Module):
    """Ultralytics ``Proto``: conv3 -> learned 2x2/s2 transposed-conv
    upsample -> conv3 -> 1x1 Conv to num_protos."""

    def __init__(self, cfg: YoloConfig, in_channels: int):
        super().__init__()
        c_ = cfg.proto_channels
        self.cv1 = ConvBnSiLU(in_channels, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2)
        self.cv2 = ConvBnSiLU(c_, c_, 3)
        self.cv3 = ConvBnSiLU(c_, cfg.num_protos, 1)

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(p3))))


class MaskCoeffHead(nn.Module):
    """Ultralytics ``Segment.cv4``: per-level 3-layer coefficient branch."""

    def __init__(self, cfg: YoloConfig, channels: Sequence[int]):
        super().__init__()
        c4 = max(channels[0] // 4, cfg.num_protos)
        self.cv4 = nn.ModuleList(_branch(c, c4, cfg.num_protos)
                                 for c in channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [_nhwc(_run(b, f)) for f, b in zip(feats, self.cv4)]


class YOLO(nn.Module):
    """Full detector. ``forward(images)`` takes NHWC float
    images (B, H, W, 3), H and W multiples of 32, and returns
    ``{"levels": [{"box", "cls"}, ...]}`` at (B, h, w, C) per stride, plus
    with ``seg`` ``"protos"`` (B, H/4, W/4, P) and ``"mask_coeffs"``, one
    (B, h, w, P) per level."""

    def __init__(self, cfg: YoloConfig = YoloConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if cfg.flavour not in FLAVOURS:
            raise ValueError(f"YOLO flavour {cfg.flavour!r} is unknown; "
                             f"known: {', '.join(FLAVOURS)}")
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.backbone = Backbone(cfg)
            self.neck = Neck(cfg, self.backbone.channels)
            channels = self.neck.channels
            self.head = DetectHead(cfg, channels)
            if cfg.seg:
                self.proto = ProtoNet(cfg, channels[0])
                self.mask_head = MaskCoeffHead(cfg, channels)
        init_params(self, seed)
        self.to(dtype)
        self.eval()

    def forward(self, images: torch.Tensor,
                train: Optional[bool] = None) -> Dict:
        """The module's mode (``model.train()`` / ``model.eval()``) decides
        whether BatchNorm normalises with the batch's statistics and
        updates its running ones; ``train``, where given, sets that mode
        first, as the reference's ``__call__(images, train)`` does per
        call. Gradients flow unless the caller turns them off."""
        if train is not None and train != self.training:
            self.train(train)
        H, W = images.shape[1:3]
        if H % 32 or W % 32:
            # the PAN neck's 2x upsample + skip concat needs exact doubling
            # between levels (Ultralytics check_imgsz rounds for the same
            # reason)
            raise ValueError(
                f"YOLO input size ({H}, {W}) must be a multiple of 32 "
                f"(pad or resize; see Ultralytics check_imgsz)")
        feats = self.backbone(images.permute(0, 3, 1, 2))
        neck = self.neck(feats)
        result = {"levels": self.head(neck)}
        if self.cfg.seg:
            result["protos"] = _nhwc(self.proto(neck[0]))
            result["mask_coeffs"] = self.mask_head(neck)
        return result


# ---------------------------------------------------------------------------
# decoding


def anchor_points(img_size: Tuple[int, int],
                  level_hw: Optional[Sequence[Tuple[int, int]]] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All anchor centers (x, y) in pixels and the stride of each, over the
    levels of ``STRIDES`` in (h, w) row-major order: (A, 2), (A,).
    ``level_hw`` gives each level's actual feature-map size."""
    device = resolve_device(device)
    pts, strs = [], []
    H, W = img_size
    for i, s in enumerate(STRIDES):
        h, w = level_hw[i] if level_hw is not None else (H // s, W // s)
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([grid_x.reshape(-1), grid_y.reshape(-1)], -1))
        strs.append(torch.full((h * w,), float(s), dtype=torch.float32,
                               device=device))
    return torch.cat(pts), torch.cat(strs)


def dfl_expectation(box_dist: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4*reg_max) logits, laid out (4, reg_max) -> (..., 4) expected
    ltrb distances; the softmax is taken in float32, or float64 for float64
    logits."""
    d = box_dist.to(torch.promote_types(box_dist.dtype, torch.float32))
    d = d.reshape(box_dist.shape[:-1] + (4, reg_max))
    p = torch.softmax(d, dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=d.device)
    return (p * bins).sum(-1)


def decode_boxes(result: Dict, img_size: Tuple[int, int], cfg: YoloConfig
                 ) -> Dict[str, torch.Tensor]:
    """Dense decode: per-anchor xyxy boxes in image pixels and class
    probabilities, plus mask coefficients with ``seg``:
    {"boxes" (B, A, 4), "scores" (B, A, nc), "anchor_points" (A, 2),
    "anchor_strides" (A,)[, "coeffs" (B, A, P)]}."""
    levels = result["levels"]
    pts, strs = anchor_points(
        img_size, level_hw=[tuple(lvl["box"].shape[1:3]) for lvl in levels],
        device=levels[0]["box"].device)
    boxes, scores, coeffs = [], [], []
    for i, lvl in enumerate(levels):
        B, H, W, _ = lvl["box"].shape
        boxes.append(dfl_expectation(lvl["box"].reshape(B, H * W, -1),
                                     cfg.reg_max))
        scores.append(torch.sigmoid(lvl["cls"].reshape(B, H * W, -1)))
        if cfg.seg:
            coeffs.append(result["mask_coeffs"][i].reshape(B, H * W, -1))
    ltrb = torch.cat(boxes, dim=1) * strs[None, :, None]
    out = {"boxes": torch.cat([pts[None] - ltrb[..., :2],
                               pts[None] + ltrb[..., 2:]], dim=-1),
           "scores": torch.cat(scores, dim=1),
           "anchor_points": pts, "anchor_strides": strs}
    if cfg.seg:
        out["coeffs"] = torch.cat(coeffs, dim=1)
    return out
