"""HGNetV2 backbone, the D-FINE conv encoder.

Counterpart of ``pautdx/models/vision/hgnet.py``. Module paths mirror it,
so ``<path>.kernel`` there is ``<path>.weight`` here (see
``pautdx_torch.compat.jax_weights``). Public functions take and return NHWC
tensors like the reference; inside, convolutions run NCHW on the same
memory (an NHWC tensor permuted to NCHW is ``channels_last``, so the
permutes copy nothing).

Ported whole: the HF dual-path ``Embeddings`` stem (``stem="hgnet"``),
the ``patchify``/``patchify8`` stems (conv or space-to-depth, with either
``stem_s2d_impl``, including the pre-patchified uint8 wire format),
``Stage``, ``BasicLayer``, ``ConvLayer(Light)`` and ``LearnableAffine``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import resolve_device
from pautdx_torch.ops.qconv import Int8Site


@dataclasses.dataclass(frozen=True)
class HGNetConfig:
    stem_channels: Tuple[int, int, int] = (3, 16, 16)
    stage_in_channels: Tuple[int, ...] = (16, 64, 128, 256)
    stage_mid_channels: Tuple[int, ...] = (16, 32, 64, 128)
    stage_out_channels: Tuple[int, ...] = (64, 128, 256, 512)
    stage_num_blocks: Tuple[int, ...] = (1, 1, 2, 1)
    stage_num_layers: Tuple[int, ...] = (3, 3, 3, 3)
    stage_downsample: Tuple[bool, ...] = (False, True, True, True)
    stage_light_block: Tuple[bool, ...] = (False, False, True, True)
    stage_kernel_size: Tuple[int, ...] = (3, 3, 5, 5)
    use_learnable_affine_block: bool = True
    out_indices: Tuple[int, ...] = (1, 2, 3)
    # "hgnet" (HF dual-path stem) | "patchify" (k4/s4) | "patchify8"
    # (one conv straight to the input stride of ``start_stage``)
    stem: str = "hgnet"
    # patchify stems: the patch conv as space-to-depth + matmul
    stem_s2d: bool = False
    # kept for config round trips with the reference; a serving-graph
    # option of XLA that has no effect here
    stem_u8_materialize: bool = False
    stem_s2d_impl: str = "transpose"
    # the input arrives already patchified, (B, H/p, W/p, p*p*C)
    stem_pre_patchified: bool = False
    start_stage: int = 0

    @property
    def out_channels(self) -> List[int]:
        return [self.stage_out_channels[i] for i in self.out_indices]

    @property
    def stem_patch(self) -> int:
        """Patch size of the patchify stems: 4, doubled per downsampling
        stage that ``patchify8`` skips (``hgnet.py:366-369``)."""
        patch = 4
        if self.stem == "patchify8":
            for i in range(self.start_stage):
                if self.stage_downsample[i]:
                    patch *= 2
        return patch

    def __post_init__(self):
        if any(i < self.start_stage for i in self.out_indices):
            raise ValueError(
                f"out_indices {self.out_indices} select stages below "
                f"start_stage={self.start_stage}, which are skipped by the "
                f"'{self.stem}' stem and would yield no feature map")
        if self.stem_pre_patchified and not self.stem_s2d:
            raise ValueError(
                "stem_pre_patchified is a wire-format option of the "
                "space-to-depth stem (stem_s2d=True); the nn.Conv stem "
                "consumes images, not patch slabs")
        if self.stem_pre_patchified and self.stem not in ("patchify",
                                                          "patchify8"):
            raise ValueError(
                f"stem_pre_patchified needs a patchify stem, got "
                f"'{self.stem}'")
        if self.start_stage > 0 and self.stem != "patchify8":
            raise ValueError(
                f"start_stage={self.start_stage} requires stem='patchify8' "
                f"(got '{self.stem}': its output feeds stage 0)")


@torch.no_grad()
def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init from a ``torch.Generator`` on the parameters' device:
    every weight of rank >= 2 ~ N(0, 1/fan_in) (the scale of the
    reference's LeCun-normal init), every 1-d weight or scale 1, every
    bias 0 (a GRU's ``bias_ih_l0``/``bias_hh_l0`` too)."""
    gen = None
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        elif name.rpartition(".")[2].startswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module


BN_MOMENTUM = 0.99   # the JAX BatchNorm's default, which D-FINE's keep; the
#                      YOLO ``ConvBnSiLU`` sets 0.97 (Ultralytics' 0.03)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with the reference's semantics (its BatchNorm,
    eps 1e-5 by default as in ``pautdx/models/vision/hgnet.py:156``, and
    ``momentum`` ``BN_MOMENTUM`` by default), switched by
    ``module.train()`` alone:

    - eval: normalise with the running statistics;
    - train: normalise with the batch's mean and biased variance over
      every dim but 1, in f32, and update the running statistics as
      ``r = m * r + (1 - m) * batch`` (m = ``momentum``), with the
      BIASED variance.

    ``nn.BatchNorm2d`` differs on two counts: its ``momentum`` is the
    weight of the batch (1 - m here), and it updates the running
    variance with the unbiased one. Unlike it, this module has no
    ``num_batches_tracked`` buffer, which no JAX leaf would fill."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # F.batch_norm folds the UNBIASED batch variance u = v * n / (n-1)
        # into the running one: r' = (1 - m) r + m u. Running it on
        # r * n / (n-1) and scaling the result by (n-1) / n lands on the
        # reference's (1 - m) r + m v, in two C-element passes instead of
        # another reduction over x. The scaled copy is autograd's to keep.
        scaled = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, scaled, self.weight,
                           self.bias, True, 1.0 - self.momentum, self.eps)
        torch.mul(scaled.detach(), (n - 1) / n, out=self.running_var)
        return out


class LearnableAffine(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x + self.bias


class ConvLayer(Int8Site):
    """conv (no bias, symmetric (k-1)//2 padding) + BN + act (+ affine);
    an int8 site (``ops.qconv.Int8Site``): with a scale set, in eval mode,
    the convolution runs s8 x s8 -> s32."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, groups: int = 1, act: bool = True,
                 lab: bool = False):
        super().__init__()
        self.convolution = nn.Conv2d(in_channels, features, kernel, stride,
                                     padding=(kernel - 1) // 2,
                                     groups=groups, bias=False)
        self.normalization = BatchNorm(features)
        self.act = act
        self.lab = LearnableAffine() if act and lab else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalization(self.site_conv(self.convolution, x))
        if self.act:
            x = F.relu(x)
            if self.lab is not None:
                x = self.lab(x)
        return x


class ConvLayerLight(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int,
                 lab: bool = False):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, features, 1, act=False)
        self.conv2 = ConvLayer(features, features, kernel, groups=features,
                               lab=lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class BasicLayer(nn.Module):
    def __init__(self, in_channels: int, mid: int, out: int, num_layers: int,
                 kernel: int, light: bool, residual: bool, lab: bool):
        super().__init__()
        layer = ConvLayerLight if light else ConvLayer
        self.layers = nn.ModuleList(
            layer(in_channels if i == 0 else mid, mid, kernel, lab=lab)
            for i in range(num_layers))
        total = in_channels + num_layers * mid
        self.aggregation = nn.ModuleList([
            ConvLayer(total, out // 2, 1, lab=lab),
            ConvLayer(out // 2, out, 1, lab=lab)])
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        h = x
        for layer in self.layers:
            h = layer(h)
            outs.append(h)
        h = torch.cat(outs, dim=1)
        for agg in self.aggregation:
            h = agg(h)
        return h + x if self.residual else h


class Stage(nn.Module):
    def __init__(self, cfg: HGNetConfig, idx: int):
        super().__init__()
        c, i = cfg, idx
        cin = c.stage_in_channels[i]
        self.downsample = (ConvLayer(cin, cin, 3, stride=2, groups=cin,
                                     act=False)
                           if c.stage_downsample[i] else None)
        self.blocks = nn.ModuleList(
            BasicLayer(cin if b == 0 else c.stage_out_channels[i],
                       c.stage_mid_channels[i], c.stage_out_channels[i],
                       c.stage_num_layers[i], c.stage_kernel_size[i],
                       c.stage_light_block[i], residual=(b != 0),
                       lab=c.use_learnable_affine_block)
            for b in range(c.stage_num_blocks[i]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class Embeddings(nn.Module):
    """The HGNetV2 stem of HF D-FINE (``pautdx/models/vision/hgnet.py:
    178-198``), NCHW: a stride-2 3x3 conv, then two paths over its output
    padded by one row and column at the bottom and right, two 2x2 VALID
    convs (a 2x2 ``ConvLayer`` pads (2-1)//2 = 0) and a 2x2 stride-1 max
    pool, concatenated pool first, then a stride-2 3x3 conv and a 1x1
    conv: stride 4 in all."""

    def __init__(self, cfg: HGNetConfig):
        super().__init__()
        cin, c1, c2 = cfg.stem_channels
        lab = cfg.use_learnable_affine_block
        self.stem1 = ConvLayer(cin, c1, 3, stride=2, lab=lab)
        self.stem2a = ConvLayer(c1, c1 // 2, 2, lab=lab)
        self.stem2b = ConvLayer(c1 // 2, c1, 2, lab=lab)
        self.stem3 = ConvLayer(2 * c1, c1, 3, stride=2, lab=lab)
        self.stem4 = ConvLayer(c1, c2, 1, lab=lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        a = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        p = F.max_pool2d(x, 2, stride=1)
        return self.stem4(self.stem3(torch.cat([p, a], dim=1)))


class _S2DProj(nn.Module):
    """The patchify conv as space-to-depth + matmul, on NHWC.

    The weight is stored conv-style, (f, C, p, p); the patch is flattened
    in (ki, kj, c) order, so the weight is permuted to (f, p, p, C) before
    its reshape to (f, p*p*C). The patches come from one reshape and
    permute. ``impl`` names how the reference lowers them on its device
    ("transpose" or "slices", p*p strided slices concatenated in (ki, kj,
    c) order); both are the same function, so both run this lowering.
    An integer input (raw uint8 frames, with 1/255 folded into
    the weight by ``fold_uint8_stem``) is cast to the weight's dtype before
    the matmul, as the reference does.
    """

    def __init__(self, patch: int, in_channels: int, features: int,
                 pre_patchified: bool = False, impl: str = "transpose"):
        super().__init__()
        if impl not in ("transpose", "slices"):
            raise ValueError(f"stem_s2d_impl={impl!r}: the lowerings are "
                             f"'transpose' and 'slices'")
        self.patch = patch
        self.pre_patchified = pre_patchified
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, patch, patch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        f, C = self.weight.shape[:2]
        B, H, W, Cx = x.shape
        if self.pre_patchified:
            if Cx != p * p * C:
                raise ValueError(
                    f"pre-patchified stem input's last axis must be "
                    f"patch*patch*channels = {p * p * C}, got {Cx}")
        else:
            if H % p or W % p:
                raise ValueError(
                    f"space-to-depth stem requires input H/W divisible by "
                    f"the patch size {p}, got {H}x{W}")
            x = x.reshape(B, H // p, p, W // p, p, Cx).permute(
                0, 1, 3, 2, 4, 5).reshape(B, H // p, W // p, p * p * Cx)
        w = self.weight.permute(0, 2, 3, 1).reshape(f, p * p * C)
        if x.dtype.is_floating_point:
            dt = torch.promote_types(x.dtype, w.dtype)
        else:
            dt = w.dtype
        return torch.matmul(x.to(dt), w.to(dt).t())


class PatchifyStem(nn.Module):
    """k=p, s=p patchify stem + BN + ReLU: NHWC in, NCHW out."""

    def __init__(self, cfg: HGNetConfig, patch: int = 4, features: int = 0):
        super().__init__()
        f = features or cfg.stem_channels[2]
        cin = cfg.stem_channels[0]
        self.patch = patch
        self.s2d = cfg.stem_s2d
        if cfg.stem_s2d:
            self.proj = _S2DProj(patch, cin, f, cfg.stem_pre_patchified,
                                 cfg.stem_s2d_impl)
        else:
            self.proj = nn.Conv2d(cin, f, patch, patch, bias=False)
        self.norm = BatchNorm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.s2d:
            x = self.proj(x).permute(0, 3, 1, 2)
        else:
            H, W = x.shape[1:3]
            if H % self.patch or W % self.patch:
                raise ValueError(f"patchify stem requires H/W divisible by "
                                 f"{self.patch}, got {H}x{W}")
            x = self.proj(x.permute(0, 3, 1, 2))
        return F.relu(self.norm(x))


class HGNetV2(nn.Module):
    """NHWC image (or patch slab) -> the ``cfg.out_indices`` feature maps,
    NHWC. Built in eval mode, as ``DFine`` is: ``train()`` switches its
    BatchNorms to batch statistics."""

    def __init__(self, cfg: HGNetConfig = HGNetConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self._build(cfg)
        init_params(self, seed)
        self.to(dtype)
        self.eval()

    def _build(self, cfg: HGNetConfig) -> None:
        start = cfg.start_stage
        if cfg.stem == "patchify":
            self.patch_embedder = PatchifyStem(cfg, patch=cfg.stem_patch)
        elif cfg.stem == "patchify8":
            self.patch_embedder = PatchifyStem(
                cfg, patch=cfg.stem_patch,
                features=cfg.stage_in_channels[start])
        elif cfg.stem == "hgnet":
            self.embedder = Embeddings(cfg)
        else:
            raise ValueError(f"HGNet stem {cfg.stem!r}: the stems are "
                             f"'hgnet', 'patchify' and 'patchify8'")
        self.encoder = nn.Module()
        self.encoder.stages = nn.ModuleDict(
            {str(i): Stage(cfg, i)
             for i in range(start, len(cfg.stage_in_channels))})

    def forward_nchw(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = {}
        if self.cfg.stem == "hgnet":
            x = self.embedder(x.permute(0, 3, 1, 2))
        else:
            x = self.patch_embedder(x)
        for name, stage in self.encoder.stages.items():
            x = stage(x)
            feats[int(name)] = x
        return [feats[i] for i in self.cfg.out_indices]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [f.permute(0, 2, 3, 1) for f in self.forward_nchw(x)]
