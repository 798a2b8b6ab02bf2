"""D-FINE detector: HGNetV2 backbone, hybrid encoder (AIFI + FPN/PAN),
two-stage query selection and the FDR decoder with LQE, at inference and
in training.

Counterpart of ``pautdx/models/vision/dfine.py``. Module paths mirror it,
so weights move leaf by leaf (``pautdx_torch.compat.jax_weights``). The
public forward takes NHWC images (or pre-patchified NHWC slabs) like the
reference; convolutions run NCHW on the same memory, and every flatten to
tokens goes through NHWC, H x W row-major, as the reference's does.

dtype policy, as in the reference: features ride the parameters' dtype
(bf16 when serving), while anchors, reference points, sampling locations
and box decoding stay float32. ``Dense``/``LayerNorm`` compute in the
promoted dtype of input and weight, as the reference's do, so a float32
input to bf16 weights (the query position head) computes in float32.

Ported: head-shared sampling points with the bilinear
``decoder_method="default"`` (the ``weighted_gather`` kernel) and the
discrete one (the ``onehot_gather`` kernel), both forward and backward, so
either decoder trains; per-head sampling points (the HF-architecture
``DFineConfig()``, plain PyTorch as in the reference); the fused AIFI
attention kernel (inference without a mask only, any head dim to 256);
the training mode of ``forward(images, train=True)``: BatchNorm on batch
statistics, dropout, and every ``stop_gradient`` of the reference as a
``.detach()`` at the same place; and the contrastive denoising queries of
``forward(..., denoising=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pautdx_torch.device import resolve_device
from pautdx_torch.models.vision.hgnet import (
    BatchNorm, HGNetConfig, HGNetV2, init_params,
)
from pautdx_torch.nn.blocks import Dropout
from pautdx_torch.ops import attention, deformable
from pautdx_torch.ops.qconv import Int8Site
from pautdx_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DFineConfig:
    num_labels: int = 2
    d_model: int = 256
    num_queries: int = 300
    decoder_layers: int = 6
    decoder_attention_heads: int = 8
    decoder_ffn_dim: int = 1024
    decoder_n_points: int = 4
    decoder_offset_scale: float = 0.5
    num_feature_levels: int = 3
    encoder_hidden_dim: int = 256
    encoder_layers: int = 1
    encoder_attention_heads: int = 8
    encoder_ffn_dim: int = 1024
    hidden_expansion: float = 1.0
    depth_mult: float = 1.0
    max_num_bins: int = 32
    reg_scale: float = 4.0
    up: float = 0.5
    top_prob_values: int = 4
    lqe_hidden_dim: int = 64
    feat_strides: Tuple[int, ...] = (8, 16, 32)
    anchor_grid_size: float = 0.05
    backbone: HGNetConfig = HGNetConfig()
    eval_idx: int = -1
    decoder_method: str = "default"     # default (bilinear) | discrete
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    decoder_shared_points: bool = False
    query_topk: str = "exact"           # both are torch.topk here
    encoder_act_approx: bool = False    # tanh GELU in the AIFI FFN
    encoder_fused_attn: bool = False    # AIFI through ops.attention

    def __post_init__(self):
        if self.encoder_hidden_dim != self.d_model:
            raise ValueError(
                f"encoder_hidden_dim ({self.encoder_hidden_dim}) must "
                f"equal d_model ({self.d_model}) in this implementation")
        if self.d_model % self.decoder_attention_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by "
                f"decoder_attention_heads {self.decoder_attention_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.decoder_attention_heads

    @property
    def num_points_list(self) -> List[int]:
        return [self.decoder_n_points] * self.num_feature_levels


def dfine_nano(num_labels: int = 2, tpu_stem: bool = True,
               levels: int = 2, stride8_stem: bool = True) -> DFineConfig:
    """The pautdx-native small preset (the reference's ``dfine_nano``):
    2 feature levels, the stride-8 space-to-depth stem, d_model 128,
    3 decoder layers, 150 queries, head-shared sampling points."""
    if levels == 3:
        stride8_stem = False
    strides = (8, 16, 32)[3 - levels:]
    return DFineConfig(
        num_labels=num_labels, d_model=128, encoder_hidden_dim=128,
        decoder_layers=3, decoder_ffn_dim=512, encoder_ffn_dim=512,
        num_queries=150,
        decoder_shared_points=True,
        query_topk="approx",
        encoder_act_approx=True,
        num_feature_levels=levels, feat_strides=strides,
        backbone=HGNetConfig(
            stem=("patchify8" if stride8_stem
                  else "patchify" if tpu_stem else "hgnet"),
            stem_s2d=tpu_stem or stride8_stem,
            start_stage=2 if stride8_stem else 0,
            out_indices=tuple(range(4 - levels, 4))),
    )


def config_to_dict(cfg: DFineConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict[str, Any]) -> DFineConfig:
    """Inverse of :func:`config_to_dict` (tolerates JSON list/tuple loss)."""
    d = dict(d)
    bb = dict(d.pop("backbone", {}))
    for k, v in list(bb.items()):
        if isinstance(v, list):
            bb[k] = tuple(v)
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(v)
    return DFineConfig(backbone=HGNetConfig(**bb), **d)


# ---------------------------------------------------------------------------
# closed forms


def weighting_function(max_num_bins: int, up: float, reg_scale: float
                       ) -> torch.Tensor:
    """Non-uniform FDR bin values W(n), length max_num_bins + 1 (f32)."""
    up, reg_scale = abs(up), abs(reg_scale)
    ub1 = up * reg_scale
    ub2 = up * reg_scale * 2
    step = (ub1 + 1) ** (2 / (max_num_bins - 2))
    left = [-(step ** i) + 1 for i in range(max_num_bins // 2 - 1, 0, -1)]
    right = [step ** i - 1 for i in range(1, max_num_bins // 2)]
    values = [-ub2] + left + [0.0] + right + [ub2]
    return torch.tensor(values, dtype=torch.float32)


def integral(pred_corners: torch.Tensor, project: torch.Tensor,
             max_num_bins: int) -> torch.Tensor:
    """softmax over bins -> expected distance per side: (..., 4)."""
    shape = pred_corners.shape[:-1]
    p = torch.softmax(pred_corners.reshape(*shape, 4, max_num_bins + 1),
                      dim=-1)
    dt = torch.promote_types(p.dtype, project.dtype)
    return torch.matmul(p.to(dt), project.to(dt))


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  reg_scale: float) -> torch.Tensor:
    """(cx, cy, w, h) refs + ltrb distances -> refined (cx, cy, w, h)."""
    reg_scale = abs(reg_scale)
    x1 = points[..., 0] - (0.5 * reg_scale + distance[..., 0]) * (points[..., 2] / reg_scale)
    y1 = points[..., 1] - (0.5 * reg_scale + distance[..., 1]) * (points[..., 3] / reg_scale)
    x2 = points[..., 0] + (0.5 * reg_scale + distance[..., 2]) * (points[..., 2] / reg_scale)
    y2 = points[..., 1] + (0.5 * reg_scale + distance[..., 3]) * (points[..., 3] / reg_scale)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def sincos_position_embedding(width: int, height: int, embed_dim: int,
                              temperature: float = 10000.0) -> np.ndarray:
    """2D sin-cos embedding, width-major grid: (1, W*H, embed_dim)."""
    grid_w, grid_h = np.meshgrid(np.arange(width, dtype=np.float32),
                                 np.arange(height, dtype=np.float32),
                                 indexing="ij")
    pos_dim = embed_dim // 4
    omega = 1.0 / (temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim))
    out_w = grid_w.flatten()[:, None] @ omega[None]
    out_h = grid_h.flatten()[:, None] @ omega[None]
    return np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )[None]


# ---------------------------------------------------------------------------
# building blocks (names mirror the reference)


class Dense(nn.Linear):
    """``nn.Linear`` in the promoted dtype of input and weight (the
    reference's ``Dense`` semantics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5) in the promoted dtype of input and
    weight."""

    def __init__(self, d: int):
        super().__init__(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


_ACTS = {None: lambda x: x, "silu": F.silu, "relu": F.relu, "gelu": F.gelu}


class ConvNorm(Int8Site):
    """conv (no bias) + BN + optional act, NCHW; an int8 site
    (``ops.qconv.Int8Site``)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, groups: int = 1, act: Optional[str] = None,
                 padding: Optional[int] = None):
        super().__init__()
        p = (kernel - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              padding=p, groups=groups, bias=False)
        self.norm = BatchNorm(features)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.site_conv(self.conv, x)))


class RepVggBlock(nn.Module):
    def __init__(self, features: int, act: str = "silu"):
        super().__init__()
        self.conv1 = ConvNorm(features, features, 3, padding=1)
        self.conv2 = ConvNorm(features, features, 1, padding=0)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    def __init__(self, in_channels: int, features: int, num_blocks: int = 3,
                 expansion: float = 1.0, act: str = "silu"):
        super().__init__()
        hidden = int(features * expansion)
        self.conv1 = ConvNorm(in_channels, hidden, 1, act=act)
        self.bottlenecks = nn.ModuleList(
            RepVggBlock(hidden, act) for _ in range(num_blocks))
        self.conv2 = ConvNorm(in_channels, hidden, 1, act=act)
        self.conv3 = (ConvNorm(hidden, features, 1, act=act)
                      if hidden != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1 = self.conv1(x)
        for block in self.bottlenecks:
            h1 = block(h1)
        h = h1 + self.conv2(x)
        return self.conv3(h) if self.conv3 is not None else h


class RepNCSPELAN4(nn.Module):
    def __init__(self, cfg: DFineConfig, in_channels: int,
                 num_blocks: int = 3):
        super().__init__()
        d = cfg.encoder_hidden_dim
        conv3_dim = d * 2
        conv4_dim = round(cfg.hidden_expansion * d // 2)
        self.split_dim = conv3_dim // 2
        self.conv1 = ConvNorm(in_channels, conv3_dim, 1, act="silu")
        self.csp_rep1 = CSPRepLayer(self.split_dim, conv4_dim, num_blocks)
        self.conv2 = ConvNorm(conv4_dim, conv4_dim, 3, act="silu")
        self.csp_rep2 = CSPRepLayer(conv4_dim, conv4_dim, num_blocks)
        self.conv3 = ConvNorm(conv4_dim, conv4_dim, 3, act="silu")
        self.conv4 = ConvNorm(conv3_dim + 2 * conv4_dim, d, 1, act="silu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        a, b = h[:, :self.split_dim], h[:, self.split_dim:]
        b1 = self.conv2(self.csp_rep1(b))
        b2 = self.conv3(self.csp_rep2(b1))
        return self.conv4(torch.cat([a, b, b1, b2], dim=1))


class SCDown(nn.Module):
    def __init__(self, cfg: DFineConfig, kernel: int = 3, stride: int = 2):
        super().__init__()
        d = cfg.encoder_hidden_dim
        self.conv1 = ConvNorm(d, d, 1)
        self.conv2 = ConvNorm(d, d, kernel, stride=stride, groups=d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


def _dropout(rate: float) -> nn.Module:
    """``nn.blocks.Dropout`` where the reference drops (rate > 0), else
    nothing."""
    return Dropout(rate) if rate > 0 else nn.Identity()


class TorchMHA(nn.Module):
    """Separate-projection MHA with additive pos embeddings on q/k, an
    optional additive ``attn_mask`` on the logits (the denoising groups')
    and dropout on the softmaxed weights in training. ``fused=True`` (the
    AIFI layer) routes the attention through the ``ops.attention`` kernel
    in eval and without a mask only (``dfine.py:380``); training keeps the
    matmul chain."""

    def __init__(self, d: int, num_heads: int, fused: bool = False,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.fused = fused
        self.attn_drop = _dropout(attention_dropout)
        self.q_proj = Dense(d, d)
        self.k_proj = Dense(d, d)
        self.v_proj = Dense(d, d)
        self.out_proj = Dense(d, d)

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, d = x.shape
        dh = d // self.num_heads
        qk_in = x if pos is None else x + pos
        q = self.q_proj(qk_in) * (dh ** -0.5)
        k = self.k_proj(qk_in)
        v = self.v_proj(x)
        # this rank's heads: all of them, or 1/tp of them where the
        # projections are column-parallel (mesh.tp)
        h = q.shape[-1] // dh
        if self.fused and not self.training and attn_mask is None:
            return self.out_proj(attention.aifi_attention(q, k, v, h))

        def split(t):
            return t.reshape(B, N, h, dh).transpose(1, 2)

        logits = torch.matmul(split(q), split(k).transpose(-1, -2))
        if attn_mask is not None:
            logits = logits + attn_mask.to(logits.dtype)
        w = self.attn_drop(torch.softmax(logits, dim=-1))
        out = torch.matmul(w, split(v)).transpose(1, 2).reshape(B, N, h * dh)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """AIFI encoder layer (post-norm, GELU)."""

    def __init__(self, cfg: DFineConfig):
        super().__init__()
        d = cfg.encoder_hidden_dim
        self.self_attn = TorchMHA(d, cfg.encoder_attention_heads,
                                  fused=cfg.encoder_fused_attn,
                                  attention_dropout=cfg.attention_dropout)
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1 = Dense(d, cfg.encoder_ffn_dim)
        self.fc2 = Dense(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d)
        self.approximate = "tanh" if cfg.encoder_act_approx else "none"
        self.drop = _dropout(cfg.dropout)
        self.act_drop = _dropout(cfg.activation_dropout)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(
            x + self.drop(self.self_attn(x, pos=pos)))
        h = F.gelu(self.fc1(x), approximate=self.approximate)
        return self.final_layer_norm(
            x + self.drop(self.fc2(self.act_drop(h))))


class HybridEncoder(nn.Module):
    """AIFI on the last level + FPN/PAN cross-scale fusion (NCHW maps)."""

    def __init__(self, cfg: DFineConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_hidden_dim
        n_stages = cfg.num_feature_levels - 1
        n_blocks = max(1, round(3 * cfg.depth_mult))
        aifi = nn.Module()
        aifi.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.encoder = nn.ModuleList([aifi])
        self.lateral_convs = nn.ModuleList(
            ConvNorm(d, d, 1) for _ in range(n_stages))
        self.fpn_blocks = nn.ModuleList(
            RepNCSPELAN4(cfg, 2 * d, n_blocks) for _ in range(n_stages))
        self.downsample_convs = nn.ModuleList(
            SCDown(cfg) for _ in range(n_stages))
        self.pan_blocks = nn.ModuleList(
            RepNCSPELAN4(cfg, 2 * d, n_blocks) for _ in range(n_stages))
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def position_embedding(self, W: int, H: int, like: torch.Tensor
                           ) -> torch.Tensor:
        key = (W, H, like.dtype, like.device)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(sincos_position_embedding(
                W, H, self.cfg.encoder_hidden_dim)).to(like.device,
                                                        like.dtype)
        return self._pos[key]

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        feats = list(feats)
        x = feats[-1]
        B, D, H, W = x.shape
        src = x.permute(0, 2, 3, 1).reshape(B, H * W, D)
        pos = self.position_embedding(W, H, src)
        for layer in self.encoder[0].layers:
            src = layer(src, pos)
        feats[-1] = src.reshape(B, H, W, D).permute(0, 3, 1, 2)

        n_stages = len(feats) - 1
        fpn_maps = [feats[-1]]
        for idx in range(n_stages):
            lower = feats[n_stages - idx - 1]
            top = self.lateral_convs[idx](fpn_maps[-1])
            fpn_maps[-1] = top
            up = F.interpolate(top, scale_factor=2, mode="nearest")
            up = up[:, :, :lower.shape[2], :lower.shape[3]]
            fpn_maps.append(self.fpn_blocks[idx](torch.cat([up, lower], 1)))
        fpn_maps = fpn_maps[::-1]
        pan_maps = [fpn_maps[0]]
        for idx in range(n_stages):
            down = self.downsample_convs[idx](pan_maps[-1])
            pan_maps.append(self.pan_blocks[idx](
                torch.cat([down, fpn_maps[idx + 1]], 1)))
        return pan_maps


class MLPHead(nn.Module):
    """Dense layers with ReLU (or SiLU) between."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int,
                 act: str = "relu"):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1]) for i in range(num_layers))
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x


class Gate(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gate = Dense(2 * d, 2 * d)
        self.norm = LayerNorm(d)

    def forward(self, second_residual: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
        gates = torch.sigmoid(self.gate(
            torch.cat([second_residual, hidden], dim=-1)))
        g1, g2 = gates.chunk(2, dim=-1)
        return self.norm(g1 * second_residual + g2 * hidden)


class LQE(nn.Module):
    def __init__(self, cfg: DFineConfig):
        super().__init__()
        self.cfg = cfg
        self.reg_conf = MLPHead(4 * (cfg.top_prob_values + 1),
                                cfg.lqe_hidden_dim, 1, 2)

    def forward(self, scores: torch.Tensor,
                pred_corners: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L, _ = pred_corners.shape
        prob = torch.softmax(
            pred_corners.reshape(B, L, 4, c.max_num_bins + 1), dim=-1)
        topk = prob.topk(c.top_prob_values, dim=-1).values
        stat = torch.cat([topk, topk.mean(dim=-1, keepdim=True)], dim=-1)
        return scores + self.reg_conf(stat.reshape(B, L, -1))


class DeformableAttention(nn.Module):
    """Multi-scale deformable cross-attention (HF
    DFineMultiscaleDeformableAttention): one set of sampling points shared
    by all heads (``decoder_shared_points``, the gather kernels) or one per
    head (the HF configs, ``deformable.ms_deformable_attention``)."""

    def __init__(self, cfg: DFineConfig):
        super().__init__()
        self.cfg = cfg
        total = sum(cfg.num_points_list)
        self.n_loc = (1 if cfg.decoder_shared_points
                      else cfg.decoder_attention_heads)
        self.sampling_offsets = Dense(cfg.d_model, self.n_loc * total * 2)
        self.attention_weights = Dense(
            cfg.d_model, cfg.decoder_attention_heads * total)
        self._scale: Dict[torch.device, torch.Tensor] = {}

    def point_scale(self, device: torch.device) -> torch.Tensor:
        if device not in self._scale:
            self._scale[device] = torch.tensor(
                [1.0 / p for p in self.cfg.num_points_list for _ in range(p)],
                dtype=torch.float32, device=device)
        return self._scale[device]

    def forward(self, hidden: torch.Tensor, value_levels: List[torch.Tensor],
                reference_points: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, Q, _ = hidden.shape
        pts = c.num_points_list
        total = sum(pts)
        offsets = self.sampling_offsets(hidden).reshape(B, Q, self.n_loc,
                                                        total, 2)
        weights = torch.softmax(self.attention_weights(hidden).reshape(
            B, Q, c.decoder_attention_heads, total), dim=-1)
        # coordinate math in f32 whatever the feature dtype
        ref = reference_points.float()
        offset = (offsets.float() * self.point_scale(hidden.device)[:, None]
                  * ref[:, :, None, None, 2:] * c.decoder_offset_scale)
        locations = ref[:, :, None, None, :2] + offset  # (B, Q, n_loc, P, 2)
        w = weights.to(value_levels[0].dtype)
        if c.decoder_shared_points:
            out = deformable.ms_deformable_attention_shared(
                value_levels, locations[:, :, 0], w, pts,
                method=c.decoder_method)
        else:
            out = deformable.ms_deformable_attention(
                value_levels, locations, w, pts, method=c.decoder_method)
        return out.to(hidden.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DFineConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = TorchMHA(d, cfg.decoder_attention_heads,
                                  attention_dropout=cfg.attention_dropout)
        self.self_attn_layer_norm = LayerNorm(d)
        self.encoder_attn = DeformableAttention(cfg)
        self.gateway = Gate(d)
        self.fc1 = Dense(d, cfg.decoder_ffn_dim)
        self.fc2 = Dense(cfg.decoder_ffn_dim, d)
        self.final_layer_norm = LayerNorm(d)
        self.drop = _dropout(cfg.dropout)
        self.act_drop = _dropout(cfg.activation_dropout)

    def forward(self, hidden: torch.Tensor, pos: torch.Tensor,
                value_levels: List[torch.Tensor],
                reference_points: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.self_attn_layer_norm(
            hidden + self.drop(self.self_attn(hidden, pos=pos,
                                              attn_mask=attn_mask)))
        cross = self.encoder_attn(hidden + pos, value_levels,
                                  reference_points)
        hidden = self.gateway(hidden, self.drop(cross))
        h = self.fc2(self.act_drop(F.relu(self.fc1(hidden))))
        return self.final_layer_norm(
            (hidden + self.drop(h)).clamp(-65504.0, 65504.0))


class DFine(nn.Module):
    """Full detector. ``forward(images, train=False)`` takes NHWC images
    (or, with ``backbone.stem_pre_patchified``, (B, H/p, W/p, p*p*C)
    slabs, uint8 allowed after ``fold_uint8_stem``) and returns a dict
    with ``logits`` (B, Q, num_labels) and ``pred_boxes`` (B, Q, 4)
    normalized cxcywh, float32, plus the intermediates the training
    criterion reads. The forward runs with autograd as the caller set it:
    serving wraps its calls in ``torch.inference_mode()``."""

    def __init__(self, cfg: DFineConfig = DFineConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        with torch.device(dev):
            self._build(cfg, dev)
        init_params(self, seed)
        self.to(dtype)
        self.eval()
        self._consts: Dict[Tuple, Any] = {}

    def _build(self, cfg: DFineConfig, dev: torch.device) -> None:
        d = cfg.d_model
        model = nn.Module()
        model.backbone = nn.Module()
        model.backbone.model = HGNetV2(cfg.backbone, device=dev)
        model.encoder_input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cin, cfg.encoder_hidden_dim, 1,
                                    bias=False),
                          BatchNorm(cfg.encoder_hidden_dim))
            for cin in cfg.backbone.out_channels)
        model.encoder = HybridEncoder(cfg)
        model.enc_output = nn.Sequential(Dense(d, d), LayerNorm(d))
        model.enc_score_head = Dense(d, cfg.num_labels)
        model.enc_bbox_head = MLPHead(d, d, 4, 3)
        # the contrastive denoising queries' class embedding (training)
        model.denoising_class_embed = nn.Embedding(cfg.num_labels + 1, d)
        decoder = nn.Module()
        decoder.query_pos_head = MLPHead(4, 2 * d, d, 2)
        decoder.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.decoder_layers))
        decoder.pre_bbox_head = MLPHead(d, d, 4, 3)
        decoder.lqe_layers = nn.ModuleList(
            LQE(cfg) for _ in range(cfg.decoder_layers))
        model.decoder = decoder
        self.model = model
        self.bbox_embed = nn.ModuleList(
            MLPHead(d, d, 4 * (cfg.max_num_bins + 1), 3)
            for _ in range(cfg.decoder_layers))
        self.class_embed = nn.ModuleList(
            Dense(d, cfg.num_labels) for _ in range(cfg.decoder_layers))

    def generate_anchors(self, spatial_shapes: Sequence[Tuple[int, int]],
                         device: torch.device
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, L, 4) logit-space anchors and (1, L, 1) validity, f32."""
        key = ("anchors", tuple(spatial_shapes), device)
        if key in self._consts:
            return self._consts[key]
        c = self.cfg
        anchors = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32), indexing="ij")
            gxy = (np.stack([gx, gy], -1) + 0.5) / np.asarray([w, h], np.float32)
            wh = np.ones_like(gxy) * c.anchor_grid_size * (
                c.feat_strides[lvl] / 8.0)
            anchors.append(np.concatenate([gxy, wh], -1).reshape(-1, 4))
        anchors = np.concatenate(anchors, 0)[None]
        eps = 1e-2
        valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdims=True)
        anchors = np.log(anchors / (1 - anchors))
        anchors = np.where(valid, anchors, np.finfo(np.float32).max)
        out = (torch.from_numpy(anchors.astype(np.float32)).to(device),
               torch.from_numpy(valid.astype(np.float32)).to(device))
        self._consts[key] = out
        return out

    def project(self, device: torch.device) -> torch.Tensor:
        key = ("project", device)
        if key not in self._consts:
            c = self.cfg
            self._consts[key] = weighting_function(
                c.max_num_bins, c.up, c.reg_scale).to(device)
        return self._consts[key]

    def forward(self, images: torch.Tensor, train: bool = False,
                denoising: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, Any]:
        """``train`` sets the module's mode (``nn.Module.train``), the one
        switch that BatchNorm, dropout and the fused attention read, as the
        reference's ``__call__(images, train)`` does per call.

        ``denoising`` (training): a group from
        ``losses.denoising.make_denoising_queries``, class_ids (B, D),
        box_logits (B, D, 4) and attn_mask (D+Q, D+Q). Its D queries are
        prepended after the top-Q query selection, which never sees them;
        the mask goes to every decoder layer's self-attention, and the
        output adds ``dn_logits`` and ``dn_boxes``, the denoising slots of
        every head, split off the matching queries' heads."""
        if denoising is not None:
            missing = {"class_ids", "box_logits", "attn_mask"} - set(denoising)
            if missing:
                raise KeyError(f"denoising group lacks {sorted(missing)}")
        if train != self.training:
            self.train(train)
        c = self.cfg
        m = self.model
        with span("dfine.forward"):
            with span("dfine.backbone"):
                feats = m.backbone.model.forward_nchw(images)
            with span("dfine.encoder"):
                proj = [p(f) for p, f in zip(m.encoder_input_proj, feats)]
                sources = m.encoder(proj)
            with span("dfine.select"):
                B = sources[0].shape[0]
                dev = sources[0].device

                spatial_shapes = [(s.shape[2], s.shape[3]) for s in sources]
                nhwc = [s.permute(0, 2, 3, 1) for s in sources]
                flat = torch.cat([s.reshape(B, -1, c.d_model) for s in nhwc],
                                 dim=1)
                anchors, valid_mask = self.generate_anchors(spatial_shapes,
                                                            dev)
                memory = valid_mask.to(flat.dtype) * flat
                out_mem = m.enc_output(memory)
                enc_class = m.enc_score_head(out_mem)

                num_queries = min(c.num_queries, enc_class.shape[1])
                topk_ind = torch.topk(enc_class.max(-1).values.float(),
                                      num_queries, dim=1).indices

                def take(t):
                    return torch.gather(
                        t, 1, topk_ind[..., None].expand(-1, -1, t.shape[-1]))

                sel_anchors = take(anchors.expand(B, -1, -1))
                ref_unact = (m.enc_bbox_head(take(out_mem)).float()
                             + sel_anchors)
                enc_topk_logits = take(enc_class)
                enc_topk_bboxes = torch.sigmoid(ref_unact)
                target = take(out_mem).detach()
                init_ref = ref_unact.detach()
            with span("dfine.decoder"):
                attn_mask = None
                dn_split = 0
                if denoising is not None:
                    dn_target = m.denoising_class_embed(
                        denoising["class_ids"].long()).to(target.dtype)
                    target = torch.cat([dn_target, target], dim=1)
                    init_ref = torch.cat(
                        [denoising["box_logits"].to(init_ref.dtype), init_ref],
                        dim=1)
                    attn_mask = denoising["attn_mask"][None, None]
                    dn_split = denoising["class_ids"].shape[1]

                value_levels = [s.reshape(s.shape[0], s.shape[1], s.shape[2],
                                          c.decoder_attention_heads,
                                          c.head_dim)
                                for s in nhwc]
                project = self.project(dev)
                ref_points = torch.sigmoid(init_ref)
                hidden = target
                out_logits, out_boxes, out_corners, out_refs = [], [], [], []
                pred_corners_undetach = 0.0
                output_detach = 0.0
                ref_points_initial = None
                eval_idx = (c.eval_idx if c.eval_idx >= 0
                            else c.decoder_layers + c.eval_idx)
                dec = m.decoder
                for i, layer in enumerate(dec.layers):
                    ref_detach = ref_points.detach()
                    pos = dec.query_pos_head(ref_detach).clamp(-10.0, 10.0)
                    pos = pos.to(hidden.dtype)
                    hidden = layer(hidden, pos, value_levels, ref_detach,
                                   attn_mask)
                    if i == 0:
                        new_ref = torch.sigmoid(dec.pre_bbox_head(hidden)
                                                + inverse_sigmoid(ref_detach))
                        ref_points_initial = new_ref.detach()
                    pred_corners = self.bbox_embed[i](hidden + output_detach) \
                        + pred_corners_undetach
                    inter_ref = distance2bbox(
                        ref_points_initial,
                        integral(pred_corners, project, c.max_num_bins),
                        c.reg_scale)
                    pred_corners_undetach = pred_corners
                    ref_points = inter_ref.detach()
                    output_detach = hidden.detach()
                    scores = self.class_embed[i](hidden)
                    if i == 0:
                        out_logits.append(scores)
                        out_boxes.append(new_ref)
                    scores = dec.lqe_layers[i](scores, pred_corners)
                    out_logits.append(scores)
                    out_boxes.append(inter_ref)
                    out_corners.append(pred_corners)
                    out_refs.append(ref_points_initial)
                extra = {}
                if dn_split:
                    extra = {
                        "dn_logits": [t[:, :dn_split] for t in out_logits],
                        "dn_boxes": [t[:, :dn_split] for t in out_boxes]}
                    out_logits, out_boxes, out_corners, out_refs = (
                        [t[:, dn_split:] for t in ts]
                        for ts in (out_logits, out_boxes, out_corners,
                                   out_refs))
                    hidden = hidden[:, dn_split:]
                return {
                    **extra,
                    "logits": out_logits[eval_idx + 1],
                    "pred_boxes": out_boxes[eval_idx + 1],
                    "last_hidden_state": hidden,
                    "intermediate_logits": out_logits,
                    "intermediate_boxes": out_boxes,
                    "intermediate_corners": out_corners,
                    "initial_references": out_refs,
                    "enc_topk_logits": enc_topk_logits,
                    "enc_topk_bboxes": enc_topk_bboxes,
                    "project": project,
                }


def post_process(logits: torch.Tensor, pred_boxes: torch.Tensor,
                 target_size: Tuple[int, int], threshold: float = 0.3,
                 max_det: int = 100) -> Dict[str, torch.Tensor]:
    """Per-query best class via sigmoid, boxes cxcywh -> xyxy scaled to
    pixels, fixed-size top-k with a validity mask."""
    with span("dfine.post_process"):
        probs = torch.sigmoid(logits)
        B, Q, L = probs.shape
        k = min(max_det, Q * L)
        top_scores, idx = torch.topk(probs.reshape(B, Q * L), k, dim=1)
        q_idx = idx // L
        classes = idx % L
        H, W = target_size
        cx, cy, w, h = pred_boxes.unbind(-1)
        xyxy = torch.stack([(cx - w / 2) * W, (cy - h / 2) * H,
                            (cx + w / 2) * W, (cy + h / 2) * H], dim=-1)
        boxes = torch.gather(xyxy, 1, q_idx[..., None].expand(-1, -1, 4))
        return {"scores": top_scores, "classes": classes, "boxes": boxes,
                "valid": top_scores >= threshold}
