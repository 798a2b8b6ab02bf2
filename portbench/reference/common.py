"""Plain PyTorch building blocks of the benchmark's frozen reference.

Copies of the port's plain versions, frozen here so that a change to the
program cannot move the yardstick: the seeded init, the reference's
BatchNorm (one process), the conv-site base without int8, and the plain
math of every hand-written kernel the served paths launch (AIFI attention,
the one-hot and weighted row gathers, the greedy NMS sweep, the YOLO-seg
mask decode). Nothing here imports the program or JAX.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``."""
    return torch.device("cuda" if device is None else device)


@torch.no_grad()
def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init from a ``torch.Generator`` on the parameters' device:
    every weight of rank >= 2 ~ N(0, 1/fan_in), every 1-d weight or scale
    1, every bias 0."""
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


BN_MOMENTUM = 0.99


class BatchNorm(nn.Module):
    """BatchNorm over dim 1: eval normalises with the running statistics;
    train with the batch's mean and biased variance in f32, updating the
    running ones as ``r = m * r + (1 - m) * batch`` with the biased
    variance."""

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
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, C] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dims)
        dev = xf - mean.reshape(shape)
        var = (dev * dev).mean(dims)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        out = (xf - mean.reshape(shape)) * scale.reshape(shape) \
            + self.bias.to(xf.dtype).reshape(shape)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.to(self.running_mean.dtype))
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.to(self.running_var.dtype))
        return out.to(x.dtype)


class Int8Site(nn.Module):
    """The conv-site base of the port without its int8 branch."""

    def site_conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv(x)


class Dropout(nn.Dropout):
    """``nn.Dropout``; the served paths run it in eval mode."""


def aifi_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """(B, N, D) projections, q pre-scaled -> (B, N, D): per-head softmax
    attention with scores and the PV sum in f32."""
    B, N, D = q.shape
    dh = D // num_heads

    def split(t):
        return t.reshape(B, N, num_heads, dh).transpose(1, 2)

    s = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), split(v).float()).to(q.dtype)
    return o.transpose(1, 2).reshape(B, N, D)


# while :func:`observe_gathers` is open, the distinct rows each one-hot
# gather reads, one count a call (the gather kernel's bound reads them)
_OBSERVED: Optional[list] = None


@contextmanager
def observe_gathers():
    """Collect, for each one-hot gather called inside, the number of
    distinct (frame, row) pairs it reads."""
    global _OBSERVED
    saved, _OBSERVED = _OBSERVED, []
    try:
        yield _OBSERVED
    finally:
        _OBSERVED = saved


def onehot_gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C); idx (B, T) -> (B, T, C) = flat[b, clip(idx, 0, L-1)]."""
    L = flat.shape[1]
    i = idx.clamp(0, L - 1).long()
    if _OBSERVED is not None:
        rows = i + L * torch.arange(i.shape[0], device=i.device)[:, None]
        _OBSERVED.append(int(torch.unique(rows).numel()))
    return torch.take_along_dim(flat, i[..., None], dim=1)


def weighted_gather(flat: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """flat (B, L, C); idx, w (B, T, K) -> (B, T, C) = sum_k w_k *
    flat[b, clip(idx_k)], w rounded to flat's dtype, summed in f32."""
    B, T, K = idx.shape
    L = flat.shape[1]
    i = idx.clamp(0, L - 1).long().reshape(B, T * K, 1)
    rows = torch.take_along_dim(flat, i, dim=1).reshape(B, T, K, -1)
    wr = w.to(flat.dtype).float()[..., None]
    return (rows.float() * wr).sum(dim=2).to(flat.dtype)


def nms_suppress(iou: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float = 0.45) -> torch.Tensor:
    """iou (B, K, K) of score-sorted boxes; valid (B, K) -> keep (B, K)
    f32: keep starts as valid, and in order each kept i zeroes every
    j > i with iou[i, j] > iou_threshold."""
    iou = iou.float()
    keep = valid.float().clone()
    K = iou.shape[-1]
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=iou.device)
    later = torch.arange(K, device=iou.device)
    for i in range(K):
        alive = keep[:, i:i + 1] > 0.0
        suppress = (iou[:, i, :] > thr) & (later > i) & alive
        keep = keep.masked_fill(suppress, 0.0)
    return keep


def assemble_masks(protos: torch.Tensor, coeffs: torch.Tensor,
                   boxes: torch.Tensor,
                   img_size: Tuple[int, int]) -> torch.Tensor:
    """protos (B, Hp, Wp, P), coeffs (B, K, P), boxes (B, K, 4) in image
    px -> (B, K, Hp, Wp) f32: sigmoid(coeffs . protos) inside each box
    scaled to proto pixels, [x1, x2) x [y1, y2), 0 outside."""
    protos, coeffs = protos.float(), coeffs.float()
    m = torch.sigmoid(torch.einsum("bhwp,bkp->bkhw", protos, coeffs))
    Hp, Wp = m.shape[2:]
    H, W = img_size
    sx, sy = Wp / W, Hp / H
    scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                         device=boxes.device)
    pb = boxes.float() * scale
    ys = torch.arange(Hp, dtype=torch.float32, device=m.device)[:, None]
    xs = torch.arange(Wp, dtype=torch.float32, device=m.device)[None, :]
    x1, y1, x2, y2 = (pb[..., i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return torch.where(inside, m, torch.zeros((), device=m.device))
