"""Multi-scale deformable attention sampling, head-shared points.

Counterpart of ``pautdx/ops/deformable.py``: the two head-shared forms of
``ms_deformable_attention_shared``. Every level's (H, W) grid flattens,
H x W row-major, into one (sum H*W, C) table per frame.

- ``method="discrete"`` (nearest): the HF discrete index
  ``trunc(loc * size + 0.5)`` is clamped into its level and offset by the
  level's base row; the rows come from the ``ops.gather.onehot_gather``
  kernel, which has a backward: the value levels and the attention weights
  get gradients, the locations none (the nearest index is a step), as in
  the reference.
- ``method="default"`` (bilinear, ``grid_sample`` with
  ``align_corners=False`` and zeros padding): each point's four corner rows,
  clamped into the level, and their weights, computed in f32 and zero for
  corners off the grid, go to the ``ops.gather.weighted_gather`` kernel,
  which has a backward. Locations and attention weights stay
  differentiable.

The per-head weighted sum over points stays plain PyTorch.

:func:`ms_deformable_attention` is the per-head form (a set of points for
every head, the HF-architecture configs): plain PyTorch, as the reference
computes it outside any Pallas kernel, with its arithmetic:
``bilinear_sample_nhwc`` (one zero-padded 2x2 window per point, weights in
the value dtype) and ``nearest_sample_nhwc`` (``trunc((loc * W - 0.5) +
1.0)``, clamped).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from pautdx_torch.ops import gather


def discrete_indices(spatial_shapes: Sequence[Sequence[int]],
                     sampling_locations: torch.Tensor,
                     num_points_list: Sequence[int]) -> torch.Tensor:
    """(B, Q, sum_P, 2) normalized locations -> (B, Q, sum_P) int32 rows of
    the level-concat table."""
    parts = []
    offset = 0
    base = 0
    for (H, W), P in zip(spatial_shapes, num_points_list):
        loc = sampling_locations[:, :, offset:offset + P, :]
        # .to(int32) truncates toward zero, as the reference's astype does
        # (torch.round would round half to even)
        xi = (loc[..., 0] * W + 0.5).to(torch.int32).clamp(0, W - 1)
        yi = (loc[..., 1] * H + 0.5).to(torch.int32).clamp(0, H - 1)
        parts.append(yi * W + xi + base)
        offset += P
        base += H * W
    return torch.cat(parts, dim=2)


def bilinear_taps(spatial_shapes: Sequence[Sequence[int]],
                  sampling_locations: torch.Tensor,
                  num_points_list: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Q, sum_P, 2) normalized locations -> the four bilinear corners of
    each point as rows of the level-concat table, (B, Q, sum_P, 4) int32,
    and their weights, (B, Q, sum_P, 4) f32, in the corner order (0, 0),
    (0, 1), (1, 0), (1, 1) of ``pautdx/ops/deformable.py:220-223``. A corner
    off its level's grid keeps a clamped row and gets weight 0. The weights
    carry the gradient to the locations; the rows carry none."""
    idx_parts, w_parts = [], []
    offset = 0
    base = 0
    for (H, W), P in zip(spatial_shapes, num_points_list):
        loc = sampling_locations[:, :, offset:offset + P, :].float()
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.detach().to(torch.int32)
        y0i = y0.detach().to(torch.int32)
        corners, weights = [], []
        for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)),
                            (0, 1, fx * (1 - fy)),
                            (1, 0, (1 - fx) * fy),
                            (1, 1, fx * fy)):
            xi = x0i + dx
            yi = y0i + dy
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            corners.append(yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
                           + base)
            weights.append(torch.where(inb, wgt, torch.zeros_like(wgt)))
        idx_parts.append(torch.stack(corners, dim=-1))
        w_parts.append(torch.stack(weights, dim=-1))
        offset += P
        base += H * W
    return torch.cat(idx_parts, dim=2), torch.cat(w_parts, dim=2)


def ms_deformable_attention_shared(value_levels: List[torch.Tensor],
                                   sampling_locations: torch.Tensor,
                                   attention_weights: torch.Tensor,
                                   num_points_list: Sequence[int],
                                   method: str = "default") -> torch.Tensor:
    """value_levels: list of (B, H_l, W_l, n_heads, head_dim);
    sampling_locations: (B, Q, sum_points, 2) normalized [0, 1], shared by
    all heads; attention_weights: (B, Q, n_heads, sum_points) softmaxed.
    Returns (B, Q, n_heads * head_dim)."""
    if method not in ("default", "discrete"):
        raise NotImplementedError(
            f"ms_deformable_attention_shared(method={method!r}): the "
            f"methods are 'default' (bilinear) and 'discrete'")
    B, Q, total_points, _ = sampling_locations.shape
    n_heads, head_dim = value_levels[0].shape[3], value_levels[0].shape[4]
    C = n_heads * head_dim
    flat = torch.cat([v.reshape(B, -1, C) for v in value_levels],
                     dim=1).contiguous()
    shapes = [v.shape[1:3] for v in value_levels]
    if method == "discrete":
        idx = discrete_indices(shapes, sampling_locations, num_points_list)
        rows = gather.onehot_gather(
            flat, idx.reshape(B, Q * total_points).contiguous())
    else:
        idx, wts = bilinear_taps(shapes, sampling_locations, num_points_list)
        # f32 weights, as the reference passes them: the kernel rounds them
        # to flat's dtype, and their gradient stays f32
        rows = gather.weighted_gather(
            flat, idx.reshape(B, Q * total_points, 4).contiguous(),
            wts.reshape(B, Q * total_points, 4).contiguous())
    samples = rows.reshape(B, Q, total_points, n_heads, head_dim)
    w = attention_weights.permute(0, 1, 3, 2)[..., None]   # (B, Q, P, h, 1)
    out = (samples * w.to(samples.dtype)).sum(dim=2)
    return out.reshape(B, Q, C)


def _flat_rows(value: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """value (B, H, W, C); rows (B, n) flat H x W indices -> (B, n, C)."""
    B, H, W, C = value.shape
    return torch.take_along_dim(value.reshape(B, H * W, C),
                                rows.long()[..., None], dim=1)


def bilinear_sample_nhwc(value: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling, as ``pautdx/ops/deformable.py:22-82``
    computes it. value (B, H, W, C); x, y (B, ...) center-aligned pixel
    coordinates (x = x_norm * W - 0.5) -> (B, ..., C). The four corners
    come from the value padded by one pixel on every side; the weights
    are computed in the value dtype, a corner past the pad gets weight 0,
    and the four products are summed in that order, in the value dtype."""
    B, H, W, C = value.shape
    batch_shape = x.shape[1:]
    x = x.reshape(B, -1)
    y = y.reshape(B, -1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f).to(value.dtype)
    wy = (y - y0f).to(value.dtype)
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    vp = F.pad(value, (0, 0, 1, 1, 1, 1))
    xs = (x0 + 1).clamp(0, W)            # the window's start, padded grid
    ys = (y0 + 1).clamp(0, H)
    in_x0 = (x0 >= -1) & (x0 <= W - 1)
    in_x1 = (x0 + 1 >= 0) & (x0 + 1 <= W)
    in_y0 = (y0 >= -1) & (y0 <= H - 1)
    in_y1 = (y0 + 1 >= 0) & (y0 + 1 <= H)

    def corner(dy, dx):
        return _flat_rows(vp, (ys + dy) * (W + 2) + xs + dx)

    w00 = ((1 - wx) * (1 - wy) * in_x0 * in_y0)[..., None]
    w01 = (wx * (1 - wy) * in_x1 * in_y0)[..., None]
    w10 = ((1 - wx) * wy * in_x0 * in_y1)[..., None]
    w11 = (wx * wy * in_x1 * in_y1)[..., None]
    out = (corner(0, 0) * w00 + corner(0, 1) * w01
           + corner(1, 0) * w10 + corner(1, 1) * w11)
    return out.reshape(B, *batch_shape, C)


def nearest_sample_nhwc(value: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """HF D-FINE's discrete sampling, as ``pautdx/ops/deformable.py:85-111``
    computes it: from the same center-aligned coordinates as
    :func:`bilinear_sample_nhwc`, the index is ``trunc(x + 1.0)`` clamped
    into the grid. (In float, ``(loc * W - 0.5) + 1.0`` is not always
    ``loc * W + 0.5``, the head-shared path's formula.)"""
    B, H, W, C = value.shape
    batch_shape = x.shape[1:]
    xi = (x + 1.0).to(torch.int32).clamp(0, W - 1).reshape(B, -1)
    yi = (y + 1.0).to(torch.int32).clamp(0, H - 1).reshape(B, -1)
    return _flat_rows(value, yi * W + xi).reshape(B, *batch_shape, C)


def ms_deformable_attention(value_levels: List[torch.Tensor],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            num_points_list: Sequence[int],
                            method: str = "default") -> torch.Tensor:
    """Per-head sampling points. value_levels: list of (B, H_l, W_l,
    n_heads, head_dim); sampling_locations: (B, Q, n_heads, sum_points, 2)
    normalized [0, 1]; attention_weights: (B, Q, n_heads, sum_points)
    softmaxed. method: "default" (bilinear) | "discrete" (nearest).
    Returns (B, Q, n_heads * head_dim); the sum over points runs in the
    promoted dtype of the samples and the weights, as in the reference."""
    if method not in ("default", "discrete"):
        raise NotImplementedError(
            f"ms_deformable_attention(method={method!r}): the methods are "
            f"'default' (bilinear) and 'discrete'")
    B, Q, n_heads, total_points, _ = sampling_locations.shape
    head_dim = value_levels[0].shape[-1]
    sample = (nearest_sample_nhwc if method == "discrete"
              else bilinear_sample_nhwc)
    offset = 0
    sampled = []
    for value, P in zip(value_levels, num_points_list):
        H, W = value.shape[1:3]
        loc = sampling_locations[:, :, :, offset:offset + P, :]
        # heads folded into the batch axis: one gather per level
        v = value.permute(0, 3, 1, 2, 4).reshape(B * n_heads, H, W, head_dim)
        loc_bh = loc.permute(0, 2, 1, 3, 4).reshape(B * n_heads, Q, P, 2)
        x = loc_bh[..., 0] * W - 0.5
        y = loc_bh[..., 1] * H - 0.5
        s = sample(v, x, y)                         # (B*h, Q, P, d)
        sampled.append(s.reshape(B, n_heads, Q, P, head_dim)
                       .permute(0, 2, 1, 3, 4))     # (B, Q, h, P, d)
        offset += P
    samples = torch.cat(sampled, dim=3)             # (B, Q, h, sum_P, d)
    out = (samples * attention_weights[..., None]).sum(dim=3)
    return out.reshape(B, Q, n_heads * head_dim)
