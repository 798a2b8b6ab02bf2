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

The per-head weighted sum over points stays plain PyTorch. The per-head
``ms_deformable_attention`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

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
        rows = gather.weighted_gather(
            flat, idx.reshape(B, Q * total_points, 4).contiguous(),
            wts.reshape(B, Q * total_points, 4).to(flat.dtype).contiguous())
    samples = rows.reshape(B, Q, total_points, n_heads, head_dim)
    w = attention_weights.permute(0, 1, 3, 2)[..., None]   # (B, Q, P, h, 1)
    out = (samples * w.to(samples.dtype)).sum(dim=2)
    return out.reshape(B, Q, C)
