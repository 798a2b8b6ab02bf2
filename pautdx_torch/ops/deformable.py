"""Multi-scale deformable attention sampling, head-shared points.

Counterpart of ``pautdx/ops/deformable.py``. Only the discrete (nearest)
form of ``ms_deformable_attention_shared`` is ported: every level's (H, W)
grid flattens, H x W row-major, into one (sum H*W, C) table per frame, the
HF discrete index ``trunc(loc * size + 0.5)`` is clamped into its level and
offset by the level's base row, and the rows come from the
``ops.gather.onehot_gather`` kernel. The per-head weighted sum over points
stays plain PyTorch.
"""

from __future__ import annotations

from typing import List, Sequence

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


def ms_deformable_attention_shared(value_levels: List[torch.Tensor],
                                   sampling_locations: torch.Tensor,
                                   attention_weights: torch.Tensor,
                                   num_points_list: Sequence[int],
                                   method: str = "default") -> torch.Tensor:
    """value_levels: list of (B, H_l, W_l, n_heads, head_dim);
    sampling_locations: (B, Q, sum_points, 2) normalized [0, 1], shared by
    all heads; attention_weights: (B, Q, n_heads, sum_points) softmaxed.
    Returns (B, Q, n_heads * head_dim)."""
    if method != "discrete":
        raise NotImplementedError(
            f"ms_deformable_attention_shared(method={method!r}) is not "
            f"ported yet: only 'discrete' is (ROADMAP.md, queue 1, item 6, "
            f"the bilinear decoder_method='default')")
    B, Q, total_points, _ = sampling_locations.shape
    n_heads, head_dim = value_levels[0].shape[3], value_levels[0].shape[4]
    C = n_heads * head_dim
    flat = torch.cat([v.reshape(B, -1, C) for v in value_levels], dim=1)
    idx = discrete_indices([v.shape[1:3] for v in value_levels],
                           sampling_locations, num_points_list)
    rows = gather.onehot_gather(flat.contiguous(),
                                idx.reshape(B, Q * total_points).contiguous())
    samples = rows.reshape(B, Q, total_points, n_heads, head_dim)
    w = attention_weights.permute(0, 1, 3, 2)[..., None]   # (B, Q, P, h, 1)
    out = (samples * w.to(samples.dtype)).sum(dim=2)
    return out.reshape(B, Q, C)
