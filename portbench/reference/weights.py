"""Seeded weights, made by the benchmark on the device as a state dict of
the frozen reference, and handed the same to the port and the reference.

One ``torch.Generator`` on the device draws every weight of rank >= 2 in
one call, each leaf then scaled to N(0, 1/fan_in) (the scale of the
reference's LeCun-normal init); 1-d weights and scales are 1, biases 0.
BatchNorm's running statistics are then those of one forward in training
mode over a few seeded frames (each layer's statistics taken whole,
momentum 0), as a trained model's are of its data: with mean 0 and
variance 1 instead, activations grow through the depth until the heads'
sigmoids and the box bins saturate, and a comparison of served scores and
boxes would read rounding of nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from portbench.reference.common import BatchNorm


CALIBRATION_FRAMES = 4


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int,
                      frame_size: Tuple[int, int, int]
                      ) -> Dict[str, torch.Tensor]:
    """Seeded weights and statistics of ``model`` (which takes (B, H, W,
    C) float frames in [0, 1]), set in place and returned as a copy."""
    params = dict(model.named_parameters())
    big = [(n, p) for n, p in params.items() if p.dim() >= 2]
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    draw = torch.randn(sum(p.numel() for _, p in big), generator=gen,
                       device=dev, dtype=torch.float32)
    at = 0
    for n, p in big:
        k = p.numel()
        p.copy_(draw[at:at + k].view_as(p) * p[0].numel() ** -0.5)
        at += k
    for n, p in params.items():
        if p.dim() < 2:
            p.fill_(0.0 if n.rpartition(".")[2].startswith("bias") else 1.0)
    frames = torch.randint(0, 256, (CALIBRATION_FRAMES, *frame_size),
                           generator=gen, device=dev,
                           dtype=torch.uint8).float() / 255.0
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 0.0
    model.train()
    model(frames)
    model.eval()
    for m, mom in zip(norms, saved):
        m.momentum = mom
    return {k: v.clone() for k, v in model.state_dict().items()}
