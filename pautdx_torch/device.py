"""The one place that decides which device an entry point runs on."""

from __future__ import annotations

from typing import Optional, Union

import torch

# what an entry point's ``device`` argument takes
Device = Optional[Union[str, torch.device]]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises:
    the port never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pautdx_torch: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"pautdx_torch: unsupported device {dev}")
    return dev
