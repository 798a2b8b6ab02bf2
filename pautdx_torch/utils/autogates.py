"""Auto-gating: the sample intervals of a D-scan that hold structure
echoes.

Counterpart of ``pautdx/utils/autogates.py``: ``row_statistics`` and
``find_gates`` are the reference's numpy, copied (the mean |amplitude| a
sample over the scans, its first and second differences, and gates
between peak pairs of the second difference above max / 4);
``gate_mask`` zeroes each signal outside [start, end) on the signals'
device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def row_statistics(dscan: np.ndarray) -> np.ndarray:
    """Mean |amplitude| per sample position over all scans: (S,)."""
    return np.abs(dscan).mean(axis=0)


def find_gates(dscan: np.ndarray, threshold_div: float = 4.0,
               min_width: int = 3) -> List[Tuple[int, int]]:
    """Gate intervals from second-derivative peak pairs."""
    stats = row_statistics(dscan)
    d1 = np.gradient(stats)
    d2 = np.gradient(d1)
    mag = np.abs(d2)
    thresh = mag.max() / threshold_div
    candidates = np.nonzero(mag >= thresh)[0]
    if candidates.size == 0:
        return [(0, stats.shape[0])]
    # group consecutive candidate indices into peaks
    groups = np.split(candidates, np.nonzero(np.diff(candidates) > 2)[0] + 1)
    peaks = [int(g.mean()) for g in groups]
    gates: List[Tuple[int, int]] = []
    for a, b in zip(peaks[:-1], peaks[1:]):
        if b - a >= min_width and stats[a:b].mean() > stats.mean():
            gates.append((a, b))
    if not gates:   # fall back to the span between the outermost peaks
        gates = [(peaks[0], max(peaks[-1], peaks[0] + min_width))]
    return gates


def gate_mask(signals: torch.Tensor, start, end) -> torch.Tensor:
    """Zero outside [start, end) along the sample axis; ``start`` and
    ``end`` are numbers or tensors that broadcast against ``signals``'
    leading axes with a trailing axis of 1."""
    idx = torch.arange(signals.shape[-1], device=signals.device)
    mask = (idx >= torch.as_tensor(start, device=signals.device)) & \
        (idx < torch.as_tensor(end, device=signals.device))
    return signals * mask
