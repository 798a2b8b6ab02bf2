"""Sequence windowing over per-beam scan axes.

Counterpart of ``pautdx/data/windowing.py``. Long frame or beam stacks go
through fixed-length windows, returned as (start, end) index pairs so
callers slice frames, signals, labels and positions alike:

- **chunked**: ``ceil(n/L)`` windows of length L; all but the last start
  at ``i*L``, the last is re-anchored to ``n - L`` (overlapping the one
  before). The temporal runner's chunking.
- **overlapping**: sliding windows whose stride puts the first at 0 and
  the last at ``n - L``.
- **padded**: a stack shorter than L, zero-padded up to it.
"""

from __future__ import annotations

import math
from typing import List, Tuple


def chunked_windows(n: int, seq_len: int) -> List[Tuple[int, int]]:
    """Chunking with the tail re-anchored; [] if n < seq_len."""
    if n < seq_len:
        return []
    n_seqs = math.ceil(n / seq_len)
    starts = [i * seq_len for i in range(n_seqs - 1)] + [n - seq_len]
    return [(a, a + seq_len) for a in starts]


def overlapping_windows(n: int, seq_len: int) -> List[Tuple[int, int]]:
    """Evenly spaced overlapping windows covering [0, n); [] if
    n < seq_len."""
    if n < seq_len:
        return []
    n_windows = math.ceil((n - seq_len) / seq_len) + 1
    if n_windows == 1:
        return [(0, seq_len)]
    stride = (n - seq_len) / (n_windows - 1)
    return [(round(i * stride), round(i * stride) + seq_len)
            for i in range(n_windows)]


def padded_window(n: int, seq_len: int) -> Tuple[int, int, int]:
    """A short stack: (start, end, pad) to zero-pad up to seq_len."""
    return (0, n, seq_len - n)
