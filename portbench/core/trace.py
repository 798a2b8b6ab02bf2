"""The traced run's record, reduced from ``torch.profiler`` and the
harness's own host spans.

``busy_us`` is a frozen copy of ``pautdx_torch.serve.device_profile``'s
union of device intervals. Device events are kept as plain tuples (name,
start µs, end µs) and the profiler is dropped, so the reduction holds no
trace in memory and writes nothing to disk.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def busy_us(intervals: List[Interval]) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle stretches of [lo, hi] outside the union of ``intervals``."""
    out = []
    cur = lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


COPY = re.compile(r"^Memcpy|^Memset|memcpy", re.IGNORECASE)


@dataclass
class Record:
    """What the per-layer readers read."""
    window_s: float                      # the traced window, host clock
    device: List[Tuple[str, float, float]]   # device events (name, s, e) µs
    host_spans: Dict[str, List[float]]   # span name -> durations, seconds
    batches: int                         # batches or steps in the window
    frames: int                          # frames in the window
    config: dict
    workload: dict
    traffic: dict
    ref_stats: Dict[str, float] = field(default_factory=dict)
    sms: int = 132

    def kernel_us(self, pattern: str) -> Tuple[float, int]:
        """Device µs and launches of the kernels whose names match."""
        rx = re.compile(pattern)
        us, n = 0.0, 0
        for name, s, e in self.device:
            if rx.search(name):
                us += e - s
                n += 1
        return us, n

    def copy_us(self) -> float:
        return sum(e - s for name, s, e in self.device if COPY.search(name))

    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device]) / 1e6


def device_events(prof) -> List[Tuple[str, float, float]]:
    """The kernels, copies and sets the card ran, from a profiler that
    traced the card alone (a host trace of every operator slows the eager
    launches it would measure)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
    return out


def breakdown(rec: Record, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps, each [name, seconds]. A gap is labelled by the device operation
    that ended it: the card sat waiting while the host prepared that
    launch or copy."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in rec.device:
        by_name[name[:160]] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    if not rec.device:
        return {"device_ops": [], "idle_gaps": []}
    lo = min(s for _, s, _ in rec.device)
    hi = max(e for _, _, e in rec.device)
    idle = sorted(gaps([(s, e) for _, s, e in rec.device], lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    starts = sorted((s, name) for name, s, _ in rec.device)
    keys = [s for s, _ in starts]

    def label(t: float) -> str:
        i = bisect.bisect_left(keys, t)
        nxt = starts[i][1] if i < len(starts) else "the window's end"
        return ("host before " + nxt)[:160]

    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[label(e), (e - s) / 1e6] for s, e in idle]}
