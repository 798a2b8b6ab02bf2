"""Readers of the port's own spans (``pautdx_torch.utils.profiling``).

A traced run's profiler session is the port's tracer's session: the spans
that the port's serving paths opened in the window stay in the tracer's
buffer after the profiler stops, until a new session starts. The tracer's
anchor kernel, found in the device trace by name, puts them on the device
trace's axis. Each reader returns None where the program has no tracer or
the session kept no span (or no anchor), and raises nothing.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Optional

from portbench.core.trace import Interval, busy_us, gaps


def tracer():
    """The port's tracer, or None where the program has none."""
    try:
        from pautdx_torch.utils import profiling
    except ImportError:
        return None
    t = getattr(profiling, "TRACER", None)
    if t is None or not hasattr(t, "spans") \
            or not hasattr(t, "device_axis"):
        return None
    return t


def records() -> list:
    t = tracer()
    return t.spans() if t is not None else []


def host_ms(names: Iterable[str]) -> Optional[float]:
    """Host ms a call of the spans named, summed within each top-level call
    of the port, the mean over the calls that hold one."""
    names = set(names)
    by_call = defaultdict(float)
    for r in records():
        if r.name in names:
            by_call[r.call] += (r.end_ns - r.start_ns) / 1e6
    return sum(by_call.values()) / len(by_call) if by_call else None


def aligned(rec, names: Iterable[str]) -> Optional[List[Interval]]:
    """The top-level spans named, as (start µs, end µs) on the axis of
    ``rec.device``, by the line through the session's anchors."""
    t = tracer()
    if t is None or not rec.device:
        return None
    axis = t.device_axis(rec.device)
    if axis is None:
        return None
    names = set(names)
    out = [(axis(r.start_ns), axis(r.end_ns))
           for r in t.spans() if r.parent is None and r.name in names]
    return out or None


def idle_inside_us(rec, names: Iterable[str]) -> Optional[float]:
    """Device µs with no kernel or copy running while the host was inside
    one of the port's top-level spans ``names``. The idle gaps are those
    between the first and the last device event (``trace.gaps``)."""
    spans = aligned(rec, names)
    if spans is None:
        return None
    intervals = [(s, e) for _, s, e in rec.device]
    lo = min(s for s, _ in intervals)
    hi = max(e for _, e in intervals)
    idle = gaps(intervals, lo, hi)
    inside = [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]
    # the gaps' overlap with the spans: |A| + |B| - |A u B|
    return max(0.0, busy_us(idle) + busy_us(inside) - busy_us(idle + inside))


def launch_idle_share(rec, names: Iterable[str]) -> Optional[float]:
    """Share of the traced window, in %, in which the card sat idle while
    the host was inside one of the port's top-level spans ``names``: the
    card starved by the port's own launch path. At most the window's idle
    share, of which it is a part."""
    us = idle_inside_us(rec, names)
    if us is None or rec.window_s <= 0:
        return None
    return 100.0 * us / 1e6 / rec.window_s
