"""Tracing and per-step timing.

Counterpart of ``pautdx/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (CPU activity, and CUDA activity where a card is
present) and writes it as a Chrome trace (``chrome://tracing``,
Perfetto); :class:`StepTimer` has the reference's interface and
synchronizes the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json``. Where a card
    is present the device's kernels and copies are in the trace. Yields
    the profiler, whose ``key_averages()`` summarize the block."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Per-step wall timing with a percentile summary and a JSON artifact.

    Use ``with timer.step():`` around each step. With ``sync`` the card's
    work is waited for before the clock is read (accurate); without it the
    time is the host's dispatch. ``result`` is taken for the reference's
    interface: a card is synchronized as a whole."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.perf_counter()
        yield
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)  # drop the first step
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "p99_s": float(np.percentile(t, 99)),
            "total_s": float(np.asarray(self.times).sum()),
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"summary": self.summary(), "times_s": self.times}, f)
