"""Tracing, the port's spans, and per-step timing.

Counterpart of ``pautdx/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (CPU activity, and CUDA activity where a card is
present) and writes it as a Chrome trace (``chrome://tracing``,
Perfetto); :class:`StepTimer` has the reference's interface and
synchronizes the device before it reads the clock.

:data:`TRACER` is the port's one span mechanism. ``with span(name):``
marks a stretch of host work at a layer boundary of the port. A span is
on exactly while a ``torch.profiler`` session is active; off, it is one
flag read and a shared null context. On, it opens a
``torch.profiler.record_function`` range of its name (so a trace with host
activity shows it) and keeps (name, parent, call, start, end) in a bounded
buffer, which a new session clears. The spans' clock is the one the
profiler maps device timestamps onto; the first top-level span of a
session, and one every ``ANCHOR_EVERY_NS`` after, stamps it and launches
an anchor kernel on a side stream, whose start in the device trace puts
every span on the device's axis (:meth:`Tracer.device_axis`).
:meth:`Tracer.summary` gives calls, total and self ms a span name, and
the launch-path counters (the kernel launches of ``pautdx_torch.ops``,
the served graph's captures and replays) a call of each top-level span.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _session

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


# ------------------------------------------------------------------- spans

# the clock of the spans and anchors: kineto maps the device's timestamps
# onto the wall clock, so the wall clock drifts least against them
CLOCK = time.time_ns
# ``torch.cuda._sleep``'s kernel, the anchor; the port launches it nowhere
# else, so a reader finds the anchors in a device trace by this name
ANCHOR_KERNEL = "spin_kernel"
# a session re-anchors at its first top-level span past this long since
# the last anchor. The device trace's timestamps drift against the host's
# clocks: by 10-300 ppm, near one rate, in the serving windows read on the
# H100's host, and by thousands of ppm at changing rates in a process's
# later sessions; so the device axis interpolates between anchors this
# close
ANCHOR_EVERY_NS = 50_000_000
# an anchor whose offset lies further than this from the line through its
# two neighbours on each side was launched slowly (a session's first
# launch of the kernel can take 2 ms) and is left out
ANCHOR_JITTER_US = 30.0
CAPACITY = 1 << 16
# the launch-path counters: the per-op kernel-launch counters of
# ``pautdx_torch.ops``, then the served graph's (``serve/graphs.py``):
# (label, module, attribute)
LAUNCH_COUNTERS = (
    ("aifi_attention", "pautdx_torch.ops.attention", "LAUNCHES"),
    ("onehot_gather", "pautdx_torch.ops.gather", "LAUNCHES"),
    ("onehot_gather_backward", "pautdx_torch.ops.gather",
     "ONEHOT_BACKWARD_LAUNCHES"),
    ("weighted_gather", "pautdx_torch.ops.gather", "WEIGHTED_LAUNCHES"),
    ("weighted_gather_backward", "pautdx_torch.ops.gather",
     "WEIGHTED_BACKWARD_LAUNCHES"),
    ("nms_suppress", "pautdx_torch.ops.suppress", "LAUNCHES"),
    ("assemble_masks", "pautdx_torch.ops.masks", "LAUNCHES"),
    ("int8_conv", "pautdx_torch.ops.qconv", "LAUNCHES"),
    # captures and replays of the served D-FINE forward's CUDA graphs
    ("dfine_graph_capture", "pautdx_torch.serve.graphs", "CAPTURES"),
    ("dfine_graph_replay", "pautdx_torch.serve.graphs", "REPLAYS"),
)


def launch_counts() -> Dict[str, int]:
    """The launch counters as they stand (0 for an op not imported)."""
    out = {}
    for label, module, attr in LAUNCH_COUNTERS:
        out[label] = getattr(sys.modules.get(module), attr, 0)
    return out


def advance_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (label -> launches, of ``LAUNCH_COUNTERS``) to the
    counters: a CUDA graph's replay runs the kernels its capture counted."""
    for label, module, attr in LAUNCH_COUNTERS:
        if counts.get(label):
            mod = sys.modules[module]
            setattr(mod, attr, getattr(mod, attr) + counts[label])


class SpanRecord(NamedTuple):
    id: int
    name: str
    parent: Optional[int]        # the enclosing span's id
    call: int                    # the id of the top-level span it lies in
    start_ns: int                # ``CLOCK``
    end_ns: int
    # a top-level span's change of the launch counters (those that moved)
    launches: Optional[Dict[str, int]]


class DeviceAxis(NamedTuple):
    """The clock's ns onto a device trace's µs: µs since ``ref_ns`` plus
    the anchors' offset there, interpolated between anchors (the nearest
    anchor's beyond them). Times are taken from ``ref_ns`` in integers
    first: a wall-clock ns count divided as a float keeps only quarters of
    a µs."""
    ref_ns: int                        # the session's first anchor's stamp
    at_us: Tuple[float, ...]           # the anchors kept, µs since ref_ns
    offsets_us: Tuple[float, ...]      # their offsets

    def __call__(self, t_ns: int) -> float:
        x = (t_ns - self.ref_ns) / 1e3
        return x + float(np.interp(x, self.at_us, self.offsets_us))


class _Open:
    __slots__ = ("name", "id", "parent", "call", "start_ns", "range",
                 "counts")


class _Span:
    __slots__ = ("tracer", "name", "open")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.open = self.tracer.begin(self.name)

    def __exit__(self, *exc):
        self.tracer.end(self.open)
        return False


class _Null:
    """The shared null context of a span while the profiler is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Null()


class Tracer:
    """Spans kept in memory while a ``torch.profiler`` session is active.

    A session of the tracer starts at the first span that finds the
    profiler on after a span, a read (:meth:`spans`, :meth:`summary`) or
    :meth:`reset` found it off: the buffer and the anchors are cleared
    then, so they hold one profiler session's spans. Spans nest per
    thread."""

    def __init__(self):
        self.records: Deque[SpanRecord] = deque(maxlen=CAPACITY)
        # ``CLOCK`` as each anchor's launch returned; the session's k-th
        # anchor is the k-th ``ANCHOR_KERNEL`` of its device trace
        self.anchors: List[int] = []
        self._live = False
        self._next_anchor_ns = 0
        self._ids = itertools.count()
        self._local = threading.local()
        self._streams: Dict[int, torch.cuda.Stream] = {}

    # ---- the switch

    def span(self, name: str):
        """``with span(name):`` a span while the profiler runs; off, the
        shared null context."""
        if not _session._is_profiler_enabled:
            if self._live:
                self._live = False
            return _OFF
        return _Span(self, name)

    def begin(self, name: str) -> Optional[_Open]:
        """Open a span by hand (forward hooks); ``end`` closes it. None
        while the profiler is off."""
        if not _session._is_profiler_enabled:
            if self._live:
                self._live = False
            return None
        if not self._live:
            self._start()
        stack = self._stack()
        if not stack and CLOCK() >= self._next_anchor_ns:
            self.anchor()
        o = _Open()
        o.name, o.id = name, next(self._ids)
        if stack:
            o.parent, o.call, o.counts = stack[-1].id, stack[-1].call, None
        else:
            o.parent, o.call, o.counts = None, o.id, launch_counts()
        o.range = torch.profiler.record_function(name)
        o.range.__enter__()
        stack.append(o)
        o.start_ns = CLOCK()
        return o

    def end(self, o: Optional[_Open]) -> None:
        if o is None:
            return
        t = CLOCK()
        o.range.__exit__(None, None, None)
        stack = self._stack()
        if stack and stack[-1] is o:
            stack.pop()
        launches = None
        if o.counts is not None:
            now = launch_counts()
            launches = {k: now[k] - v for k, v in o.counts.items()
                        if now[k] != v}
        self.records.append(SpanRecord(o.id, o.name, o.parent, o.call,
                                       o.start_ns, t, launches))

    def reset(self) -> None:
        """End the tracer's session: the next span starts a new one."""
        self._live = False

    def _start(self) -> None:
        self.records.clear()
        self.anchors = []
        self._ids = itertools.count()
        self._local = threading.local()
        self._next_anchor_ns = 0
        self._live = True

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ---- the anchor

    def anchor(self) -> None:
        """Launch the anchor kernel on the tracer's side stream and stamp
        the clock as the launch returns (the launch call's own host time,
        10-100 µs, lies before the stamp; the kernel starts a steady few µs
        after it returns). Nothing where the process has not initialized
        CUDA, and nothing while the current stream is capturing a graph
        (the next top-level span tries again). No synchronize."""
        if not torch.cuda.is_initialized():
            self._next_anchor_ns = float("inf")
            return
        if torch.cuda.is_current_stream_capturing():
            return
        with torch.cuda.stream(self._side(torch.cuda.current_device())):
            torch.cuda._sleep(1)
            stamp = CLOCK()
        self.anchors.append(stamp)
        self._next_anchor_ns = stamp + ANCHOR_EVERY_NS

    def prepare(self, device) -> None:
        """Make the side stream of ``device`` and, outside a profiler
        session, load the anchor kernel by one launch on it, so that a
        session's first anchor costs a launch: the first side stream of a
        process creates PyTorch's stream pool (about 20 ms on the H100's
        host), and a kernel's first launch loads it.
        ``build_serving_model`` and ``build_yolo_predictor`` call it; a
        no-op off CUDA."""
        device = torch.device(device)
        if device.type != "cuda":
            return
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        stream = self._side(index)
        if not _session._is_profiler_enabled:
            with torch.cuda.stream(stream):
                torch.cuda._sleep(1)

    def _side(self, index: int) -> torch.cuda.Stream:
        stream = self._streams.get(index)
        if stream is None:
            stream = self._streams[index] = torch.cuda.Stream(index,
                                                              priority=-1)
        return stream

    def device_offsets_us(self, device: Sequence[Tuple[str, float, float]]
                          ) -> List[float]:
        """For each anchor of the session found in ``device`` (the device
        events of its trace, (name, start µs, end µs)), its kernel's start
        less its stamp in µs since the session's first anchor: without
        drift, the same number for every anchor."""
        starts = sorted(s for name, s, _ in device if ANCHOR_KERNEL in name)
        if not self.anchors:
            return []
        ref = self.anchors[0]
        return [start - (stamp - ref) / 1e3
                for stamp, start in zip(self.anchors, starts)]

    def device_axis(self, device: Sequence[Tuple[str, float, float]]
                    ) -> Optional[DeviceAxis]:
        """The session's anchors found in ``device``, less those launched
        slowly (``ANCHOR_JITTER_US``), as a map of the clock onto the
        device's axis; None without an anchor."""
        offsets = self.device_offsets_us(device)
        if not offsets:
            return None
        ref = self.anchors[0]
        xs = [(stamp - ref) / 1e3 for stamp in self.anchors[:len(offsets)]]
        # leave out the anchor furthest from its neighbours' line, again
        # and again, until every one left lies on it
        while len(xs) > 2:
            far = [abs(offsets[i] - _from_neighbours(xs, offsets, i))
                   for i in range(len(xs))]
            worst = int(np.argmax(far))
            if far[worst] <= ANCHOR_JITTER_US:
                break
            del xs[worst], offsets[worst]
        return DeviceAxis(ref, tuple(xs), tuple(offsets))

    # ---- reads

    def spans(self) -> List[SpanRecord]:
        """The session's spans, in the order they closed."""
        self._read()
        return list(self.records)

    def summary(self) -> Dict[str, dict]:
        """``spans``: calls, total ms and self ms (less the spans directly
        inside) by span name; ``launches``: by top-level span name, the
        launch counters' change a call."""
        recs = self.spans()
        inner: Dict[int, int] = defaultdict(int)
        for r in recs:
            if r.parent is not None:
                inner[r.parent] += r.end_ns - r.start_ns
        spans: Dict[str, dict] = {}
        launched: Dict[str, Dict[str, int]] = {}
        for r in recs:
            d = r.end_ns - r.start_ns
            s = spans.setdefault(r.name, {"calls": 0, "total_ms": 0.0,
                                          "self_ms": 0.0})
            s["calls"] += 1
            s["total_ms"] += d / 1e6
            s["self_ms"] += (d - inner[r.id]) / 1e6
            if r.launches is not None:
                per = launched.setdefault(r.name, {})
                for k, v in r.launches.items():
                    per[k] = per.get(k, 0) + v
        return {"spans": spans,
                "launches": {n: {k: v / spans[n]["calls"]
                                 for k, v in per.items()}
                             for n, per in launched.items()}}

    def _read(self) -> None:
        if not _session._is_profiler_enabled:
            self._live = False


def _from_neighbours(xs: List[float], ys: List[float], i: int) -> float:
    """``ys[i]`` as its two neighbours on each side put it: through each
    of them at the median slope between consecutive ones, the median.
    ``ys[i]`` itself where it has fewer than two."""
    near = [j for j in range(max(0, i - 2), min(len(xs), i + 3)) if j != i]
    if len(near) < 2:
        return ys[i]
    slope = float(np.median([(ys[b] - ys[a]) / (xs[b] - xs[a])
                             for a, b in zip(near, near[1:])]))
    return float(np.median([ys[j] + slope * (xs[i] - xs[j])
                            for j in near]))


TRACER = Tracer()
span = TRACER.span
