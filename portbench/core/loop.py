"""The closed serving loop: host frames in, host answers out.

A batch is timed from its submission, its frames still in pinned host
memory, until its answers are in pinned host memory, as the host sees it.
``in_flight`` batches are kept submitted ahead (work dispatched while the
card runs the one before); the next batch is submitted once the oldest is
back. Submissions stop when the window's seconds are up; the window ends
when the last batch in flight is back, and every batch submitted counts.

A batch drawn for the check keeps a copy of its answers made on the
device, in stream order, as they were produced: a host copy of a batch's
masks (82 MB for YOLOv8n-seg at 32 frames) would stall the loop at random
places of the window, and a program that reuses its output buffers (a
captured graph) would overwrite answers kept by reference.
"""

from __future__ import annotations

import random
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

# the harness's host spans: a batch's submission (its copy in, the port's
# call and its copy out, enqueued), the port's call alone, and the wait
# for the oldest batch to come back
SPANS = ("serve.submit", "serve.call", "serve.wait")


@dataclass
class Sample:
    ordinal: int               # the batch's place in the window
    ring_batch: int            # which batch of the frame ring it served
    served: Dict[str, torch.Tensor]   # its answers, as produced
    extra: Dict[str, torch.Tensor]    # what the check follows


@dataclass
class Window:
    seconds: float = 0.0
    batches: int = 0
    frames: int = 0
    latencies_s: List[float] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(
        default_factory=lambda: {s: [] for s in SPANS})
    samples: List[Sample] = field(default_factory=list)


class Spans:
    """Host spans kept in memory, their durations by name."""

    def __init__(self, window: Window):
        self.window = window

    @contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        yield
        self.window.spans[name].append(time.perf_counter() - t)


def run(step: Callable, ring: torch.Tensor, batch: int, in_flight: int,
        seconds: float, device: torch.device, keep: int = 0,
        seed: int = 0, max_batches: Optional[int] = None) -> Window:
    """Serve batches of ``ring`` (pinned (n, H, W, 3) uint8 frames, taken in
    turn) through ``step(frames_on_device) -> (served, extra)`` for
    ``seconds``, or ``max_batches`` batches. ``keep`` batches of the window
    are kept for the check, a uniform sample drawn from ``seed`` as the
    batches are submitted (reservoir sampling)."""
    w = Window()
    spans = Spans(w)
    n_ring = ring.shape[0] // batch
    rng = random.Random(seed)
    pending = deque()
    slots: List[Optional[Dict[str, torch.Tensor]]] = [None] * in_flight
    reservoir: List[Sample] = []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        now = time.perf_counter()
        submitting = now < deadline and (max_batches is None
                                         or i < max_batches)
        if not submitting and not pending:
            break
        if submitting and len(pending) < in_flight:
            j = i % n_ring
            slot = i % in_flight
            if keep and i < keep:
                place = i
            elif keep:
                r = rng.randrange(i + 1)
                place = r if r < keep else None
            else:
                place = None
            t_sub = time.perf_counter()
            with spans("serve.submit"):
                x = ring[j * batch:(j + 1) * batch].to(device,
                                                       non_blocking=True)
                with spans("serve.call"):
                    served, extra = step(x)
                kept = None
                if place is not None:
                    kept = ({n: t.clone() for n, t in served.items()},
                            {n: t.clone() for n, t in extra.items()})
                if slots[slot] is None:
                    slots[slot] = {k: torch.empty(v.shape, dtype=v.dtype,
                                                  pin_memory=device.type
                                                  == "cuda")
                                   for k, v in served.items()}
                host = slots[slot]
                for k, v in served.items():
                    host[k].copy_(v, non_blocking=True)
                ev = None
                if device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
            pending.append((i, j, t_sub, ev, place, kept))
            i += 1
            continue
        k, j, t_sub, ev, place, kept = pending.popleft()
        with spans("serve.wait"):
            if ev is not None:
                ev.synchronize()
        w.latencies_s.append(time.perf_counter() - t_sub)
        w.batches += 1
        w.frames += batch
        if place is not None:
            s = Sample(k, j, *kept)
            if place < len(reservoir):
                reservoir[place] = s
            else:
                reservoir.append(s)
    w.seconds = time.perf_counter() - t0
    w.samples = sorted(reservoir, key=lambda s: s.ordinal)
    return w
