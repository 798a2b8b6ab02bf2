"""Host-thread batch assembly and the host-to-device pipeline.

Counterpart of ``pautdx/data/prefetch.py``: :class:`ThreadedHostLoader`
runs parsing, batching and augmentation on a background thread, so the
training loop does not wait on numpy work; :func:`device_prefetch` keeps
``size`` batches' copies from pinned host memory (``non_blocking``)
enqueued ahead of the step that uses them, the ``Trainer``'s input
pipeline.

With a dp placement (``sharding=mesh.batch_sharding(mesh)``, the
reference's ``sharding=``), each rank copies only its own rows of every
global batch. A ragged batch, whose rows do not divide by the dp size, is
padded to ``mesh.pad_to_multiple(n, dp)`` rows first and carries a
``row_mask`` (``mesh.pad_rows``); the reference raises on such a batch.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


class ThreadedHostLoader:
    """Run a (re-iterable) host batch source on a background thread, at
    most ``capacity`` batches ahead of the consumer. An exception in the
    source is raised in the consumer; a consumer that stops early stops
    the thread."""

    _DONE = object()

    def __init__(self, source: Iterable, capacity: int = 4):
        self.source = source
        self.capacity = capacity

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.capacity)
        stop = threading.Event()
        err = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self.source:
                    if not put(item):
                        return
            except BaseException as e:    # raised again in the consumer
                err.append(e)
            put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()


def to_device(batch: Dict[str, Any], device: torch.device,
              sharding=None) -> Dict[str, torch.Tensor]:
    """One host batch on ``device``, from pinned memory when the device is
    a card; with a dp ``sharding``, this rank's rows only (padded, with a
    ``row_mask``, if the batch is ragged)."""
    if sharding is not None and sharding.axis is not None:
        from pautdx_torch.mesh import (axis_rank, axis_size, local_rows,
                                       pad_rows)

        size = axis_size(sharding.mesh, sharding.axis)
        batch = pad_rows(batch, size)
        n = len(next(iter(batch.values())))
        rows = local_rows(n, size, axis_rank(sharding.mesh, sharding.axis))
        batch = {k: v[rows] for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def device_prefetch(batches: Iterable, device: torch.device, size: int = 2,
                    sharding=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches on ``device`` with ``size`` copies in flight
    ahead of the consumer."""
    buf: collections.deque = collections.deque()
    for b in batches:
        buf.append(to_device(b, device, sharding))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
