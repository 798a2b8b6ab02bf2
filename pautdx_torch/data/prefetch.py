"""Host-thread batch assembly.

Counterpart of ``ThreadedHostLoader`` in ``pautdx/data/prefetch.py``:
parsing, batching and augmentation run on a background thread, so the
training loop does not wait on numpy work. The device side is the
``Trainer``'s input pipeline (pinned host memory, ``non_blocking`` copies
kept ahead of the step), which takes the place of the reference's
``device_prefetch``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


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
