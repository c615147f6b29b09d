"""Thread-based iterator prefetch: overlap host batch prep with device
steps (counterpart of ``sdfa_tpu/data/thread_prefetch.py``, copied).

The raw-mode training path (device featurization, api.py) preps batches
in numpy (window slicing, target interpolation). A background THREAD (not
a process: nothing is pickled, and the window gathering is numpy slicing
that releases the GIL) keeps ``depth`` batches ready so the device does
not wait on the host in steady state.

Unlike data/prefetch.py (multiprocess, for the host-features mode whose
per-item feature extraction is GIL-bound Python), this wrapper has no
serialization cost — batches pass by reference.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class ThreadPrefetchIterable:
    """Wrap an iterable factory; each ``iter()`` drains it on a daemon
    thread through a bounded queue. Worker exceptions re-raise at the
    consumer with the original traceback (carried by the exception
    object itself — same-process, nothing pickled away)."""

    _DONE = object()

    def __init__(self, inner: Iterable, depth: int = 2):
        self.inner = inner
        self.depth = int(depth)
        assert self.depth >= 1

    def __len__(self):
        return len(self.inner)  # type: ignore[arg-type]

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that gives up when the consumer stopped —
            NEVER a plain q.put: with the queue full and the consumer
            gone, that blocks forever, leaking the thread and the
            queued batches."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.inner:
                    if not put_or_stop(item):
                        return
                put_or_stop(self._DONE)
            except BaseException as exc:  # noqa: BLE001 — surface to consumer
                put_or_stop(exc)

        t = threading.Thread(target=worker, daemon=True,
                             name="sdfa-thread-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # consumer stopped early: let the worker exit
