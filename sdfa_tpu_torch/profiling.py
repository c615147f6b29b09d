"""Profiler traces (counterpart of ``sdfa_tpu/profiling.py``) on
``torch.profiler``.

A capture records host activity and, on a card, every kernel the process
launches (the port's own kernels by their CUDA names), and is written as one
Chrome trace file (``trace_<pid>_<ns>.json``) into its directory: open it in
Perfetto or ``chrome://tracing``. The trainer's ``trainer.profile`` window
(``{dir, start_step=10, num_steps=5}``; the CLI's ``--profile_dir``) uses
``start_trace`` / ``stop_trace``. XLA's cost and memory analyses have no
counterpart here.

Spans are ``record_function`` ranges on the profiler's clock: the training
step's stages (``train/*``, ``train/trainer.py``), the collectives
(``mesh/*``, ``parallel/mesh.py``) and the garbage collector's pauses
(``host/gc``, here). A ``gc.callbacks`` hook counts every collection that
starts, on any thread, in ``GC_COLLECTIONS`` by generation. While the thread
that starts it is traced, it also opens ``host/gc`` when the collection
starts and closes it when the collection stops, with the generation as the
span's ``args``; the collector holds the interpreter lock, so the span names
the stall on every thread. A capture traces the threads its
``record_function`` callbacks follow (the one that started it), not a thread
of its own such as a prefetcher's: a collection started there is counted and
leaves no span, so the window's count less its ``host/gc`` spans is what the
trace missed. With no capture on, the hook counts and returns after one
check.
"""

from __future__ import annotations

import collections
import gc
import logging
import os
import time
from typing import Any, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

log = logging.getLogger(__name__)

GC_COLLECTIONS = collections.Counter()  # collections started in this process, by generation
_GC_SPANS: List[record_function] = []  # the host/gc span of the collection under way


def _gc_span(phase: str, info: dict):
    if phase == "start":
        GC_COLLECTIONS[info["generation"]] += 1
    if not torch.autograd._profiler_enabled():
        return
    if phase == "start":
        span = record_function("host/gc", str(info["generation"]))
        span.__enter__()
        _GC_SPANS.append(span)
    elif _GC_SPANS:
        _GC_SPANS.pop().__exit__(None, None, None)


gc.callbacks.append(_gc_span)


class Capture(NamedTuple):
    profiler: Any  # the running torch.profiler.profile
    log_dir: str


def start_trace(log_dir: str, cuda: Optional[bool] = None) -> Capture:
    """Start a capture into ``log_dir``; ``cuda`` (default: whether a card
    is there) adds the device's activity."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    return Capture(prof, log_dir)


def stop_trace(capture: Capture) -> str:
    """Wait for the device, stop the capture and write its trace file; returns
    the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    capture.profiler.stop()
    path = os.path.join(capture.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    capture.profiler.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
    return path
