"""Profiler traces and device memory statistics (counterpart of
``sdfa_tpu/profiling.py``) on ``torch.profiler``.

A capture records host activity and, on a card, every kernel the process
launches (the port's own kernels by their CUDA names), and is written as one
Chrome trace file (``trace_<pid>_<ns>.json``) into its directory: open it in
Perfetto or ``chrome://tracing``. The trainer's ``trainer.profile`` window
(``{dir, start_step=10, num_steps=5}``; the CLI's ``--profile_dir``) uses
``start_trace`` / ``stop_trace``. XLA's cost and memory analyses have no
counterpart here.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, NamedTuple, Optional

import torch

log = logging.getLogger(__name__)


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


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """``with profiling.trace(dir): run_steps()``; yields the capture."""
    capture = start_trace(log_dir, cuda)
    try:
        yield capture
    finally:
        stop_trace(capture)


def device_memory_stats(device="cuda") -> Dict[str, Any]:
    """``torch.cuda.memory_stats`` of ``device``; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
