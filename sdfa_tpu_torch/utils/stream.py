"""Timestamp-stream seeking with linear interpolation (counterpart of
``sdfa_tpu/utils/stream.py``, copied).

Same behavior as the reference's saber/data/stream/stream.py:4-68 — the
resampling primitive from 60 fps animation frames to arbitrary timestamps —
implemented vectorized (np.searchsorted) rather than with per-call binary
search loops.
"""

from __future__ import annotations

import numpy as np


def index_of(ts: float, tslist) -> int:
    tsarr = np.asarray(tslist)
    idx = int(np.searchsorted(tsarr, ts, side="right") - 1)
    return int(np.clip(idx, 0, len(tsarr) - 1))


def seek(ts: float, timestamps, sequence):
    """Linear-interp value of ``sequence`` at time ``ts``."""
    timestamps = np.asarray(timestamps)
    sequence = np.asarray(sequence)
    if len(timestamps) != len(sequence):
        raise ValueError(f"{len(timestamps)} timestamps for {len(sequence)} items")
    m = index_of(ts, timestamps)
    if ts <= timestamps[0]:
        return np.copy(sequence[0])
    if ts >= timestamps[-1] or m + 1 >= len(timestamps):
        return np.copy(sequence[-1])
    n = m + 1
    a = (timestamps[n] - ts) / (timestamps[n] - timestamps[m])
    return a * sequence[m] + (1.0 - a) * sequence[n]


def seek_many(ts_queries, timestamps, sequence) -> np.ndarray:
    """Vectorized :func:`seek` over a sorted or unsorted array of query times."""
    ts_queries = np.asarray(ts_queries, dtype=np.float64)
    timestamps = np.asarray(timestamps, dtype=np.float64)
    sequence = np.asarray(sequence)
    m = np.clip(np.searchsorted(timestamps, ts_queries, side="right") - 1, 0, len(timestamps) - 2)
    n = m + 1
    denom = timestamps[n] - timestamps[m]
    denom = np.where(denom == 0, 1.0, denom)
    a = (timestamps[n] - ts_queries) / denom
    a = np.clip(a, 0.0, 1.0)
    shape = (-1,) + (1,) * (sequence.ndim - 1)
    out = a.reshape(shape) * sequence[m] + (1.0 - a).reshape(shape) * sequence[n]
    # out-of-range clamping identical to reference seek()
    out = np.where(
        (ts_queries <= timestamps[0]).reshape(shape), sequence[0], out
    )
    out = np.where(
        (ts_queries >= timestamps[-1]).reshape(shape), sequence[-1], out
    )
    return out


def seek_subseq(length: int, start_ts: float, delta_ts: float, tslist, sequence) -> np.ndarray:
    queries = start_ts + delta_ts * np.arange(length)
    return seek_many(queries, tslist, sequence)
