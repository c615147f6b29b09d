"""The card's idle time in a traced window (``tracing.Trace``) split by the
program's spans, and the exchange's share that no other device work hides.

An idle instant is one in [t0, t1] with no kernel, copy or set running on
the card. It goes to ``gc`` if a ``host/gc`` span (``profiling.py``) is open,
else to the stage of the innermost ``train/*`` stage span of
``Experiment.train_step`` open over it (``STAGES``; the innermost is the one
that opened last), else to ``unassigned``: the upload, the next batch, the
exchange after backward, and the time between spans. ``loss`` is therefore
``train/loss_terms`` plus the part of ``train/forward_loss`` outside its
children. The buckets add up to the window's idle time exactly."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

STAGES = {"train/features": "features", "train/model": "model",
          "train/loss_terms": "loss", "train/forward_loss": "loss",
          "train/backward": "backward",
          "train/zero_grad": "optimizer", "train/clip_adam": "optimizer"}
GC = "host/gc"
BUCKETS = ("features", "model", "loss", "backward", "optimizer", "gc", "unassigned")
MARK = "train/model"  # a trace without it comes from a program without the stage spans


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The intervals clipped to [lo, hi], merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _spans(trace, names) -> List[Tuple[float, float, str]]:
    return [(ts, ts + dur, name) for name, cat, ts, dur in trace.host
            if cat == "user_annotation" and name in names]


def idle_by_stage(trace) -> Optional[Dict[str, float]]:
    """Microseconds of idle by bucket (``BUCKETS``) and their ``total``; None
    where the trace holds no stage span. Kept on the trace once computed."""
    cached = getattr(trace, "_idle_by_stage", None)
    if cached is not None or trace is None:
        return cached
    if not any(name == MARK for name, cat, _, _ in trace.host if cat == "user_annotation"):
        return None
    t0, t1 = trace.t0, trace.t1
    busy = union(((ts, ts + dur) for _, _, ts, dur in trace.device), t0, t1)
    # +1 opens, -1 closes; kind 0 idle, 1 a stage span, 2 a GC span
    marks = [(t0, 0, 1, None), (t1, 0, -1, None)]
    for a, b in busy:
        marks += [(a, 0, -1, None), (b, 0, 1, None)]
    for i, (a, b, name) in enumerate(_spans(trace, set(STAGES))):
        a, b = max(a, t0), min(b, t1)
        if b > a:
            marks += [(a, 1, 1, (a, -b, i, STAGES[name])), (b, 1, -1, (a, -b, i, STAGES[name]))]
    for a, b, _ in _spans(trace, {GC}):
        a, b = max(a, t0), min(b, t1)
        if b > a:
            marks += [(a, 2, 1, None), (b, 2, -1, None)]
    marks.sort(key=lambda m: m[0])
    out = dict.fromkeys(BUCKETS, 0.0)
    idle, gc_open, open_stages, prev = 0, 0, set(), t0
    for t, kind, step, key in marks:
        if t > prev and idle > 0:
            if gc_open:
                bucket = "gc"
            elif open_stages:
                bucket = max(open_stages)[3]  # the latest start; the shorter on a tie
            else:
                bucket = "unassigned"
            out[bucket] += t - prev
        prev = max(prev, t)
        if kind == 0:
            idle += step
        elif kind == 1:
            (open_stages.add if step > 0 else open_stages.discard)(key)
        else:
            gc_open += step
    out["total"] = (t1 - t0) - sum(b - a for a, b in busy)
    trace._idle_by_stage = out
    return out


def idle_ms_per_step(ctx, bucket: str) -> Optional[float]:
    """A bucket's idle milliseconds per step of the window."""
    steps = ctx.counts.get("steps", 0)
    split = idle_by_stage(ctx.trace) if ctx.trace is not None else None
    if split is None or not steps:
        return None
    return split[bucket] * 1e-3 / steps


def exposed_us(trace, kernel: str = "nccl") -> Optional[float]:
    """Microseconds of [t0, t1] in which a kernel whose name holds ``kernel``
    (any case) runs on the card and no other kernel, copy or set does; None
    where no such kernel ran."""
    mine = [(ts, ts + dur) for name, cat, ts, dur in trace.device
            if cat == "kernel" and kernel in name.lower()]
    if not mine:
        return None
    others = union(((ts, ts + dur) for name, cat, ts, dur in trace.device
                    if not (cat == "kernel" and kernel in name.lower())), trace.t0, trace.t1)
    total, j = 0.0, 0
    for a, b in union(mine, trace.t0, trace.t1):
        total += b - a
        while j < len(others) and others[j][1] <= a:
            j += 1
        k = j
        while k < len(others) and others[k][0] < b:
            total -= min(b, others[k][1]) - max(a, others[k][0])
            k += 1
    return total
