"""The reader of the program's CUDA graph replays (``train.graph_step_pct``)
on synthetic traces: one ``train/graph_replay`` span a step reads 100, a
program without the span reads nothing."""

from __future__ import annotations

from h100bench.metrics_ctx import Context
from h100bench.run import metric_reader
from h100bench.tracing import Trace


def _event(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def _ctx(spans, steps):
    events = [_event(n, ts, dur) for n, ts, dur in spans]
    events.append(_event("gemm", 30, 400, "kernel"))
    return Context({}, {"hparams": {}}, {}, dict(counts={"steps": steps}, host={},
                                                  trace=Trace(events, "bench/step")))


def test_graph_step_share_counts_the_replay_spans_in_the_window():
    read = metric_reader("train.graph_step_pct")
    steps = [("bench/step", 1000 * i, 1000) for i in range(4)]
    uploads = [("train/upload", 1000 * i, 20) for i in range(4)]
    replays = [("train/graph_replay", 1000 * i + 30, 50) for i in range(4)]
    assert read(_ctx(steps + uploads + replays, 4)) == 100.0
    # one step of four eager, and a replay outside the window that does not count
    outside = [("train/graph_replay", 5000, 50)]
    assert read(_ctx(steps + uploads + replays[1:] + outside, 4)) == 75.0


def test_graph_step_share_reads_nothing_without_a_replay():
    read = metric_reader("train.graph_step_pct")
    steps = [("bench/step", 1000 * i, 1000) for i in range(2)]
    eager = [("train/model", 1000 * i + 100, 300) for i in range(2)]
    assert read(_ctx(steps + eager, 2)) is None
    assert read(Context({}, {}, {}, dict(counts={"steps": 2}, host={}, trace=None))) is None
