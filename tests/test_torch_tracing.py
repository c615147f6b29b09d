"""The port's tracing on the CPU: the stage spans of ``Experiment.train_step``,
the garbage collector's ``host/gc`` span (``profiling.py``), and the
collectives' ``mesh/*`` spans and counters (``parallel/mesh.py``) in two gloo
ranks (``tests/_torch_dist_worker.py``).

The narrow dgrad network (``test_torch_slice.py::narrow_model``) on a
generated dataset cut to 240 triangles, in raw mode (the features computed in
the loss)."""

import gc
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from _torch_dist_worker import run_ranks
from test_torch_slice import narrow_model

from sdfa_tpu_torch import profiling
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.data import DatasetSlidingWindow, synthetic
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.train import Experiment

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

STEPS = 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing_data")
    saved = synthetic.N_TRIS
    synthetic.N_TRIS = 240
    try:
        root = synthetic.generate(str(tmp / "voca"), "dgrad_3d", speakers=["m0", "f0"],
                                  sentences_per_speaker=1, seconds_per_sentence=2.0)
    finally:
        synthetic.N_TRIS = saved
    net = narrow_model()
    overrides = {
        "model": {"audio_encoder": net["audio_encoder"],
                  "output": dict(net["output"], output_dim_scale=6 * 240,
                                 output_dim_rotat=3 * 240)},
        "trainer": {"pca_targets": True, "anime_loader": {"batch_size": 2}}}
    return dict(root=root, overrides=overrides, tmp=tmp)


def _user_spans(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_train_step_stage_spans_nest_in_forward_loss(dataset, tmp_path):
    hp = configure("dgrad", overrides=dataset["overrides"], dataset_root=dataset["root"])
    exp = Experiment(hp, build_model(hp), str(tmp_path / "run"), "cpu")
    batch = next(DatasetSlidingWindow(hp, training=True).raw_batches(2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.train_step(batch)
    spans = _user_spans(prof, tmp_path)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("train/upload", "train/zero_grad", "train/forward_loss", "train/features",
                 "train/model", "train/loss_terms", "train/backward", "train/clip_adam"):
        assert len(by_name.get(name, [])) == 1, (name, sorted(by_name))
    (outer,) = by_name["train/forward_loss"]
    lo, hi = outer["ts"], outer["ts"] + outer["dur"]
    inner = [by_name[n][0] for n in ("train/features", "train/model", "train/loss_terms")]
    for e in inner:
        assert lo <= e["ts"] and e["ts"] + e["dur"] <= hi, e["name"]
    assert [e["name"] for e in sorted(inner, key=lambda e: e["ts"])] == [
        "train/features", "train/model", "train/loss_terms"]
    (zero,) = by_name["train/zero_grad"]
    assert zero["ts"] + zero["dur"] <= lo  # the gradients go before the forward pass


def test_gc_span_only_under_a_capture(tmp_path, monkeypatch):
    assert profiling._gc_span in gc.callbacks
    gc.disable()  # the collection asked for below is the only one
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("probe/collect"):
                gc.collect()
    finally:
        gc.enable()
    spans = _user_spans(prof, tmp_path)
    (probe,) = [e for e in spans if e["name"] == "probe/collect"]
    (span,) = [e for e in spans if e["name"] == "host/gc"]
    assert probe["ts"] <= span["ts"] and span["ts"] + span["dur"] <= probe["ts"] + probe["dur"]
    assert profiling._GC_SPANS == []

    def no_span(*args):
        raise AssertionError("a host/gc span was opened with no capture on")

    monkeypatch.setattr(profiling, "record_function", no_span)
    assert not torch.autograd._profiler_enabled()
    counted = profiling.GC_COLLECTIONS[2]
    gc.collect()
    assert profiling._GC_SPANS == []
    assert profiling.GC_COLLECTIONS[2] == counted + 1  # counted all the same


def test_gc_on_a_thread_the_capture_does_not_trace_is_counted_not_spanned(tmp_path):
    """A capture follows the thread that started it: a collection started on
    a thread of its own (a prefetcher's) opens no ``host/gc`` span, and
    ``GC_COLLECTIONS`` counts it, so the count less the spans is what the
    trace missed."""
    gc.disable()
    try:
        before = profiling.GC_COLLECTIONS[2]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            worker = threading.Thread(target=gc.collect)
            worker.start()
            worker.join()
            gc.collect()
        counted = profiling.GC_COLLECTIONS[2] - before
    finally:
        gc.enable()
    spans = [e for e in _user_spans(prof, tmp_path) if e["name"] == "host/gc"]
    assert counted == 2
    assert [e["tid"] for e in spans] == [threading.get_native_id()]  # the main thread's
    assert profiling._GC_SPANS == []


def test_two_ranks_count_each_collective_once(dataset):
    """Two gloo ranks, ``STEPS`` steps each: the ``mesh/*`` spans in a capture
    equal ``mesh.CALLS`` op by op, and their number a step is the model's:
    a pair per BatchNorm module (its statistics forward and their gradient
    backward), one gradient exchange, one for the dynamic scalers, one for
    the step's metrics and one agreement a batch. Every step runs eagerly,
    counted under ``eager:parallel``: a mesh's step is never captured."""
    tmp = str(dataset["tmp"] / "ranks")
    job = {"spans": dict(kind="spans", overrides=dataset["overrides"],
                         dataset_root=dataset["root"], steps=STEPS, seed=5, log_dir=tmp)}
    ranks = run_ranks(job, 2, os.path.join(tmp, "run"))
    for result in (r["spans"] for r in ranks):
        assert result["calls"] == result["spans"], result
        assert result["dynamic_scalers"] and result["batch_norms"] > 0
        per_step = 2 * result["batch_norms"] + 1 + 1 + 1 + 1
        assert sum(result["calls"].values()) == STEPS * per_step, result
        assert result["calls"]["all_reduce_sum"] == result["calls"]["all_reduce_sum_bwd"]
        assert result["calls"]["average_gradients"] == STEPS
        assert result["calls"]["all_ranks_agree"] == STEPS
        assert result["calls"]["mean_over_ranks"] == 2 * STEPS
        assert all(result["bytes"][op] > 0 for op in result["calls"])
        assert result["second_order"] == [2.0 * 2 ** 2] * 3
        assert result["graph_steps"] == {"eager:parallel": STEPS}
