"""Tiny cells of every traffic run end to end on the CPU's plain route, a new
mix and metric join by files alone, and ``correct`` comes out false for each
fault a cell can have."""

from __future__ import annotations

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from h100bench_helpers import REPO, rehearse, tiny_copy, with_held_back


def _cells():
    return [w["name"] for w in with_held_back()["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_tiny_cell_runs_on_the_plain_route_and_prints_no_device_metric(tiny_root, cell):
    rc, result, err = rehearse(tiny_root, "tiny-" + cell)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result
    assert result["metrics"] == {} and result["device"] == {}
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_new_mix_and_metric_join_by_files_alone(tmp_path):
    """A throwaway mix (the stream pool at another size) and a throwaway
    metric, added as files and entries to a copy: the copy's run finds and
    reads both, and no file that was there changed."""
    metric = {"name": "tiny.streams_checked", "unit": "streams", "better": "higher",
              "source": "program_counter", "layer": "the benchmark's own count",
              "moves": "stream_x_realtime", "workloads": ["tiny-throwaway"]}
    root = tiny_copy(str(tmp_path), extra_per_layer=[metric])
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(os.path.join(root, "h100bench")) for f in fs}
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as fp:
        bench = json.load(fp)
    with open(os.path.join(root, "h100bench", "traffic", "tiny_stream32_i16.json")) as fp:
        mix = dict(json.load(fp), clip_s=[1.2, 1.4], check_streams=1)
    with open(os.path.join(root, "h100bench", "traffic", "throwaway.json"), "w") as fp:
        json.dump(mix, fp)
    with open(os.path.join(root, "h100bench", "metrics", metric["name"] + ".py"), "w") as fp:
        fp.write("def read(ctx):\n    return ctx.counts['streams_checked']\n")
    with open(os.path.join(root, "h100bench", "limits", "tiny-throwaway.json"), "w") as fp:
        json.dump({"limits": {"gap_um": 10.0, "step_mismatch_pct": 1.5,
                              "frame_mismatch_max_pct": 3.0, "missing_frames": 0}}, fp)
    bench["workloads"].append({"name": "tiny-throwaway", "config": "dgrad", "traffic": "throwaway",
                               "chips": 1, "why": "a mix added by its file alone"})
    for m in bench["end_to_end"]:
        if "tiny-dgrad-stream-i16" in m.get("workloads", []):
            m["workloads"].append("tiny-throwaway")
    with open(bench_path, "w") as fp:
        json.dump(bench, fp)
    rc, result, err = rehearse(root, "tiny-throwaway", trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True
    assert "rehearsal reader tiny.streams_checked read 1" in err
    for path, content in before.items():
        with open(path, "rb") as fp:
            assert fp.read() == content, path


def _run_in_process(root, workload, monkeypatch):
    """run.main in this process, from the copy at ``root``: the result."""
    from h100bench import run

    monkeypatch.chdir(root)
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "HERE", os.path.join(root, "h100bench"))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", "3000000003", "--seconds", "1",
                       "--trace", "0", "--rehearse"])
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_frame_altered_where_it_is_produced_is_not_correct(tiny_root, monkeypatch):
    from sdfa_tpu_torch import streaming

    real = streaming.StreamingServer._collect

    def altered(self, plan, pending):
        emitted = real(self, plan, pending)
        for frames in emitted.values():
            ts, verts = frames[0]
            frames[0] = (ts, verts + 1e-3)  # one frame a millimetre off
            break
        return emitted

    monkeypatch.setattr(streaming.StreamingServer, "_collect", altered)
    assert _run_in_process(tiny_root, "tiny-dgrad-stream-i16", monkeypatch)["correct"] is False


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(tiny_root, monkeypatch):
    import torch

    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert _run_in_process(tiny_root, "tiny-dgrad-train", monkeypatch)["correct"] is False


@pytest.mark.parametrize("part", ["raw_wav_0", "dgrad_3d_scale_coef_1"])
def test_a_reader_item_altered_where_it_is_produced_is_not_correct(tiny_root, monkeypatch, part):
    """One item's first window, or its second target, off by a little where
    the reader makes it: the rebuild from the corpus files tells."""
    from sdfa_tpu_torch.data.sliding_window import DatasetSlidingWindow

    real = DatasetSlidingWindow.raw_item
    calls = []

    def altered(self, i_frame):
        item = real(self, i_frame)
        calls.append(i_frame)
        if len(calls) == 2:
            item[part] = item[part] + np.float32(1e-3) * np.abs(item[part]).max()
        return item

    monkeypatch.setattr(DatasetSlidingWindow, "raw_item", altered)
    result = _run_in_process(tiny_root, "tiny-dgrad-train", monkeypatch)
    assert result["correct"] is False
    gap = "reader_input_gap" if part.startswith("raw") else "reader_target_gap"
    assert result["checks"][gap]["value"] > result["checks"][gap]["limit"]


def test_the_reader_control_in_bfloat16_is_not_correct(tmp_path):
    """The reference's reader in bfloat16, put in the program's place, fails
    both of the reader's limits at the real cell's batch of 50 pairs."""
    from h100bench import dataset, program
    from h100bench.drivers import train
    from h100bench.reference.reader import Reader, bfloat16_batch, compare
    from h100bench.run import load_cell

    from sdfa_tpu_torch.data import DatasetSlidingWindow

    _, _, cfg, mix, _, _, limits = load_cell("dgrad-train", root=REPO)
    hp = program.hparams(cfg)
    root = dataset.corpus(str(tmp_path), hp.model.face_data_type, 1, 1.5)
    hp.overwrite_by({"seed": 3000000005, "dataset_anime": {"root": root},
                     "trainer": {"pca_targets": True}})
    hp.replace_variable("DATASET_ANIME_ROOT", root)
    prefix = root + "/pca/"
    hp.overwrite_by({"model": {"output": {
        "pca_scale": [prefix + "scale_compT.npy", prefix + "scale_means.npy"],
        "pca_rotat": [prefix + "rotat_compT.npy", prefix + "rotat_means.npy"]}}})
    reader = DatasetSlidingWindow(hp, training=True)
    pairs = int(mix["batch_pairs"])
    drawn = train.record_items(reader, pairs)
    batch = next(iter(reader.raw_batches(pairs)))
    plain = json.loads(json.dumps(hp))
    ref = Reader(plain, root)
    keys = ["dgrad_3d_scale_coef", "dgrad_3d_rotat_coef"]
    sound = compare(ref, [batch], [drawn])
    control = compare(ref, [bfloat16_batch(ref, drawn, keys)], [drawn])
    for name in ("reader_input_gap", "reader_target_gap"):
        assert sound[name] <= limits[name] < control[name], (name, sound, control)


def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    """The loss and the gradient taken over the first half of the rows only,
    the mean over the rest."""
    from sdfa_tpu_torch.train import trainer

    real = trainer.Experiment.put_batch

    def halved(self, batch):
        out = real(self, batch)
        n = len(out["speaker_id"])
        keep = list(range(n // 4)) + list(range(n // 2, n // 2 + n // 4))  # pairs kept whole
        return {k: v[keep] if v.ndim and len(v) == n else v for k, v in out.items()}

    monkeypatch.setattr(trainer.Experiment, "put_batch", halved)
    assert _run_in_process(tiny_root, "tiny-dgrad-train", monkeypatch)["correct"] is False
