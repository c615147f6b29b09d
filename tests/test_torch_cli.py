"""``python -m sdfa_tpu_torch`` in process, through ``__main__.main([...])`` on
the CPU (``--platform cpu``): ``train`` for one step on a generated dataset,
then ``evaluate`` (meshes within 1e-5 m of the same checkpoint's request
through ``api.load_task``), ``trace`` (``load_traced``, ``load_task`` and the
trained model in memory give the same vertices), ``synth``, ``serve`` in a
thread answering one ``StreamClient`` (its frames within the i16 wire's step
of the offline request), the trainer's profiler window, and the stated
refusals: ``preprocess`` without ``--template_mesh`` or ``--source_root``, a
malformed ``--mesh_tricorres`` file, a missing template and ``--platform gpu``
without a card.

The dgrad network at narrow widths (``test_torch_slice.py::narrow_model``) on a
dataset cut to a small synthetic template's 240 triangles."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from test_torch_slice import _signal, narrow_model

from sdfa_tpu_torch import api, serve
from sdfa_tpu_torch.__main__ import main
from sdfa_tpu_torch.audio import dsp, rms
from sdfa_tpu_torch.audio import io as audio_io
from sdfa_tpu_torch.data import synthetic
from sdfa_tpu_torch.mesh import read_obj, synthetic_template, write_ply
from sdfa_tpu_torch.task import AnimationTask
from sdfa_tpu_torch.utils import stream
from sdfa_tpu_torch.viewer import frame

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL_M = 1e-5            # evaluate's meshes vs the request's vertices
WIRE_TOL_M = 5e-6 + 1e-7  # the i16 wire's step
STREAM_TOL_M = 1e-5     # streamed vs offline on the same audio (tests/test_torch_serve.py)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    verts, faces, cnst = synthetic_template(2, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    saved_tris, saved_frame = synthetic.N_TRIS, dict(frame._state)
    synthetic.N_TRIS = n
    try:
        root = synthetic.generate(str(tmp / "voca"), "dgrad_3d", speakers=["m0", "f0"],
                                  sentences_per_speaker=1, seconds_per_sentence=2.0)
    finally:
        synthetic.N_TRIS = saved_tris
    ply, txt = str(tmp / "template.ply"), str(tmp / "cnst.txt")
    write_ply(ply, verts, faces)
    with open(txt, "w") as fp:
        fp.write(" ".join(str(int(i)) for i in cnst))
    net = narrow_model()
    overrides = {
        "model": {"audio_encoder": net["audio_encoder"],
                  "output": dict(net["output"], output_dim_scale=6 * n, output_dim_rotat=3 * n)},
        "trainer": {"pca_targets": True, "anime_loader": {"batch_size": 2}}}
    wav = str(tmp / "clip.wav")
    audio_io.save(wav, _signal(1.0, 3), 8000)
    common = ["--custom_hparams", "dgrad", "--dataset_root", root,
              "--overrides", json.dumps(overrides), "--platform", "cpu"]
    exp = main(["train", "--max_steps", "1", "--log_dir", str(tmp / "run"),
                "--profile_dir", str(tmp / "prof")] + common)
    # the in-process requests below use the template the CLI reads (float32 on disk)
    frame.set_template_mesh(template_path=ply, constraints_path=txt)
    try:
        yield dict(tmp=tmp, root=root, exp=exp, ckpt=str(tmp / "run" / "last.ckpt"), wav=wav,
                   template=["--template_mesh", ply, "--mesh_constraints", txt], common=common,
                   overrides=overrides, n_verts=len(verts))
    finally:
        frame._state.clear()
        frame._state.update(saved_frame)


def test_train(cli):
    exp = cli["exp"]
    assert exp.step == 1 and exp.device == torch.device("cpu")
    for name in ("last.ckpt", "hparams.json", "params_info.txt"):
        assert os.path.exists(os.path.join(cli["tmp"], "run", name)), name
    # --profile_dir fills trainer.profile as the JAX CLI does; one step never opens it
    assert dict(exp.hp.trainer.profile) == dict(dir=str(cli["tmp"] / "prof"), start_step=10,
                                                 num_steps=5)
    assert not os.path.exists(cli["tmp"] / "prof")


def test_profile_window_writes_a_trace(cli):
    prof = str(cli["tmp"] / "prof_window")
    api.train_model("dgrad", dataset_root=cli["root"], log_dir=str(cli["tmp"] / "run_prof"),
                    max_steps=3, device="cpu", overrides=dict(
                        cli["overrides"], trainer=dict(
                            cli["overrides"]["trainer"],
                            profile=dict(dir=prof, start_step=1, num_steps=1))))
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as fp:
        events = json.load(fp)["traceEvents"]
    spans = [e["name"] for e in events if e.get("name", "").startswith("train/")
             and e.get("cat") == "user_annotation"]
    for stage in ("train/upload", "train/zero_grad", "train/forward_loss", "train/features",
                  "train/model", "train/loss_terms", "train/backward", "train/clip_adam"):
        assert spans.count(stage) == 1, (stage, spans)


def _request_signal(wav, hp):
    """The model's signal of ``evaluate``: the wav at 44.1 kHz, resampled to the
    model's rate, normalized."""
    signal, _ = audio_io.load(wav, sr=44100)
    signal = dsp.resample(signal, 44100, int(hp.audio.sample_rate))
    return rms.normalize(signal, hp.dataset_anime.get("audio_target_db", -24.5))


def test_evaluate_matches_load_task_request(cli):
    out = cli["tmp"] / "eval"
    res = main(["evaluate", "--load_from", cli["ckpt"], "--eval_input", cli["wav"],
                "--eval_spk_cond", "m0", "--no-save_video", "--output_dir", str(out)]
               + cli["template"] + cli["common"])
    assert len(res) == 1 and res[0]["video"] is None
    objs = sorted(f for f in os.listdir(out / "clip") if f.endswith(".obj"))
    assert (out / "clip" / "audio.wav").exists() and len(objs) == \
        len([f for f in os.listdir(out / "clip") if f.endswith("_dgrad_3d.npy")])
    got = np.stack([read_obj(str(out / "clip" / f), np.float64)[0] for f in objs])
    task = api.load_task(cli["ckpt"], device="cpu")
    ts, verts = task.generate_vertices(_request_signal(cli["wav"], task.hp), "m0")
    want = stream.seek_many(np.arange(len(objs)) * 1000.0 / 60, ts, verts)
    assert got.shape == (len(objs), cli["n_verts"], 3)
    assert float(np.abs(got - want).max()) <= TOL_M


def test_trace_then_load_traced_and_load_task(cli):
    dump = main(["trace", "--load_from", cli["ckpt"], "--traced_dump_path",
                 str(cli["tmp"] / "dump")] + cli["common"])
    sig = _signal(0.8, 4)
    exp = cli["exp"]
    live = AnimationTask(exp.hp, exp.model, "cpu")
    outs = [t.generate_vertices(sig, 1) for t in (
        api.load_traced(dump, device="cpu"), api.load_task(cli["ckpt"], device="cpu"), live)]
    for ts, v in outs[:2]:
        assert list(ts) == list(outs[2][0])
        np.testing.assert_array_equal(v, outs[2][1])


def test_synth(cli, monkeypatch):
    monkeypatch.setattr(synthetic, "N_VERTS", 125)
    root = str(cli["tmp"] / "synth")
    assert main(["synth", "--face_type", "verts_off_3d", "--dataset_root", root,
                 "--platform", "cpu"]) == root
    comp = np.load(os.path.join(root, "pca", "compT.npy"))
    frame0 = np.load(os.path.join(root, "data", "m0", "neutral", "sent001", "000000.npy"))
    assert comp.shape == (375, 59) and frame0.shape == (375,)
    with open(os.path.join(root, "train.csv")) as fp:
        assert len(fp.read().strip().splitlines()) == 1 + 8 * 2  # header, 8 speakers x 2


def test_serve_answers_a_client(cli, monkeypatch):
    servers = []

    class Recorded(serve.StreamServerTCP):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    monkeypatch.setattr(serve, "StreamServerTCP", Recorded)
    errors = []

    def run():
        try:
            main(["serve", "--load_from", cli["ckpt"], "--port", "0", "--capacity", "2",
                  "--device_wire", "i16", "--platform", "cpu"] + cli["template"])
        except Exception as exc:  # reported on the test's thread
            errors.append(repr(exc))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        for _ in range(3000):  # up to 300 s on a loaded host
            if servers or errors or not thread.is_alive():
                break
            thread.join(0.1)
        assert servers and not errors, errors
        sig = _signal(1.0, 8)
        with serve.StreamClient(servers[0].server_address) as client:
            client.sock.settimeout(120)
            sid = client.open(speaker=1)
            for lo in range(0, len(sig), 1500):
                client.push(sid, sig[lo:lo + 1500])
            client.flush(sid)
            frames = list(client.frames(sid))
    finally:
        if servers:
            servers[0].shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    ts, want = api.load_task(cli["ckpt"], device="cpu").generate_vertices(sig, 1)
    assert [t for t, _ in frames] == list(ts)
    err = float(np.abs(np.stack([v for _, v in frames]) - want).max())
    assert err <= STREAM_TOL_M + WIRE_TOL_M


@pytest.mark.parametrize("case", ["preprocess", "preprocess_source", "tricorres", "no_template",
                                  "gpu"])
def test_refusals(cli, case, monkeypatch, capsys):
    out = str(cli["tmp"] / f"refused_{case}")
    args = ["evaluate", "--load_from", cli["ckpt"], "--eval_input", cli["wav"], "--no-save_video",
            "--output_dir", out] + cli["common"]
    if case.startswith("preprocess"):  # each required path named when it is missing
        missing = "--template_mesh" if case == "preprocess" else "--source_root"
        given = {"--source_root": str(cli["tmp"]), "--template_mesh": cli["template"][1]}
        args = ["preprocess", "--platform", "cpu", "--dataset_root", out] + [
            a for flag, value in given.items() if flag != missing for a in (flag, value)]
        with pytest.raises(SystemExit):
            main(args)
        assert f"preprocess requires {missing}" in capsys.readouterr().err
        assert not (cli["tmp"] / f"refused_{case}").exists()
        return
    if case == "tricorres":  # a malformed correspondence file: the line is named
        bad = cli["tmp"] / "corres_bad.txt"
        bad.write_text("2\n1,0,0\n3;1;0\n")
        args = args + cli["template"] + ["--mesh_tricorres", str(bad)]
        err, match = ValueError, "corres_bad.txt:3"
    elif case == "no_template":
        monkeypatch.setattr(frame, "_state", dict(solver=None, verts=None, faces=None, consts={}))
        err, match = FileNotFoundError, "--template_mesh"
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        args, err, match = args[:-2], RuntimeError, "--platform cpu"  # the default: gpu
    with pytest.raises(err, match=match):
        main(args)
    assert not (cli["tmp"] / f"refused_{case}").exists()


def test_profiling_trace_context_on_the_cpu(tmp_path):
    from sdfa_tpu_torch import profiling

    capture = profiling.start_trace(str(tmp_path), cuda=False)
    with torch.profiler.record_function("probe/span"):
        torch.ones(8).sum()
    path = profiling.stop_trace(capture)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with open(path) as fp:
        assert any(e.get("name") == "probe/span" for e in json.load(fp)["traceEvents"])
