"""The port's examples on the CPU (``--platform cpu`` where they take it),
each against what it stands for, on the dgrad network at narrow widths over
the small synthetic template of ``test_torch_slice.py::task_pair`` (its port
side), saved as a run directory (``Experiment``: hparams.json + last.ckpt):

- ``examples/torch_serve_vertices.py``: one OBJ a frame, equal to
  ``generate_vertices`` of the same checkpoint and audio to the OBJ's
  printed precision (8 decimals: 5e-9 m);
- ``examples/torch_render_template.py``: the PNG equals the JAX
  ``sdfa_tpu.viewer.render.render_mesh`` of the same vertices, pixel for
  pixel (PNG is lossless), for ``synthetic_template(0)`` and a ``--template``;
- ``examples/torch_stream_client.py`` against an in-process service on
  loopback (``ServeApp`` + ``StreamServerTCP``, port 0): the offline
  request's frame count for a 0.5 s clip, and its OBJs;
- ``evaluate_torch.sh``: ``evaluate.sh``'s command with the port's module,
  its positional arguments and defaults, read from a stand-in ``python`` on
  the ``PATH`` that records its arguments.
"""

import importlib.util
import os
import socket
import subprocess
import threading

import numpy as np
import pytest

from test_torch_slice import narrow_model

from sdfa_tpu.viewer.render import render_mesh as jrender_mesh
from sdfa_tpu_torch import api, audio, mesh
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.serve import ServeApp, StreamServerTCP
from sdfa_tpu_torch.train import Experiment
from sdfa_tpu_torch.viewer import frame as tframe

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJ_TOL_M = 5e-9  # write_obj prints 8 decimals


def _example(name):
    spec = importlib.util.spec_from_file_location(f"_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wav(path, seconds, seed):
    t = np.arange(int(seconds * 8000)) / 8000
    rng = np.random.default_rng(seed)
    sig = 0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
    audio.save(str(path), (sig + 0.02 * rng.standard_normal(len(t))).astype(np.float32), 8000)
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(a root with template.ply / cnst.txt and PCA bases over its triangles,
    last.ckpt of a seeded narrow model): ``task_pair``'s port side without the
    JAX model, the template installed. The port's template state is restored on
    exit."""
    root = tmp_path_factory.mktemp("examples")
    verts, faces, cnst = synthetic_template(2, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    rng = np.random.default_rng(0)
    (root / "pca").mkdir()
    for name, shape in (("scale_compT", (6 * n, 85)), ("scale_means", (6 * n,)),
                        ("rotat_compT", (3 * n, 180)), ("rotat_means", (3 * n,))):
        np.save(root / "pca" / f"{name}.npy", rng.normal(0, 0.02, shape).astype(np.float32))
    mesh.write_ply(str(root / "template.ply"), verts, faces)
    (root / "cnst.txt").write_text(" ".join(str(int(i)) for i in cnst))
    net = narrow_model()
    hp = configure("dgrad", dataset_root=str(root), overrides={"model": {
        "audio_encoder": net["audio_encoder"],
        "output": {"output_dim_scale": 6 * n, "output_dim_rotat": 3 * n, **net["output"]}}})
    saved = dict(tframe._state)
    try:
        exp = Experiment(hp, build_model(hp), str(root / "run"), "cpu", seed=5)
        exp.save()
        tframe.set_template_mesh(template_path=str(root / "template.ply"),
                                 constraints_path=str(root / "cnst.txt"))
        yield root, str(root / "run" / "last.ckpt")
    finally:
        tframe._state.clear()
        tframe._state.update(saved)


def _template_args(root):
    return ["--template", str(root / "template.ply"), "--mesh_constraints",
            str(root / "cnst.txt")]


def test_serve_vertices_objs_equal_generate_vertices(run, tmp_path):
    root, ckpt = run
    wav = _wav(tmp_path / "clip.wav", 0.8, 1)
    out = tmp_path / "objs"
    ts, verts = _example("torch_serve_vertices").main(
        [ckpt, wav, str(out), *_template_args(root), "--platform", "cpu"])
    task = api.load_task(ckpt, device="cpu")
    sig, _ = audio.load(wav, sr=8000)
    ts_want, want = task.generate_vertices(
        audio.rms.normalize(sig, task.hp.dataset_anime.get("audio_target_db", -24.5)), 0)
    assert list(ts) == list(ts_want) and np.array_equal(verts, want)
    files = sorted(os.listdir(out))
    assert files == [f"{i:06d}.obj" for i in range(len(ts_want))] and len(files) > 10
    faces = tframe.template()[1]
    for i, name in enumerate(files):
        v, f = mesh.read_obj(str(out / name), dtype=np.float64)
        assert np.array_equal(f, faces)
        assert float(np.abs(v - want[i]).max()) <= OBJ_TOL_M


def test_serve_vertices_refuses_gpu_without_a_card(run, monkeypatch, tmp_path):
    import torch

    root, ckpt = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("torch_serve_vertices").main([ckpt, "missing.wav", str(tmp_path)])


@pytest.mark.parametrize("given", [False, True], ids=["synthetic_template", "template_file"])
def test_render_template_equals_jax_render(run, tmp_path, given):
    import cv2

    root, _ = run
    out = tmp_path / "render.png"
    extra = ["--template", str(root / "template.ply")] if given else []
    img = _example("torch_render_template").main([*extra, "--out", str(out)])
    verts, faces = (mesh.read_mesh(str(root / "template.ply")) if given
                    else mesh.synthetic_template(0)[:2])
    want = jrender_mesh(verts, faces, (512, 512))
    assert img.shape == (512, 512, 3) and np.array_equal(img, want)
    assert np.array_equal(cv2.imread(str(out))[:, :, ::-1], want)


def test_stream_client_against_a_loopback_service(run, tmp_path):
    root, ckpt = run
    task = api.load_task(ckpt, device="cpu", device_frontend=True, overlap_frontend=True)
    app = ServeApp(task, capacity=2, emit_batch=16, block_frames=16, wire="i16", pipeline=True)
    srv = StreamServerTCP(("127.0.0.1", 0), app)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    timeout = socket.getdefaulttimeout()
    socket.setdefaulttimeout(120)  # the client's socket: a stall fails, it does not hang
    try:
        wav = _wav(tmp_path / "clip.wav", 0.5, 2)
        got = _example("torch_stream_client").main(
            [wav, "127.0.0.1", str(srv.server_address[1]), str(tmp_path / "objs"),
             "--template", str(root / "template.ply")])
    finally:
        socket.setdefaulttimeout(timeout)
        srv.shutdown()
        srv.server_close()
        app.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()
    sig, _ = audio.load(wav, sr=8000)
    ts_want, want = task.generate_vertices(audio.rms.normalize(sig), 0)
    assert got["frames"] == len(ts_want) > 0 and got["clip_s"] == pytest.approx(0.5)
    assert 0 <= got["during_push"] <= got["frames"] and got["wall_s"] >= 0.5
    files = sorted(os.listdir(tmp_path / "objs"))
    assert files == sorted(f"{int(ts):07d}.obj" for ts in ts_want)
    v, _ = mesh.read_obj(str(tmp_path / "objs" / files[-1]), dtype=np.float64)
    assert v.shape == want[0].shape


def _evaluate_args(script, args, tmp_path):
    """The arguments ``script`` hands to ``python``, from a stand-in that
    records them."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    record = tmp_path / "argv.txt"
    fake = bin_dir / "python"
    fake.write_text(f'#!/bin/sh\nprintf "%s\\n" "$@" > "{record}"\n')
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")
    subprocess.run(["bash", os.path.join(REPO, script), *args], check=True, env=env,
                   cwd=tmp_path, timeout=60)
    return record.read_text().splitlines()


@pytest.mark.parametrize("args", [["a.wav"], ["a.wav", "f0", "run/x.ckpt", "data"]])
def test_evaluate_script_is_evaluate_sh_with_the_port(tmp_path, args):
    want = _evaluate_args("evaluate.sh", args, tmp_path)
    got = _evaluate_args("evaluate_torch.sh", args, tmp_path)
    assert want[:2] == ["-m", "sdfa_tpu"] and got[:2] == ["-m", "sdfa_tpu_torch"]
    assert got[2:] == want[2:]
    with_template = _evaluate_args("evaluate_torch.sh", args + [""] * (4 - len(args)) + [
        "t.ply", "ids.txt"], tmp_path)
    assert with_template[2:] == want[2:] + ["--template_mesh", "t.ply",
                                            "--mesh_constraints", "ids.txt"]
