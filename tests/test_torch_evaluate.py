"""``AnimationTask.evaluate`` and ``api.evaluate_model`` of the port against the
JAX ``AnimationTask.evaluate`` on the same weights (carried across by
``compat/from_flax.py``), the same sources and the same template: the
exported prediction frames (``.npy``) within 1e-5 and the meshes (``.obj``)
within 1e-5 m, the side audio equal byte for byte; a dataset sentence
directory with its truth track rendered into a video on both sides; and the
refusal, before any inference, of video on a host without OpenCV. The dgrad
network at narrow widths over a small synthetic template
(``test_torch_slice.py::task_pair``), on the CPU."""

import os

import numpy as np
import pytest
import torch

from test_torch_slice import _signal, task_pair

from sdfa_tpu_torch import api as tapi
from sdfa_tpu_torch.audio import io as taudio
from sdfa_tpu_torch.mesh import read_obj

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 1e-5  # prediction frames, and metres for the meshes


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    with task_pair(root, narrow=True) as (jtask, ttask, n_verts):
        yield root, jtask, ttask, n_verts


@pytest.fixture(scope="module")
def wav(pair):
    root = pair[0]
    sr = 16000  # neither the model's rate nor the exports' 44.1 kHz: resampled both ways
    t = np.arange(int(0.9 * sr)) / sr
    sig = 0.3 * np.sin(2 * np.pi * 170 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
    path = str(root / "clip.wav")
    taudio.save(path, sig.astype(np.float32), sr)
    return path


def _sentence_dir(root, n_tris):
    """A preprocessed sentence: 1 s of audio at 8 kHz and dgrad frames from -2."""
    d = root / "sent001"
    d.mkdir(exist_ok=True)
    np.savez(str(d) + "_audio.npz", sr=8000, start_ts=0.0, audio=_signal(1.0, 5))
    rng = np.random.default_rng(9)
    for fi in range(-2, 58):
        np.save(str(d / f"{fi:06d}.npy"), rng.normal(0, 0.01, 9 * n_tris).astype(np.float32))
    return str(d)


def _compare_exports(got_dir, want_dir, n_verts):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    objs = [n for n in names if n.endswith(".obj")]
    assert len(objs) == len([n for n in names if n.endswith(".npy")]) > 0
    worst = {"npy": 0.0, "obj": 0.0}
    for name in names:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".npy"):
            worst["npy"] = max(worst["npy"], float(np.abs(np.load(a) - np.load(b)).max()))
        elif name.endswith(".obj"):
            (va, fa), (vb, fb) = read_obj(a, np.float64), read_obj(b, np.float64)
            assert va.shape == (n_verts, 3) and np.array_equal(fa, fb)
            worst["obj"] = max(worst["obj"], float(np.abs(va - vb).max()))
        else:
            assert name == "audio.wav"
            assert open(a, "rb").read() == open(b, "rb").read()
    assert worst["npy"] <= TOL and worst["obj"] <= TOL, worst
    return len(objs)


def test_evaluate_wav_matches_jax(pair, wav, tmp_path):
    _, jtask, ttask, n_verts = pair
    sources = [(wav, "speaker=m0")]
    want = jtask.evaluate(sources, output_dir=str(tmp_path / "j"), save_video=False)
    got = ttask.evaluate(sources, output_dir=str(tmp_path / "t"), save_video=False)
    assert got[0]["name"] == want[0]["name"] == "clip" and got[0]["video"] is None
    assert list(got[0]["tslist"]) == list(want[0]["tslist"])
    assert float(np.abs(got[0]["animes"] - np.asarray(want[0]["animes"])).max()) <= TOL
    n = _compare_exports(str(tmp_path / "t" / "clip"), str(tmp_path / "j" / "clip"), n_verts)
    assert n == int(got[0]["tslist"][-1] * 60 / 1000) + 1


def test_evaluate_model_matches_jax(pair, wav, tmp_path):
    """evaluate_model reads the port's checkpoint and the config from files."""
    root, jtask, ttask, n_verts = pair
    ttask.hp.dump(str(tmp_path / "hparams.json"))
    torch.save({"model": ttask.model.state_dict()}, str(tmp_path / "last.ckpt"))
    jtask.evaluate([(wav, "speaker=f1")], output_dir=str(tmp_path / "j"), save_video=False)
    got = tapi.evaluate_model(custom_hparams=str(tmp_path / "hparams.json"),
                              load_from=str(tmp_path / "last.ckpt"), eval_input=wav,
                              eval_spk_cond="f1", output_dir=str(tmp_path / "t"),
                              dataset_root=str(root), device="cpu", save_video=False)
    assert len(got) == 1 and got[0]["name"] == "clip"
    _compare_exports(str(tmp_path / "t" / "clip"), str(tmp_path / "j" / "clip"), n_verts)


def test_dataset_source_with_truth_and_video(pair, tmp_path):
    """A sentence directory: its blob's audio, its truth track (negative frame
    ids first) beside the inference and the colour-mapped latent tracks in a
    video written here, where OpenCV exists."""
    import cv2

    root, jtask, ttask, n_verts = pair
    sent = _sentence_dir(root, ttask.model.scale_pca.compT.shape[0] // 6)
    kw = dict(save_video=True, grid_w=64, grid_h=64, font_size=12, draw_latent=True)
    want = jtask.evaluate([(sent, "speaker=2")], output_dir=str(tmp_path / "j"), **kw)
    got = ttask.evaluate([(sent, "speaker=2")], output_dir=str(tmp_path / "t"), **kw)
    assert float(np.abs(got[0]["animes"] - np.asarray(want[0]["animes"])).max()) <= TOL
    _compare_exports(str(tmp_path / "t" / "sent001"), str(tmp_path / "j" / "sent001"), n_verts)

    def shape(path):
        cap = cv2.VideoCapture(path)
        n, size = 0, None
        ok, img = cap.read()
        while ok:
            n, size = n + 1, img.shape
            ok, img = cap.read()
        cap.release()
        return n, size

    assert got[0]["video"] == str(tmp_path / "t" / "sent001.avi")
    # truth, inference, inputs, latent: a 2 x 2 grid, one frame per 60 fps
    # frame of the longest track
    n_frames = int(max(got[0]["tslist"][-1], 57 * 1000 / 60) * 60 / 1000) + 1
    assert shape(got[0]["video"]) == shape(want[0]["video"]) == (n_frames, (128, 128, 3))
    assert (tmp_path / "t" / "sent001.wav").read_bytes() == \
        (tmp_path / "j" / "sent001.wav").read_bytes()


def test_video_without_opencv_fails_before_inference(pair, wav, tmp_path, monkeypatch):
    import importlib.util

    _, _, ttask, _ = pair
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "cv2" else find_spec(name, *a))

    def no_inference(*args, **kwargs):
        raise AssertionError("inference ran before the video check")

    monkeypatch.setattr(ttask, "generate_animation", no_inference)
    with pytest.raises(ImportError, match="cv2.*--no-save_video"):
        ttask.evaluate([(wav, "speaker=m0")], output_dir=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
