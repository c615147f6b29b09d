"""The port's host-side modules against the JAX package's, bit for bit, on the
same seeded inputs: wav I/O, RMS normalization, resampling, timestamp
seeking, the evaluation-source argument parser, OBJ / mesh I/O (identical
file bytes), the dataset truth reader, the mesh renderer and the grid video's
frames. Each pair is the same code (copied: the port imports no part of the
JAX package), so every comparison is exact."""

import os

import numpy as np
import pytest

from sdfa_tpu.audio import dsp as jdsp
from sdfa_tpu.audio import io as jaudio
from sdfa_tpu.audio import rms as jrms
from sdfa_tpu.mesh import io as jmesh
from sdfa_tpu.task import load_dataset_truth as jtruth
from sdfa_tpu.utils import ArgumentParser as JArgs
from sdfa_tpu.utils import stream as jstream
from sdfa_tpu.utils import visualizer as jvis
from sdfa_tpu.viewer import render as jrender
from sdfa_tpu.viewer import frame as jframe
from sdfa_tpu.viewer import video as jvideo
from sdfa_tpu_torch.audio import dsp as tdsp
from sdfa_tpu_torch.audio import io as taudio
from sdfa_tpu_torch.audio import rms as trms
from sdfa_tpu_torch.mesh import io as tmesh
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.task import load_dataset_truth as ttruth
from sdfa_tpu_torch.utils import ArgumentParser as TArgs
from sdfa_tpu_torch.utils import stream as tstream
from sdfa_tpu_torch.viewer import frame as tframe
from sdfa_tpu_torch.viewer import render as trender
from sdfa_tpu_torch.viewer import video as tvideo

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _wav_data(kind, rng):
    if kind == "int16":
        return rng.integers(-32768, 32767, 4000, dtype=np.int16)
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, 4000, dtype=np.int64).astype(np.int32)
    if kind == "uint8":
        return rng.integers(0, 255, 4000, dtype=np.int64).astype(np.uint8)
    if kind == "float32":
        return rng.uniform(-1, 1, 4000).astype(np.float32)
    return rng.integers(-32768, 32767, (4000, 2), dtype=np.int16)  # stereo: downmixed


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32", "stereo"])
@pytest.mark.parametrize("sr", [None, 44100])
def test_wav_load_and_save(tmp_path, kind, sr):
    from scipy.io import wavfile

    path = str(tmp_path / "in.wav")
    wavfile.write(path, 16000, _wav_data(kind, np.random.default_rng(1)))
    (sig_j, sr_j), (sig_t, sr_t) = jaudio.load(path, sr=sr), taudio.load(path, sr=sr)
    _equal(sig_t, sig_j)
    assert sr_t == sr_j == (sr or 16000)
    jaudio.save(str(tmp_path / "j.wav"), sig_j * 1.5, sr_j)  # clipped on save
    taudio.save(str(tmp_path / "t.wav"), sig_t * 1.5, sr_t)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()


def test_non_wav_without_ffmpeg_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr("shutil.which", lambda name: None)
    for load in (jaudio.load, taudio.load):
        with pytest.raises(ValueError, match="without ffmpeg"):
            load(str(tmp_path / "clip.mp4"))


@pytest.mark.parametrize("case", ["default", "threshold", "given_db", "quiet", "clipping"])
def test_rms_normalize(case):
    rng = np.random.default_rng(2)
    wav = (0.05 * rng.standard_normal(3000)).astype(np.float32)
    args, kw = (wav, -24.5), {}
    if case == "threshold":
        kw = dict(threshold=-40.0)
    elif case == "given_db":
        kw = dict(rms_db=-30.0, max_db=-10.0)
    elif case == "quiet":
        args = (wav * 1e-4, -20.0)
    elif case == "clipping":
        args = (wav, 0.0)
    _equal(trms.normalize(*args, **kw), jrms.normalize(*args, **kw))
    assert trms.analyze_db(wav) == jrms.analyze_db(wav)


@pytest.mark.parametrize("rates", [(44100, 8000), (8000, 44100), (16000, 16000), (22050, 8000)])
def test_resample(rates):
    sig = np.random.default_rng(3).standard_normal(2205).astype(np.float32)
    _equal(tdsp.resample(sig, *rates), jdsp.resample(sig, *rates))


@pytest.mark.parametrize("fn", ["seek", "seek_many", "seek_subseq"])
def test_stream_seeking(fn):
    rng = np.random.default_rng(4)
    ts = np.cumsum(rng.uniform(10, 20, 30))
    seq = rng.standard_normal((30, 5, 3)).astype(np.float32)
    queries = np.concatenate([[ts[0] - 5, ts[0], ts[-1], ts[-1] + 5], rng.uniform(0, 700, 40)])
    if fn == "seek":
        for q in queries:
            _equal(tstream.seek(q, ts, seq), jstream.seek(q, ts, seq))
    elif fn == "seek_many":
        _equal(tstream.seek_many(queries, list(ts), seq), jstream.seek_many(queries, list(ts), seq))
    else:
        _equal(tstream.seek_subseq(50, 3.0, 1000 / 60, ts, seq),
               jstream.seek_subseq(50, 3.0, 1000 / 60, ts, seq))


@pytest.mark.parametrize("args,kwargs", [
    (("clip.wav", "speaker=m1"), {}),
    (("dir", "speaker=3", "ensembling_ms=20", "flag=true", "none=None", "lst=[1, 'a']"), {}),
    (("a.wav", "b"), dict(all_args=["path", "second", "speaker"], defaults=["m0"])),
    (("a.wav", "spk=f1"), dict(all_args=["path", "speaker"], defaults=[None],
                               key_abbrs={"spk": "speaker"})),
])
def test_argument_parser(args, kwargs):
    got, want = TArgs(*args, **kwargs), JArgs(*args, **kwargs)
    assert dict(got) == dict(want) and got.pos_args == want.pos_args
    assert [got[i] for i in range(-1, 4)] == [want[i] for i in range(-1, 4)]
    assert got["speaker"] == want["speaker"]


@pytest.mark.parametrize("args,kwargs", [
    (("a", "k=1", "b"), {}),                                  # positional after named
    (("a", "k=1", "k=2"), {}),                                # duplicated key
    ((), dict(all_args=["path"], defaults=[])),               # required arg missing
])
def test_argument_parser_refusals(args, kwargs):
    for cls in (TArgs, JArgs):
        with pytest.raises(ValueError):
            cls(*args, **kwargs)


@pytest.fixture(scope="module")
def small_mesh():
    verts, faces, _ = synthetic_template(3, n_major=10, n_minor=12, n_extra=5, n_free=50)
    return verts.astype(np.float32), faces


def test_obj_io_identical_bytes(tmp_path, small_mesh):
    verts, faces = small_mesh
    jmesh.write_obj(str(tmp_path / "j.obj"), verts, faces)
    tmesh.write_obj(str(tmp_path / "t.obj"), verts, faces)
    assert (tmp_path / "j.obj").read_bytes() == (tmp_path / "t.obj").read_bytes()
    for name in ("t.obj", "t.ply"):
        if name.endswith(".ply"):
            tmesh.write_ply(str(tmp_path / name), verts, faces)
        for dtype in (np.float32, np.float64):
            for got, want in zip(tmesh.read_mesh(str(tmp_path / name), dtype),
                                 jmesh.read_mesh(str(tmp_path / name), dtype)):
                _equal(got, want)
    for read in (tmesh.read_mesh, jmesh.read_mesh):
        with pytest.raises(ValueError, match="unsupported mesh format"):
            read(str(tmp_path / "t.stl"))


@pytest.mark.parametrize("case", ["constraints_file", "vocaset_mask", "no_mask", "missing"])
def test_template_from_paths(tmp_path, small_mesh, case, monkeypatch, caplog):
    """set_template_mesh from a mesh file: a constraints file gives the JAX
    package's template and ids; without one, the VOCASET mask beside the
    template's directory is read as data and never run; without a mask, no
    constraints and a warning; without a template, FileNotFoundError naming
    --template_mesh (there is no default template)."""
    verts, faces = small_mesh
    monkeypatch.setattr(tframe, "_state", dict(solver=None, verts=None, faces=None, consts={}))
    (tmp_path / "template").mkdir()
    ply = str(tmp_path / "template" / "t.ply")
    tmesh.write_ply(ply, verts, faces)
    ids = [0, 3, 7, 12]
    if case == "missing":
        for path in (None, str(tmp_path / "absent.ply")):
            with pytest.raises(FileNotFoundError, match="--template_mesh"):
                tframe.set_template_mesh(template_path=path)
        with pytest.raises(FileNotFoundError, match="--template_mesh"):
            tframe.get_solver()
        return
    if case == "constraints_file":
        (tmp_path / "c.txt").write_text(" ".join(map(str, ids[:2])) + "\n" +
                                        " ".join(map(str, ids[2:])) + "\n")
        monkeypatch.setattr(jframe, "_state", dict(verts=None, faces=None, cnst_indices=None,
                                                   solver=None, corres=None))
        jframe.set_template_mesh(ply, str(tmp_path / "c.txt"))
        solver = tframe.set_template_mesh(template_path=ply,
                                          constraints_path=str(tmp_path / "c.txt"))
        (t_verts, t_faces), (j_verts, j_faces) = tframe.template(), jframe.template()
        _equal(t_verts, j_verts)
        np.testing.assert_array_equal(t_faces, j_faces)  # int64 in the port, int32 in JAX
        _equal(np.asarray(solver.cnst_indices), jframe._state["cnst_indices"])
        return
    marker = tmp_path / "ran"
    if case == "vocaset_mask":
        (tmp_path / "mask").mkdir()
        (tmp_path / "mask" / "non_face.py").write_text(
            f"open({str(marker)!r}, 'w').close()\nnon_face_verts = {ids}\n")
    with caplog.at_level("WARNING"):
        solver = tframe.set_template_mesh(template_path=ply)
    _equal(np.asarray(solver.cnst_indices), np.asarray(ids if case == "vocaset_mask" else [],
                                                       np.int64))
    assert not marker.exists()
    assert ("non-face mask not found" in caplog.text) == (case == "no_mask")


def test_dataset_truth_sorts_negative_frames_numerically(tmp_path):
    """-00002 < -00001 < 000000: a lexical sort would play [-1, -2, 0, ...];
    tslist carries the true (negative) frame times (after tests/test_task.py)."""
    d = tmp_path / "sent00"
    d.mkdir()
    order = [-2, -1, 0, 1, 10]
    for fi in order:
        np.save(str(d / f"{fi:06d}.npy"), np.full((4,), float(fi), np.float32))
    np.save(str(d / "000000_lips_dist.npy"), np.zeros((1,)))  # not a frame
    got, want = ttruth(str(d), fps=60.0), jtruth(str(d), fps=60.0)
    _equal(got["data"], want["data"])
    assert got["tslist"] == want["tslist"] == [fi * 1000.0 / 60.0 for fi in order]
    np.testing.assert_array_equal(got["data"][:, 0], order)
    assert got["title"] == want["title"] == "truth"


@pytest.mark.parametrize("size", [(64, 64), (96, 128)])
def test_render_mesh_images(small_mesh, size):
    verts, faces = small_mesh
    _equal(trender.render_mesh(verts, faces, size), jrender.render_mesh(verts, faces, size))


@pytest.mark.parametrize("flip", [False, True])
def test_color_mapping(flip):
    values = np.random.default_rng(5).standard_normal((7, 9))
    _equal(tvideo.color_mapping(values, flip_rows=flip), jvis.color_mapping(values, flip_rows=flip))


def test_render_video_frames(tmp_path, small_mesh):
    """The grid video of a vertex-position track, an image track and an empty
    one: the same frames out of both writers."""
    import cv2

    verts, faces = small_mesh
    rng = np.random.default_rng(6)
    n = 12
    track = (verts[None] + rng.normal(0, 2e-3, (n,) + verts.shape)).astype(np.float32)
    tslist = list(np.arange(n) * 1000.0 / 30)
    images = rng.integers(0, 255, (4, 16, 16, 3), dtype=np.int64).astype(np.uint8)

    def sources():
        return [{"title": "pos", "verts_pos_3d": track.reshape(n, -1), "tslist": tslist},
                {"title": "img", "images": images, "tslist": [0.0, 90.0, 200.0, 300.0]},
                {"title": ""}]

    def frames(path):
        cap = cv2.VideoCapture(path)
        out = []
        ok, img = cap.read()
        while ok:
            out.append(img)
            ok, img = cap.read()
        cap.release()
        return np.stack(out)

    from sdfa_tpu.viewer import frame as jframe
    from sdfa_tpu_torch.viewer import frame as tframe

    saved_j, saved_t = dict(jframe._state), dict(tframe._state)
    try:
        jframe._state.update(verts=verts, faces=faces, solver=object())
        tframe._state.update(verts=verts, faces=faces, solver=object())
        kw = dict(video_fps=30.0, audio_sr=8000, grid_w=64, grid_h=48, font_size=12,
                  audio_signal=rng.uniform(-0.5, 0.5, 3200).astype(np.float32))
        pj = jvideo.render_video(sources(), video_path=str(tmp_path / "j" / "v.avi"), **kw)
        pt = tvideo.render_video(sources(), video_path=str(tmp_path / "t" / "v.avi"), device="cpu",
                                 **kw)
    finally:
        jframe._state.clear()
        jframe._state.update(saved_j)
        tframe._state.clear()
        tframe._state.update(saved_t)
    got, want = frames(pt), frames(pj)
    assert got.shape == want.shape == (n, 96, 128, 3)
    _equal(got, want)
    assert (tmp_path / "j" / "v.wav").read_bytes() == (tmp_path / "t" / "v.wav").read_bytes()


@pytest.mark.parametrize("name", ["FaceDataType", "PredictionType", "paths", "seed"])
def test_tools(name):
    import random

    from sdfa_tpu import tools as jtools
    from sdfa_tpu_torch import tools as ttools

    if name in ("FaceDataType", "PredictionType"):
        got, want = getattr(ttools, name), getattr(jtools, name)
        assert got.valid_types() == want.valid_types()
        if name == "FaceDataType":
            for t in list(want.valid_types()) + ["x"]:
                assert got.is_mesh(t) == want.is_mesh(t)
            assert got.is_mesh(got.dgrad_3d) and not got.is_mesh(got.blend_1d)
    elif name == "paths":
        for args in (("r", "m0", "neutral", 3), ("/a/b", "f1", "happy", 120)):
            path = ttools.data_dir(*args)
            assert path == jtools.data_dir(*args)
            assert ttools.parse_data_dir(path) == jtools.parse_data_dir(path)
        assert ttools.parse_data_dir("r/data/m0/neutral/sent007") == \
            jtools.parse_data_dir("r/data/m0/neutral/sent007")
    else:
        import torch

        draws = []
        for _ in range(2):
            assert ttools.seed_everything(7) == 7
            draws.append((random.random(), np.random.rand(), float(torch.rand(1))))
        assert draws[0] == draws[1]
        assert ttools.configure is __import__("sdfa_tpu_torch.config").config.configure
