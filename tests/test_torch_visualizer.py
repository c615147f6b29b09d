"""``utils/visualizer.py`` and ``visualize.py`` against the JAX package.

The plotting helpers are the same matplotlib code, so the images of
``plot`` / ``plot_grid`` / the bars / the aligned transcription / the "same"
value range (the cases of ``tests/test_misc_components.py::TestVisualizer``)
must be equal pixel for pixel; ``color_mapping`` is the viewer's one colour
map. ``visualize_dataset`` on a generated dataset hands ``render_video`` the
sources JAX's hands it (both captured by monkeypatching), and one real video
is written over a small synthetic template on the CPU."""

import os

import numpy as np
import pytest

from sdfa_tpu import viewer as jviewer
from sdfa_tpu import visualize as jvisualize
from sdfa_tpu.utils import visualizer as jvis
from sdfa_tpu_torch import viewer, visualize
from sdfa_tpu_torch.data import synthetic
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.utils import visualizer as tvis
from sdfa_tpu_torch.viewer import frame, video

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


def _figures(vis):
    """Each JAX test case's image, drawn by ``vis``."""
    rng = np.random.default_rng(2)
    pi = vis.plot_item
    out = {"grid": vis.plot_grid([np.random.default_rng(1).normal(size=(8, 8)),
                                  dict(data=np.arange(10.0), title="curve")])}
    spec = pi(rng.normal(size=(16, 24)), title="spec",
              index_labels=["a"] * 8 + ["b"] * 8 + ["c"] * 8)
    curve = pi((np.arange(32.0), np.sin(np.arange(32.0) / 4)), title="xy")
    out["rows"] = vis.plot([spec, curve], pi(rng.uniform(size=(3, 10, 12)), title="chw"),
                           suptitle="grid")
    out["bars"] = vis.plot(pi(np.array([0.3, 0.9, 0.5]), title="bars", labels=["p", "m", "e"],
                              rectangle=True))
    sig = np.sin(np.arange(8000 * 2) * 0.05).astype(np.float32)
    words = vis.Transcription(words=[vis.Word("hello", 0.20, 0.55), vis.Word("world", 0.80, 1.30)])
    out["aligned"] = vis.plot(pi(sig, title="utt", sr=8000, aligned_transcription=words))
    out["same"] = vis.plot([pi(np.zeros((4, 4)), title="lo", vmin=0.0, vmax=1.0),
                            pi(np.ones((4, 4)), title="hi", vmin=-2.0, vmax=3.0)],
                           val_mode="same")
    return out


def test_figures_pixel_equal_to_jax():
    want, got = _figures(jvis), _figures(tvis)
    for name, img in got.items():
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3, name
        np.testing.assert_array_equal(img, want[name], err_msg=name)
    assert got["aligned"].std() > 0


def test_value_range_same_mode_and_colour_map(tmp_path):
    a = tvis.plot_item(np.zeros((4, 4)), title="lo", vmin=0.0, vmax=1.0)
    b = tvis.plot_item(np.ones((4, 4)), title="hi", vmin=-2.0, vmax=3.0)
    grid = tvis._GridLayout([[a, b]])
    grid.set_value_range(None, None, mode="same")
    assert a.vmin == b.vmin == -2.0 and a.vmax == b.vmax == 3.0
    assert tvis.color_mapping is video.color_mapping
    values = np.random.default_rng(0).normal(size=(16, 32))
    np.testing.assert_array_equal(tvis.color_mapping(values), jvis.color_mapping(values))
    path = tmp_path / "out" / "fig"
    img = tvis.plot(a, file_path=str(path))
    assert (tmp_path / "out" / "fig.png").exists() and img.ndim == 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vis")
    verts, faces, cnst = synthetic_template(3, n_major=6, n_minor=8, n_extra=2, n_free=20)
    saved = synthetic.N_TRIS
    synthetic.N_TRIS = len(faces)
    try:
        root = synthetic.generate(str(tmp / "voca"), "dgrad_3d", speakers=["m0", "f0"],
                                  sentences_per_speaker=1, seconds_per_sentence=0.5)
    finally:
        synthetic.N_TRIS = saved
    return tmp, root, (verts, faces, cnst)


def _captured(monkeypatch, module, fn_owner, root, out_dir):
    calls = []
    monkeypatch.setattr(fn_owner, "render_video",
                        lambda **kw: calls.append(kw) or kw["video_path"])
    module.visualize_dataset(root, out_dir=out_dir, max_items=2)
    return calls


def test_render_sources_match_jax(dataset, monkeypatch):
    tmp, root, _ = dataset
    want = _captured(monkeypatch, jvisualize, jviewer, root, str(tmp / "jax"))
    monkeypatch.setattr(video, "require_video", lambda *a, **k: None)
    got = _captured(monkeypatch, visualize, viewer, root, str(tmp / "port"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        (gs,), (ws,) = g["sources"], w["sources"]
        assert sorted(gs) == sorted(ws) and gs["title"] == ws["title"]
        assert gs["tslist"] == ws["tslist"]
        np.testing.assert_array_equal(gs["dgrad_3d"], ws["dgrad_3d"])
        assert (g["video_fps"], g["audio_sr"]) == (w["video_fps"], w["audio_sr"])
        np.testing.assert_array_equal(g["audio_signal"], w["audio_signal"])
        assert os.path.basename(g["video_path"]) == os.path.basename(w["video_path"])
        assert g["device"] == "cuda"  # the port's default; the CLI's --platform says otherwise


def test_one_real_video(dataset):
    tmp, root, (verts, faces, cnst) = dataset
    saved = dict(frame._state)
    try:
        frame.set_template_mesh(verts, faces, cnst)
        out = visualize.visualize_dataset(root, out_dir=str(tmp / "videos"), max_items=1,
                                          device="cpu")
    finally:
        frame._state.clear()
        frame._state.update(saved)
    (name,) = [f for f in os.listdir(out) if f.endswith(".avi")]
    assert os.path.getsize(os.path.join(out, name)) > 0


def test_main_refuses_without_template(dataset):
    _, root, _ = dataset
    saved = dict(frame._state)
    try:
        frame._state.update(solver=None, verts=None, faces=None)
        with pytest.raises(FileNotFoundError, match="--template_mesh"):
            visualize.main(["--dataset_root", root, "--max_items", "1", "--platform", "cpu",
                            "--out_dir", root + "_videos"])
    finally:
        frame._state.clear()
        frame._state.update(saved)
