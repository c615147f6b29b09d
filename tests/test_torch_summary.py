"""TensorBoard summaries, the plot plugins, ``Experiment.plot_forward`` and the
mid-training evaluation of the port's ``Trainer``, against the JAX package.

- ``plot_gap_steps``: the port's ``Trainer`` writes the ``inputs/mel`` image,
  as ``tests/test_experiment_resume.py::TestPlotPlugins`` requires of JAX,
  and the mesh, audio and alignment tags, with the train scalars;
- the four plugins on a narrow dgrad model over a small synthetic template
  write ``frame-pred``, ``frame-true`` and ``audio-signal``
  (``TestMeshAudioPlugins``), from face data and from PCA-coefficient
  targets; ``summary.PLUGIN_FAILURES`` stays 0; a plugin that raises is
  counted and logged with its traceback, and the others still run; without
  TensorBoard the helper is disabled and no plugin runs;
- ``plot_forward``: predictions, latent and alignments within 1e-5 of the
  JAX ``Experiment.plot_forward_fn`` on the same weights (carried by
  ``compat/from_flax.py``), float32 on both sides;
- ``eval_gap_epochs``: ``eval_at_train/epoch0001/<name>.avi`` with the frame
  count JAX's geometry gives the clip; without OpenCV the ``Trainer``
  refuses when it is built, before any step.
"""

import glob
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax

from test_torch_slice import _signal, narrow_model
from test_torch_train_step import KR, KS, _batch, _hparams, _jax_model, _specs

from sdfa_tpu.audio import pipeline as jpipe
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu.train import Experiment as JExperiment
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch.audio import io as audio_io
from sdfa_tpu_torch.compat import load_flax_variables
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation as TModel
from sdfa_tpu_torch.ops import bilstm_core
from sdfa_tpu_torch.train import Experiment, Trainer, summary
from sdfa_tpu_torch.train import trainer as trainer_mod
from sdfa_tpu_torch.viewer import frame

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

PLOT_FORWARD_TOL = 1e-5  # port vs JAX, predictions, latent and alignments


@pytest.fixture(scope="module")
def template():
    """A small synthetic template (48 triangles) installed for the module."""
    verts, faces, cnst = synthetic_template(1, n_major=6, n_minor=4, n_extra=0, n_free=8)
    saved = dict(frame._state)
    frame.set_template_mesh(verts, faces, cnst)
    yield len(faces)
    frame._state.clear()
    frame._state.update(saved)


def _narrow_model(n_tris, seed=9):
    """``test_torch_train_step``'s narrow network over ``n_tris`` triangles, with
    seeded PCA bases, initialized by ``Experiment``."""
    enc, trunk, head_s, head_r = _specs(0.0)
    model = TModel(enc, trunk, head_s, head_r, 6 * n_tris, 3 * n_tris, KS, KR, weight_norm=True,
                   num_speakers=2)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, k, per in (("scale", KS, 6), ("rotat", KR, 3)):
            sub = getattr(model, f"{name}_pca")
            sub.compT.copy_(torch.from_numpy(rng.normal(0, 0.02, (per * n_tris, k))
                                             .astype(np.float32)))
            sub.means.copy_(torch.from_numpy(rng.normal(0, 0.01, (per * n_tris,))
                                             .astype(np.float32)))
    return model


def _plot_batch(n_tris, seed, coef=True, bsz=4):
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 2, (bsz // 2,))
    batch = {"audio_feat": rng.normal(0.4, 0.3, (bsz, 8, 16, 3)).astype(np.float32),
             "speaker_id": np.concatenate([half, half]),
             "signal": rng.normal(0, 0.1, (bsz, 600)).astype(np.float32)}
    if coef:
        batch["dgrad_3d_scale_coef"] = rng.normal(0, 1, (bsz, 1, KS)).astype(np.float32)
        batch["dgrad_3d_rotat_coef"] = rng.normal(0, 1, (bsz, 1, KR)).astype(np.float32)
    else:
        batch["dgrad_3d_scale"] = rng.normal(0, 0.01, (bsz, 1, n_tris, 6)).astype(np.float32)
        batch["dgrad_3d_rotat"] = rng.normal(0, 0.01, (bsz, 1, n_tris, 3)).astype(np.float32)
    return batch


def _events(log_dir):
    blob = b""
    for path in glob.glob(os.path.join(log_dir, "**", "events.out.tfevents*"), recursive=True):
        with open(path, "rb") as fp:
            blob += fp.read()
    return blob


def test_plot_gap_steps_writes_tb_events(tmp_path, template, monkeypatch):
    monkeypatch.setattr(trainer_mod, "METRICS_EVERY", 2)
    failures = summary.PLUGIN_FAILURES
    exp = Experiment(TConfig(_hparams(trainer=dict(plot_gap_steps=2))),
                     _narrow_model(template), str(tmp_path / "run"), "cpu")
    assert exp.summary.enabled
    trainer = Trainer(exp, [_plot_batch(template, 20 + i, coef=i % 2 == 0) for i in range(4)])
    trainer.train()
    assert exp.step == 4 and len(trainer.step_metrics) == 4
    blob = _events(str(tmp_path / "run" / "train_log" / "tb"))
    for tag in (b"inputs/mel", b"anime-0/frame-pred", b"anime-0/frame-true",
                b"anime-0/audio-signal", b"align/", b"train/total", b"train/grad_norm"):
        assert tag in blob, tag
    assert summary.PLUGIN_FAILURES == failures == 0


@pytest.mark.parametrize("coef", [True, False], ids=["coef-targets", "face-data-targets"])
def test_four_plugins_write_their_tags(tmp_path, template, coef):
    exp = Experiment(TConfig(_hparams()), _narrow_model(template), str(tmp_path / "run"), "cpu")
    batch = _plot_batch(template, 30, coef=coef)
    outputs = exp.plot_forward(batch)
    host_out = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
                for k, v in outputs.items()}
    helper = summary.SummaryHelper(str(tmp_path / "tb"))
    summary.run_plot_plugins(helper, exp, batch, host_out, 1)
    helper.flush()
    blob = _events(str(tmp_path / "tb"))
    for tag in (b"frame-pred", b"frame-true", b"audio-signal", b"inputs/mel"):
        assert tag in blob, tag
    assert summary.PLUGIN_FAILURES == 0


def test_failing_plugin_is_counted_and_logged(tmp_path, template, caplog):
    exp = Experiment(TConfig(_hparams()), _narrow_model(template), str(tmp_path / "run"), "cpu")
    calls = []

    def broken(*args):
        raise RuntimeError("drawn badly")

    def after(*args):
        calls.append(args[-1])

    summary._PLOT_PLUGINS[:0] = [broken]
    summary._PLOT_PLUGINS.append(after)
    before = summary.PLUGIN_FAILURES
    try:
        with caplog.at_level(logging.ERROR, logger=summary.__name__):
            summary.run_plot_plugins(exp.summary, exp, _plot_batch(template, 31), {}, 7)
    finally:
        summary._PLOT_PLUGINS.remove(broken)
        summary._PLOT_PLUGINS.remove(after)
        counted = summary.PLUGIN_FAILURES - before
        summary.PLUGIN_FAILURES = before
    assert counted == 1 and calls == [7]  # the plugins after it ran
    (record,) = [r for r in caplog.records if "broken" in r.getMessage()]
    assert record.exc_info and "drawn badly" in caplog.text and "Traceback" in caplog.text


def test_without_tensorboard_no_plugin_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    helper = summary.SummaryHelper(str(tmp_path / "tb"))
    assert not helper.enabled
    assert "[WARN ] tensorboard unavailable" in capsys.readouterr().out
    helper.scalar("train", {"a": 1.0}, 0)
    helper.flush()
    calls = []
    summary._PLOT_PLUGINS.append(lambda *a: calls.append(a))
    try:
        summary.run_plot_plugins(helper, None, {}, {}, 0)
    finally:
        summary._PLOT_PLUGINS.pop()
    assert calls == [] and not os.path.exists(tmp_path / "tb")
    assert not summary.SummaryHelper(None).enabled  # a rank that does not write


def test_without_matplotlib_the_image_plugins_draw_nothing(tmp_path, template, monkeypatch,
                                                           capsys):
    """The card's host has TensorBoard and no matplotlib: the helper writes,
    the image plugins skip (one warning when the helper is built), the mesh
    and audio plugins write, and nothing fails."""
    exp = Experiment(TConfig(_hparams()), _narrow_model(template), str(tmp_path / "run"), "cpu")
    batch = _plot_batch(template, 32)
    outputs = exp.plot_forward(batch)
    host_out = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
                for k, v in outputs.items()}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    helper = summary.SummaryHelper(str(tmp_path / "tb"))
    assert helper.enabled and not helper.images
    assert "[WARN ] matplotlib unavailable" in capsys.readouterr().out
    summary.run_plot_plugins(helper, exp, batch, host_out, 3)
    helper.flush()
    blob = _events(str(tmp_path / "tb"))
    assert b"frame-pred" in blob and b"audio-signal" in blob
    assert b"inputs/mel" not in blob and b"align/" not in blob
    assert summary.PLUGIN_FAILURES == 0


def test_plot_forward_matches_jax(tmp_path):
    hp = _hparams()
    jexp = JExperiment(JConfig(hp), _jax_model(), log_dir=str(tmp_path / "jax"), training=True)
    exp = Experiment(TConfig(hp), TModel(*_specs(0.0), 60, 30, KS, KR, weight_norm=True,
                                         num_speakers=2), str(tmp_path / "port"), "cpu")
    state = jax.device_get(jexp.state)
    load_flax_variables(exp.model, {"params": state.params, "batch_stats": state.batch_stats,
                                    "constants": state.constants})
    batch = _batch(40, coef=True)
    want = jax.device_get(jexp.plot_forward_fn(jexp.state, {k: jax.numpy.asarray(v)
                                                            for k, v in batch.items()},
                                               jax.random.PRNGKey(1)))
    exp.model.train()
    got = exp.plot_forward(batch)
    assert exp.model.training  # back in its mode
    assert sorted(got) == sorted(want) == ["align_dict", "audio_feat", "latent", "prediction"]
    assert sorted(got["prediction"]) == sorted(want["prediction"])
    pairs = [(got["prediction"][k], want["prediction"][k]) for k in want["prediction"]]
    pairs += [(got["latent"], want["latent"]), (got["audio_feat"], want["audio_feat"])]
    pairs += [(got["align_dict"][k], want["align_dict"][k]) for k in want["align_dict"]]
    for g, w in pairs:
        assert tuple(g.shape) == tuple(np.shape(w))
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= PLOT_FORWARD_TOL


@pytest.fixture(scope="module")
def dgrad_narrow(tmp_path_factory):
    """The dgrad config with the narrow network over a 240-triangle template,
    seeded PCA bases, a 1 s wav as the evaluation source; the template
    installed for the module."""
    tmp = tmp_path_factory.mktemp("midtrain")
    verts, faces, cnst = synthetic_template(2, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    net = narrow_model()
    wav = str(tmp / "clip.wav")
    audio_io.save(wav, _signal(1.0, 5), 8000)  # 1 s at the model's rate
    overrides = {"model": {"audio_encoder": net["audio_encoder"],
                           "output": dict(net["output"], output_dim_scale=6 * n,
                                          output_dim_rotat=3 * n)},
                 "trainer": {"max_epochs": 1, "save_gap_epochs": None, "eval_gap_epochs": 1,
                             "plot_gap_steps": 0, "evaluate": {"test": [[wav, "speaker=m0"]]}}}
    rng = np.random.default_rng(0)
    pca = {"scale_compT": rng.normal(0, 0.02, (6 * n, 85)).astype(np.float32),
           "scale_means": rng.normal(0, 0.02, (6 * n,)).astype(np.float32),
           "rotat_compT": rng.normal(0, 0.02, (3 * n, 180)).astype(np.float32),
           "rotat_means": rng.normal(0, 0.02, (3 * n,)).astype(np.float32)}
    saved = dict(frame._state)
    frame.set_template_mesh(verts, faces, cnst)
    yield tmp, overrides, pca, wav
    frame._state.clear()
    frame._state.update(saved)


def _feature_batches(n, bsz=4):
    out = []
    for i in range(n):
        rng = np.random.default_rng(50 + i)
        half = rng.integers(0, 8, (bsz // 2,))
        out.append({"audio_feat": rng.normal(0.4, 0.2, (bsz, 64, 128, 3)).astype(np.float32),
                    "speaker_id": np.concatenate([half, half]),
                    "dgrad_3d_scale_coef": rng.normal(0, 1, (bsz, 1, 85)).astype(np.float32),
                    "dgrad_3d_rotat_coef": rng.normal(0, 1, (bsz, 1, 180)).astype(np.float32)})
    return out


def test_mid_training_evaluation_writes_video(dgrad_narrow):
    import cv2

    tmp, overrides, pca, wav = dgrad_narrow
    hp = configure("dgrad", overrides=overrides)
    exp = Experiment(hp, build_model(hp, pca=pca), str(tmp / "run"), "cpu")
    Trainer(exp, _feature_batches(2)).train()
    path = os.path.join(str(tmp / "run"), "eval_at_train", "epoch0001", "clip.avi")
    assert os.path.exists(path)
    cap = cv2.VideoCapture(path)
    frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    # JAX's geometry: the clip's windows at the model's rate give the tslist that
    # render_video spans at the video's fps
    spec = jpipe.WindowSpec(jconfigure("dgrad"))
    _, ts_list = spec.window_starts(8000)
    fps = float(hp.anime.fps)
    assert frames == int(ts_list[-1] * fps / 1000.0) + 1


def test_trainer_refuses_mid_training_evaluation_without_opencv(dgrad_narrow, monkeypatch):
    tmp, overrides, pca, _ = dgrad_narrow
    hp = configure("dgrad", overrides=overrides)
    exp = Experiment(hp, build_model(hp, pca=pca), str(tmp / "refused"), "cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)
    bilstm_core.FWD_LAUNCHES = 0
    with pytest.raises(ImportError, match="video rendering needs cv2"):
        Trainer(exp, _feature_batches(1))
    assert exp.step == 0
    # without a source that exists there is nothing to render, and nothing to refuse
    hp.trainer.evaluate.set_key("test", [[str(tmp / "missing.wav"), "speaker=m0"]])
    Trainer(exp, _feature_batches(1))
