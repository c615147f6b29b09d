"""TensorBoard summaries and the plot plugin registry (counterpart of
``sdfa_tpu/train/summary.py``).

Reference: saber/trainer/manager/tb_helpers.py:5-62 (nested-scalar, image,
audio, text and mesh writers) and experiment.py:158-185 (``register_plot``,
with the plugins of speech_anime/model/logger.py: predicted and true
meshes, the input feature maps, attention alignments, audio clips).

``SummaryHelper`` writes through ``torch.utils.tensorboard``, imported when
it is built. On a host without TensorBoard it is disabled (``enabled`` is
False) with one warning, the JAX package's contract, and every write is a
no-op; the JSONL and CSV records of ``trainer.py`` stay the primary record.
The image plugins colour-map through matplotlib: on a host with TensorBoard
and without matplotlib (the card's host) ``images`` is False, with one
warning, and they draw nothing; the mesh and audio plugins still write.

``run_plot_plugins`` calls every registered plugin, and, as in the JAX
package, a plugin that raises does not stop training; but no failure is
silent: each is logged with its traceback and counted in
``PLUGIN_FAILURES``. With the summary disabled it calls no plugin, since
nothing they draw could be written.
"""

from __future__ import annotations

import importlib.util
import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from ..utils import log

_log = logging.getLogger(__name__)

PLUGIN_FAILURES = 0  # plot plugin calls that raised, in this process


class SummaryHelper:
    """TensorBoard writer under ``log_dir``; ``log_dir=None`` builds a
    disabled one (a rank that does not write the run directory)."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        self.images = False  # whether the image plugins can colour-map (matplotlib)
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as exc:
            log.warn(f"tensorboard unavailable: {exc}")
            return
        self._writer = SummaryWriter(log_dir=log_dir)
        self.images = importlib.util.find_spec("matplotlib") is not None
        if not self.images:
            log.warn("matplotlib unavailable: the image summaries (inputs/mel, align/*) are "
                     "not drawn")

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def scalar(self, tag: str, value, step: int):
        """Nested dicts flatten into tag paths (tb_helpers.py:14-27)."""
        if self._writer is None:
            return
        if isinstance(value, dict):
            for key, val in value.items():
                self.scalar(f"{tag}/{key}", val, step)
        else:
            self._writer.add_scalar(tag, float(value), step)

    def image(self, tag: str, img: np.ndarray, step: int):
        if self._writer is None:
            return
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[None]
        elif img.ndim == 3 and img.shape[-1] in (1, 3, 4):
            img = np.transpose(img, (2, 0, 1))  # HWC → CHW
        self._writer.add_image(tag, img, step)

    def audio(self, tag: str, signal: np.ndarray, sr: int, step: int):
        if self._writer is None:
            return
        self._writer.add_audio(tag, np.asarray(signal)[None], step, sample_rate=sr)

    def text(self, tag: str, text: str, step: int):
        if self._writer is None:
            return
        self._writer.add_text(tag, text, step)

    def mesh(self, tag: str, verts: np.ndarray, faces: Optional[np.ndarray], step: int):
        if self._writer is None:
            return
        # copies: torch warns on non-writable numpy views
        v = torch.from_numpy(np.array(verts, np.float32))[None]
        f = torch.from_numpy(np.array(faces, np.int32))[None] if faces is not None else None
        self._writer.add_mesh(tag, vertices=v, faces=f, global_step=step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


# -- plot plugin registry (experiment.py:158-185) -----------------------------
_PLOT_PLUGINS: List[Callable] = []


def register_plot(fn: Callable) -> Callable:
    """Decorator: ``fn(summary, experiment, batch, outputs, step)`` is called
    every ``plot_gap_steps`` training steps; ``batch`` holds the step's host
    arrays, ``outputs`` what ``Experiment.plot_forward`` returned, on the host."""
    _PLOT_PLUGINS.append(fn)
    return fn


def run_plot_plugins(summary: SummaryHelper, experiment, batch, outputs, step: int):
    global PLUGIN_FAILURES
    if not summary.enabled:
        return
    for fn in _PLOT_PLUGINS:
        try:
            fn(summary, experiment, batch, outputs, step)
        except Exception:  # a plugin never stops training; its failure is logged and counted
            PLUGIN_FAILURES += 1
            _log.exception("plot plugin %s failed at step %d", fn.__name__, step)


# -- shipped plugins (speech_anime/model/logger.py:14-103 equivalents) --------
@register_plot
def plot_input_features(summary, experiment, batch, outputs, step):
    # raw-mode batches carry raw_wav only; plot_forward returns the
    # featurized audio_feat in outputs instead
    if not summary.images:
        return
    feats = batch.get("audio_feat")
    if feats is None and isinstance(outputs, dict):
        feats = outputs.get("audio_feat")
    if feats is None:
        return
    feats = np.asarray(feats)[:1]  # (1, T, F, C)
    if feats.ndim != 4:
        return
    from ..viewer.video import color_mapping

    summary.image("inputs/mel", color_mapping(feats[0, :, :, 0].T), step)  # mel channel (F, T)


@register_plot
def plot_anime_frames(summary, experiment, batch, outputs, step):
    """Predicted and true mesh frames as TensorBoard meshes (reference
    logger.py:14-34 plot_anime_frames): the first window's prediction and
    target decoded through the model's own PCA constants on the experiment's
    device, then solved over the installed template (``viewer.frame``)."""
    preds = outputs.get("prediction") if isinstance(outputs, dict) else None
    model = getattr(experiment, "model", None)
    if preds is None or model is None or not summary.enabled:
        return
    face_type = model.face_type
    if face_type not in ("dgrad_3d", "verts_off_3d", "verts_pos_3d"):
        return
    from ..viewer import frame as frame_mod

    device = experiment.device

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    with torch.no_grad():
        pred_frame = model.decode_to_anime(
            {k: on_device(np.asarray(v)[:1]) for k, v in preds.items()})[0, 0].cpu().numpy()

        def coef_decode(name, coef):
            # PCA-coefficient targets (trainer.pca_targets) through the model's bases
            return getattr(model, name).decode_targets(on_device(coef)).cpu().numpy()

        true_frame = None
        if face_type == "dgrad_3d":
            if "dgrad_3d_scale" in batch:
                s = np.asarray(batch["dgrad_3d_scale"][0, 0], np.float32)
                r = np.asarray(batch["dgrad_3d_rotat"][0, 0], np.float32)
                true_frame = np.concatenate([s, r], axis=-1).reshape(-1)
            elif "dgrad_3d_scale_coef" in batch and getattr(model, "scale_pca", None) is not None:
                s = coef_decode("scale_pca", np.asarray(batch["dgrad_3d_scale_coef"][0, 0]))
                r = coef_decode("rotat_pca", np.asarray(batch["dgrad_3d_rotat_coef"][0, 0]))
                n_tris = s.shape[-1] // 6
                true_frame = np.concatenate([s.reshape(n_tris, 6), r.reshape(n_tris, 3)],
                                            axis=-1).reshape(-1)
        elif face_type in batch:
            true_frame = np.asarray(batch[face_type][0, 0], np.float32).reshape(-1)
        elif f"{face_type}_coef" in batch and getattr(model, "pca", None) is not None:
            true_frame = coef_decode("pca", np.asarray(batch[f"{face_type}_coef"][0, 0])
                                     ).reshape(-1)

    verts_p, faces = frame_mod.frames_to_meshes(pred_frame, face_type, device=device)
    summary.mesh("anime-0/frame-pred", verts_p[0], faces, step)
    if true_frame is not None:
        verts_t, _ = frame_mod.frames_to_meshes(true_frame, face_type, device=device)
        summary.mesh("anime-0/frame-true", verts_t[0], faces, step)


@register_plot
def plot_audio_clips(summary, experiment, batch, outputs, step):
    """Input audio clips (reference logger.py:95-103 _add_audio). Host-
    feature batches carry the window signal when plotting is enabled
    (the reader's ``signal`` key); raw-mode batches always carry raw_wav."""
    sig = batch.get("signal")
    if sig is None:
        sig = batch.get("raw_wav")
    if sig is None:
        return
    sr = int(experiment.hp.audio.sample_rate)
    summary.audio("anime-0/audio-signal", np.asarray(sig)[0], sr, step)


@register_plot
def plot_attention_alignment(summary, experiment, batch, outputs, step):
    aligns = outputs.get("align_dict") if isinstance(outputs, dict) else None
    if not aligns or not summary.images:
        return
    from ..viewer.video import color_mapping

    for tag, align in aligns.items():
        a = np.asarray(align)[0]  # (1, T)
        summary.image(f"align/{tag}", color_mapping(a), step)
