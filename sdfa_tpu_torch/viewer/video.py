"""Evaluation outputs (counterpart of ``sdfa_tpu/viewer/video.py``, copied):
per-frame mesh export and the grid video.

Reference: speech_anime/viewer/video.py:41-295 (grid rows and columns,
per-source timestamp seek, titles, audio mux) and model.py:201-212 (mesh
frames). Meshes are reconstructed by ``frame.frames_to_meshes`` on the
device the caller names. The video is written by OpenCV's ``VideoWriter``
(XVID), imported inside ``render_video``: the package imports without
OpenCV, and ``require_video`` says early when a host cannot write video.
Audio is muxed by ``ffmpeg`` when it is on the ``PATH``; otherwise the wav
is saved beside the video.
"""

from __future__ import annotations

import logging
import math
import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

from ..tools import FaceDataType
from ..utils import stream
from . import frame as frame_mod
from .render import render_mesh

log = logging.getLogger(__name__)


def require_video(draw_latent: bool = False):
    """Raises ``ImportError`` unless this host can render video: OpenCV, and
    matplotlib for ``draw_latent``'s colour maps."""
    import importlib.util

    missing = [m for m in ("cv2",) + (("matplotlib",) if draw_latent else ())
               if importlib.util.find_spec(m) is None]
    if missing:
        raise ImportError(
            f"video rendering needs {' and '.join(missing)}, which this host lacks: "
            "pass save_video=False (--no-save_video) to export the mesh frames only")


def color_mapping(values, vmin=None, vmax=None, cmap: str = "viridis",
                  flip_rows: bool = False) -> np.ndarray:
    """(H, W) floats → (H, W, 3) uint8 through a matplotlib colormap (the
    alpha channel is dropped; counterpart of
    ``sdfa_tpu/utils/visualizer.py::color_mapping``)."""
    import matplotlib as mpl

    values = np.asarray(values, np.float64)
    if values.ndim != 2:
        raise ValueError("color_mapping() only works for 2d arrays")
    norm = mpl.colors.Normalize(
        vmin=values.min() if vmin is None else vmin,
        vmax=values.max() if vmax is None else vmax, clip=True)
    rgba = mpl.colormaps[cmap](norm(values))
    img = (rgba[..., :3] * 255.0 + 0.5).astype(np.uint8)
    return img[::-1] if flip_rows else img


def _grid_dims(n: int):
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    return rows, cols


def render_video(
    sources: List[Dict],
    video_fps: float,
    audio_sr: int,
    video_path: str,
    save_video: bool = True,
    grid_w: int = 512,
    grid_h: int = 512,
    font_size: int = 24,
    audio_signal: Optional[np.ndarray] = None,
    max_seconds: Optional[float] = None,
    device="cuda",
):
    """Each source dict: {"title", one of the FaceDataType keys or "images",
    "tslist"}. Mesh sources are reconstructed in one batched solve on
    ``device``, then rendered frame by frame."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(video_path)), exist_ok=True)

    # the duration is the longest source's
    durations = [s["tslist"][-1] for s in sources if s.get("tslist") is not None]
    total_ms = max(durations) if durations else 0.0
    if max_seconds is not None:
        total_ms = min(total_ms, max_seconds * 1000.0)
    n_frames = int(total_ms * video_fps / 1000.0) + 1
    ts_queries = np.arange(n_frames) * 1000.0 / video_fps

    rendered: List[List[np.ndarray]] = []
    for src in sources:
        face_key = next((k for k in src if FaceDataType.__members__.get(k)), None)
        frames_imgs = []
        if face_key is not None:
            data = stream.seek_many(ts_queries, src["tslist"], np.asarray(src[face_key]))
            verts, faces = frame_mod.frames_to_meshes(data, face_key, device)
            for vi in verts:
                frames_imgs.append(render_mesh(vi, faces, (grid_h, grid_w)))
        elif "images" in src:
            imgs = np.asarray(src["images"])
            src_ts = np.asarray(src.get("tslist", np.arange(len(imgs)) * 1000.0 / video_fps))
            for ts in ts_queries:
                idx = int(np.clip(np.searchsorted(src_ts, ts, "right") - 1, 0, len(imgs) - 1))
                frames_imgs.append(cv2.resize(imgs[idx], (grid_w, grid_h)))
        else:
            frames_imgs = [np.zeros((grid_h, grid_w, 3), np.uint8)] * n_frames
        title = src.get("title", "")
        if title:
            for img in frames_imgs:
                cv2.putText(img, title, (8, 24), cv2.FONT_HERSHEY_SIMPLEX,
                            font_size / 48.0, (255, 255, 255), 1, cv2.LINE_AA)
        rendered.append(frames_imgs)

    rows, cols = _grid_dims(len(sources))
    out_w, out_h = cols * grid_w, rows * grid_h
    tmp_path = os.path.splitext(video_path)[0] + "_noaudio.avi"
    writer = cv2.VideoWriter(tmp_path, cv2.VideoWriter_fourcc(*"XVID"),
                             video_fps, (out_w, out_h))
    for i in range(n_frames):
        canvas = np.zeros((out_h, out_w, 3), np.uint8)
        for j, imgs in enumerate(rendered):
            r, c = divmod(j, cols)
            canvas[r * grid_h:(r + 1) * grid_h, c * grid_w:(c + 1) * grid_w] = imgs[i]
        writer.write(canvas[:, :, ::-1])  # RGB → BGR
    writer.release()

    final_path = video_path
    if audio_signal is not None:
        from ..audio import io as audio_io

        wav_path = os.path.splitext(video_path)[0] + ".wav"
        audio_io.save(wav_path, audio_signal, audio_sr)
        if shutil.which("ffmpeg"):
            subprocess.run(
                ["ffmpeg", "-y", "-i", tmp_path, "-i", wav_path,
                 "-c:v", "libx264", "-crf", "15", "-c:a", "aac", final_path],
                check=False, capture_output=True,
            )
            if os.path.exists(final_path):
                os.remove(tmp_path)
                return final_path
        log.warning("ffmpeg unavailable: video saved without muxed audio")
    if tmp_path != final_path:
        shutil.move(tmp_path, final_path)
    return final_path


def export_mesh_frames(
    out_dir: str,
    tslist,
    animes: np.ndarray,
    face_type: str,
    fps: float,
    audio_signal: Optional[np.ndarray] = None,
    audio_sr: int = 44100,
    device="cuda",
):
    """Per output frame at ``fps``: ``%06d.obj`` (the mesh) and
    ``%06d_<face_type>.npy`` (the prediction frame it was solved from), and
    ``audio.wav`` (reference model.py:201-212)."""
    from ..mesh import io as mesh_io

    os.makedirs(out_dir, exist_ok=True)
    if audio_signal is not None:
        from ..audio import io as audio_io

        audio_io.save(os.path.join(out_dir, "audio.wav"), audio_signal, audio_sr)
    max_frame = int(tslist[-1] * fps / 1000.0)
    ts_queries = np.arange(max_frame + 1) * 1000.0 / fps
    data = stream.seek_many(ts_queries, tslist, np.asarray(animes))
    verts, faces = frame_mod.frames_to_meshes(data, face_type, device)
    for i in range(len(verts)):
        mesh_io.write_obj(os.path.join(out_dir, f"{i:06d}.obj"), verts[i], faces)
        np.save(os.path.join(out_dir, f"{i:06d}_{face_type}.npy"), data[i])
    return out_dir
