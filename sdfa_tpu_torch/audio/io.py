"""Wav I/O (counterpart of ``sdfa_tpu/audio/io.py``, copied; reference:
saber/data/audio/io.py:9-22).

``scipy.io.wavfile`` with normalization to float32 in [-1, 1], a downmix of
multi-channel data and optional polyphase resampling to a target rate.
Other containers (video, compressed audio) go through ``ffmpeg`` when it is
on the ``PATH``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from . import dsp


def load(path: str, sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    ext = os.path.splitext(path)[1].lower()
    if ext not in (".wav", ".wave"):
        # video / compressed sources (the reference's evaluation takes mp4,
        # eval_utils.py:50-91) need ffmpeg to demux
        if not shutil.which("ffmpeg"):
            raise ValueError(f"cannot load '{ext}' audio without ffmpeg; provide a wav")
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            tmp_path = tmp.name
        try:
            subprocess.run(["ffmpeg", "-y", "-i", path, "-ac", "1", "-f", "wav", tmp_path],
                           check=True, capture_output=True)
            return load(tmp_path, sr=sr)
        finally:
            os.unlink(tmp_path)

    orig_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        signal = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        signal = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        signal = (data.astype(np.float32) - 128.0) / 128.0
    else:
        signal = data.astype(np.float32)
    if signal.ndim > 1:  # downmix
        signal = signal.mean(axis=1)
    if sr is not None and sr != orig_sr:
        signal = dsp.resample(signal, orig_sr, sr)
        orig_sr = sr
    return signal, orig_sr


def save(path: str, signal: np.ndarray, sr: int):
    from scipy.io import wavfile

    data = np.clip(np.asarray(signal, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, int(sr), (data * 32767.0).astype(np.int16))
