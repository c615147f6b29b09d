"""Audio DSP primitives (counterpart of ``sdfa_tpu/audio/dsp.py``).

Constants (windows, DFT bases, mel filters, Savitzky-Golay delta
operators) are float32 numpy built on the host exactly as the JAX package
builds them; the runtime ops take torch tensors on any device. ``resample``
is the host's polyphase resampler that prepares a source before it reaches
the device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=None)
def get_window(win_fn: str, win_size: int) -> np.ndarray:
    """Symmetric numpy windows (``np.hamming``/``np.hanning``)."""
    names = {"hamm": "hamming", "hann": "hanning", "hamming": "hamming",
             "hanning": "hanning", "ones": "ones"}
    if win_fn not in names:
        raise ValueError(f"unknown window: {win_fn}")
    return getattr(np, names[win_fn])(win_size).astype(np.float32)


def preemphasis(signal: torch.Tensor, a: float = 0.0) -> torch.Tensor:
    if a is None or a == 0:
        return signal
    return torch.cat([signal[..., :1], signal[..., 1:] - a * signal[..., :-1]], dim=-1)


def frame_signal(signal: torch.Tensor, win_size: int, hop_size: int) -> torch.Tensor:
    """(..., n_samples) → (..., n_frames, win_size); no padding."""
    return signal.unfold(-1, win_size, hop_size)


def rms_energy(signal: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., n_samples) → per-frame RMS (..., n_frames)."""
    frames = frame_signal(signal, frame_length, hop_length)
    return torch.sqrt(torch.mean(frames * frames, dim=-1))


@functools.lru_cache(maxsize=None)
def dft_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_fft//2+1) cos/-sin bases for the onesided real DFT."""
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(freq / min_log_hz) / logstep, freq / f_sp)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


@functools.lru_cache(maxsize=None)
def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) slaney-normalized triangular filterbank."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power, min=F32_EPS))


def normalize_db(db: torch.Tensor, ref_db: float, top_db: float, clip: bool = True):
    out = (db - ref_db + top_db) / top_db
    return torch.clamp(out, 0.0, 1.0) if clip else out


@functools.lru_cache(maxsize=None)
def delta_matrix(n_frames: int, order: int, width: int = 9) -> np.ndarray:
    """(T, T) operator R with ``delta(feat) == feat @ R`` (librosa's delta:
    Savitzky-Golay, mode='interp', applied to the identity)."""
    from scipy.signal import savgol_filter

    eye = np.eye(n_frames, dtype=np.float64)
    resp = savgol_filter(eye, width, polyorder=order, deriv=order, axis=-1, mode="interp")
    return resp.astype(np.float32)


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy ``resample_poly`` in float64),
    float32 out."""
    if orig_sr == target_sr:
        return np.asarray(signal, dtype=np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(np.asarray(signal, dtype=np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)
