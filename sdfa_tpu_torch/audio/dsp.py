"""Audio DSP primitives (counterpart of ``sdfa_tpu/audio/dsp.py``).

Constants (windows, DFT bases, mel filters, Savitzky-Golay delta
operators) are float32 numpy built on the host exactly as the JAX package
builds them; the runtime ops take torch tensors on any device. The power
spectrogram is the frontend's DFT-basis products (``audio/pipeline.py``),
with the constants kept on the tensor's device as the frontend keeps them;
``mel_spectrogram``, ``spectrogram``, ``delta`` and ``add_deltas`` are the
feature registry's (``audio/features.py``). ``resample``
is the host's polyphase resampler that prepares a source before it reaches
the device. The inverse spectrograms (Griffin-Lim) and the phase-vocoder
time stretch and pitch shift are numpy on the host, as in the JAX package:
the preprocessing writes its pitch-shifted audio variants with them.
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


def deemphasis(signal: np.ndarray, a: float = 0.0) -> np.ndarray:
    """Inverse of ``preemphasis`` on a host signal."""
    if a is None or a == 0:
        return signal
    out = np.array(signal, dtype=np.float64)
    for i in range(1, len(out)):
        out[i] += out[i - 1] * a
    return out.astype(np.float32)


def num_frames(n_samples: int, win_size: int, hop_size: int) -> int:
    """torch.stft(center=False) frame count."""
    return 1 + (n_samples - win_size) // hop_size


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


def stft_power(signal: torch.Tensor, win_size: int, hop_size: int, win_fn: str = "hamm",
               padding: bool = False) -> torch.Tensor:
    """Power spectrogram (..., n_freq, n_frames) with torch.stft semantics
    (``padding=True``: ``center=True, pad_mode='constant'``), as two products
    with the real DFT's cos / -sin bases."""
    from .pipeline import _const  # the frontend's constants kept on the device

    if padding:
        signal = torch.nn.functional.pad(signal, (win_size // 2, win_size // 2))
    frames = frame_signal(signal, win_size, hop_size)
    frames = frames * _const(("window", win_fn, win_size),
                             lambda: get_window(win_fn, win_size), frames)
    re = torch.matmul(frames, _const(("dft_cos", win_size), lambda: dft_bases(win_size)[0],
                                     frames))
    im = torch.matmul(frames, _const(("dft_sin", win_size), lambda: dft_bases(win_size)[1],
                                     frames))
    return (re * re + im * im).transpose(-1, -2)


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power, min=F32_EPS))


def db_to_power(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, 0.1 * db)


def normalize_db(db: torch.Tensor, ref_db: float, top_db: float, clip: bool = True):
    out = (db - ref_db + top_db) / top_db
    return torch.clamp(out, 0.0, 1.0) if clip else out


def denormalize_db(norm_db, ref_db: float, top_db: float):
    return norm_db * top_db - top_db + ref_db


def mel_spectrogram(signal: torch.Tensor, sr: int, win_size: int, hop_size: int,
                    win_fn: str = "hamm", padding: bool = False, n_mels: int = 80,
                    fmin: float = 25.0, fmax: float = 7600.0, ref_db: float = 20.0,
                    top_db: float = 100.0, normalize: bool = False,
                    clip_normalized: bool = True, subtract_mean: bool = False,
                    preemph: float = 0.0) -> torch.Tensor:
    """(..., n_samples) → dB mel (..., n_mels, n_frames), the reference's."""
    from .pipeline import _const

    power = stft_power(preemphasis(signal, preemph), win_size, hop_size, win_fn, padding)
    key = ("mel", int(sr), int(win_size), int(n_mels), float(fmin), float(fmax))
    mel = power_to_db(torch.matmul(_const(key, lambda: mel_filters(*key[1:]), power), power))
    if normalize:
        mel = normalize_db(mel, ref_db, top_db, clip_normalized)
    if subtract_mean:
        mel = mel - mel.mean(dim=-1, keepdim=True)
    return mel


def spectrogram(signal: torch.Tensor, sr: int, win_size: int, hop_size: int,
                win_fn: str = "hamm", padding: bool = False, ref_db: float = 20.0,
                top_db: float = 100.0, normalize: bool = False, clip_normalized: bool = True,
                subtract_mean: bool = False, preemph: float = 0.0) -> torch.Tensor:
    """(..., n_samples) → dB linear spectrogram (..., n_freq, n_frames)."""
    lin = power_to_db(stft_power(preemphasis(signal, preemph), win_size, hop_size, win_fn,
                                 padding))
    if normalize:
        lin = normalize_db(lin, ref_db, top_db, clip_normalized)
    if subtract_mean:
        lin = lin - lin.mean(dim=-1, keepdim=True)
    return lin


@functools.lru_cache(maxsize=None)
def delta_matrix(n_frames: int, order: int, width: int = 9) -> np.ndarray:
    """(T, T) operator R with ``delta(feat) == feat @ R`` (librosa's delta:
    Savitzky-Golay, mode='interp', applied to the identity)."""
    from scipy.signal import savgol_filter

    eye = np.eye(n_frames, dtype=np.float64)
    resp = savgol_filter(eye, width, polyorder=order, deriv=order, axis=-1, mode="interp")
    return resp.astype(np.float32)


def delta(feat: torch.Tensor, order: int = 1, width: int = 9) -> torch.Tensor:
    """Delta along the last (time) axis of ``feat`` (..., F, T)."""
    from .pipeline import _const

    t = feat.shape[-1]
    return torch.matmul(feat, _const(("delta", t, order, width),
                                     lambda: delta_matrix(t, order, width), feat))


def add_deltas(feat: torch.Tensor) -> torch.Tensor:
    """(..., F, T) → (..., 3, F, T): [feat, Δ, Δ²] as channels."""
    return torch.stack([feat, delta(feat, 1), delta(feat, 2)], dim=-3)


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy ``resample_poly`` in float64),
    float32 out."""
    if orig_sr == target_sr:
        return np.asarray(signal, dtype=np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(np.asarray(signal, dtype=np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def _istft(spec: np.ndarray, win_size: int, hop_size: int, win_fn: str) -> np.ndarray:
    """Overlap-add inverse of the centered STFT (host-side numpy)."""
    window = get_window(win_fn, win_size).astype(np.float64)
    n_frames = spec.shape[1]
    out = np.zeros(win_size + hop_size * (n_frames - 1))
    wsum = np.zeros_like(out)
    frames = np.fft.irfft(spec, n=win_size, axis=0).T  # (frames, win)
    for i in range(n_frames):
        out[i * hop_size : i * hop_size + win_size] += frames[i] * window
        wsum[i * hop_size : i * hop_size + win_size] += window**2
    nz = wsum > 1e-10
    out[nz] /= wsum[nz]
    return out[win_size // 2 : -(win_size // 2)]


def griffin_lim(
    magnitude: np.ndarray,
    win_size: int,
    hop_size: int,
    win_fn: str = "hamm",
    n_iter: int = 50,
    seed: int = 0,
) -> np.ndarray:
    """Phase reconstruction from a magnitude spectrogram (freq, frames)."""
    rng = np.random.default_rng(seed)
    angles = np.exp(2j * np.pi * rng.random(magnitude.shape))
    mag = np.abs(magnitude).astype(np.float64)
    window = get_window(win_fn, win_size).astype(np.float64)
    for _ in range(n_iter):
        signal = _istft(mag * angles, win_size, hop_size, win_fn)
        padded = np.pad(signal, (win_size // 2, win_size // 2))
        nf = num_frames(len(padded), win_size, hop_size)
        idx = np.arange(nf)[:, None] * hop_size + np.arange(win_size)[None, :]
        rebuilt = np.fft.rfft(padded[idx] * window, axis=1).T
        rebuilt = rebuilt[:, : mag.shape[1]]
        angles = np.exp(1j * np.angle(rebuilt))
    return _istft(mag * angles, win_size, hop_size, win_fn).astype(np.float32)


def inv_spectrogram(
    spec, sr, win_size, hop_size, win_fn="hamm", ref_db=20, top_db=100,
    normalize=False, n_iter=50, preemph=0.0,
):
    """Normalized-dB power spectrogram → waveform."""
    db = np.asarray(spec, np.float64)
    if normalize:
        db = db * top_db - top_db + ref_db
    amp = np.sqrt(np.power(10.0, 0.1 * db))
    wav = griffin_lim(amp, win_size, hop_size, win_fn, n_iter)
    return deemphasis(wav, preemph)


def inv_mel_spectrogram(
    mel, sr, win_size, hop_size, win_fn="hamm", n_mels=80, fmin=25, fmax=7600,
    ref_db=20, top_db=100, normalize=False, n_iter=50, preemph=0.0,
):
    """Normalized-dB mel → waveform via pinv mel filters + Griffin-Lim."""
    db = np.asarray(mel, np.float64)
    if normalize:
        db = db * top_db - top_db + ref_db
    power = np.power(10.0, 0.1 * db)
    inv_filt = np.linalg.pinv(mel_filters(sr, win_size, n_mels, fmin, fmax))
    lin_power = np.maximum(inv_filt @ power, 1e-10)
    wav = griffin_lim(np.sqrt(lin_power), win_size, hop_size, win_fn, n_iter)
    return deemphasis(wav, preemph)


# phase-vocoder time stretch and pitch shift: librosa.effects.pitch_shift's
# algorithm (a phase-vocoder time stretch, then polyphase resampling back to
# the original duration), which the reference's ±2/±4-semitone source
# variants were made with
def phase_vocoder(spec: np.ndarray, rate: float, hop_size: int) -> np.ndarray:
    """Stretch a complex STFT (freq, frames) by ``rate`` (librosa semantics:
    rate > 1 speeds up / fewer frames). Magnitudes are linearly interpolated
    between columns; phases advance by the accumulated instantaneous
    frequency so sinusoid continuity is preserved."""
    n_bins, n_frames = spec.shape
    time_steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, np.pi * hop_size, n_bins)
    padded = np.pad(spec, ((0, 0), (0, 2)))
    out = np.zeros((n_bins, len(time_steps)), np.complex128)
    phase_acc = np.angle(spec[:, 0])
    for t, step in enumerate(time_steps):
        i = int(step)
        alpha = step - i
        c0, c1 = padded[:, i], padded[:, i + 1]
        mag = (1.0 - alpha) * np.abs(c0) + alpha * np.abs(c1)
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(c1) - np.angle(c0) - phi_advance
        dphase -= 2.0 * np.pi * np.round(dphase / (2.0 * np.pi))
        phase_acc = phase_acc + phi_advance + dphase
    return out


def time_stretch(signal: np.ndarray, rate: float, win_size: int = 1024,
                 hop_size: int = 256, win_fn: str = "hann") -> np.ndarray:
    """Stretch ``signal`` to duration len/rate at the same pitch."""
    assert rate > 0
    y = np.asarray(signal, np.float64)
    window = get_window(win_fn, win_size).astype(np.float64)
    padded = np.pad(y, (win_size // 2, win_size // 2), mode="reflect")
    nf = num_frames(len(padded), win_size, hop_size)
    idx = np.arange(nf)[:, None] * hop_size + np.arange(win_size)[None, :]
    spec = np.fft.rfft(padded[idx] * window, axis=1).T  # (freq, frames)
    out = _istft(phase_vocoder(spec, rate, hop_size), win_size, hop_size, win_fn)
    n_out = int(round(len(y) / rate))
    if len(out) < n_out:
        out = np.pad(out, (0, n_out - len(out)))
    return out[:n_out].astype(np.float32)


def pitch_shift(signal: np.ndarray, sr: int, n_steps: float,
                bins_per_octave: int = 12) -> np.ndarray:
    """Shift pitch by ``n_steps`` semitones, duration preserved
    (librosa.effects.pitch_shift algorithm: stretch by 2^(−n/12), then
    resample the stretched signal back to the original length)."""
    from fractions import Fraction

    from scipy.signal import resample_poly

    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    stretched = time_stretch(signal, rate)
    frac = Fraction(rate).limit_denominator(1000)
    out = resample_poly(stretched.astype(np.float64),
                        frac.numerator, frac.denominator)
    n = len(np.asarray(signal))
    if len(out) < n:
        out = np.pad(out, (0, n - len(out)))
    return out[:n].astype(np.float32)
