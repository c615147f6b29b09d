"""Noise generators, mu-law companding and an energy VAD (counterpart of
``sdfa_tpu/audio/misc.py``, copied: numpy on the host).

White and Voss-McCartney pink noise, mu-law companding, and the speech
detection of the preprocessing: 20 ms frame decisions by energy (the
reference uses webrtcvad), run-length smoothing, expanded to samples, with
the reference's pair API.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


# -- noise -------------------------------------------------------------------
def white_noise(length: int, scale: float = 1.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    return rng.normal(0.0, scale, int(length)).astype(np.float32)


def pink_noise(nrows: int, scale: float = 1.0, ncols: int = 16,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Voss-McCartney pink noise (row-wise forward-fill of sparse updates)."""
    rng = rng or np.random.default_rng()
    array = np.full((nrows, ncols), np.nan)
    array[0, :] = rng.random(ncols)
    array[:, 0] = rng.random(nrows)
    cols = rng.geometric(0.5, nrows)
    cols[cols >= ncols] = 0
    rows = rng.integers(0, nrows, size=nrows)
    array[rows, cols] = rng.random(nrows)
    # forward-fill along axis 0 without pandas
    mask = np.isnan(array)
    idx = np.where(mask, 0, np.arange(nrows)[:, None])
    np.maximum.accumulate(idx, axis=0, out=idx)
    filled = array[idx, np.arange(ncols)[None, :]]
    filled = np.where(np.isnan(filled), 0.0, filled)
    return (filled.sum(axis=1) * scale).astype(np.float32)


# -- mu-law ------------------------------------------------------------------
def mulaw(y, nb_mu):
    mu = float(nb_mu)
    return np.sign(y) * np.log1p(np.abs(y) * mu) / np.log1p(mu)


def inv_mulaw(y, nb_mu):
    mu = float(nb_mu)
    return np.sign(y) * (1.0 / mu) * ((1.0 + mu) ** np.abs(y) - 1.0)


def mu_quantize(y, nb_mu):
    return ((np.asarray(y) + 1.0) * float(nb_mu) / 2.0).astype(np.int64)


def mu_normalize(y, nb_mu):
    return np.asarray(y, np.float32) * 2.0 / float(nb_mu) - 1.0


# -- VAD ----------------------------------------------------------------------
def detect_speech(
    signal: np.ndarray,
    sr: int,
    pad_mode: str = "constant",
    smooth_ms: Optional[float] = None,
    vad_mode: int = 3,
    energy_db_threshold: float = -40.0,
) -> np.ndarray:
    """Per-sample speech flags (uint8), the reference's contract: 20 ms
    frame decisions, run-length smoothing, then expanded back to sample
    resolution.

    Decision backend: an energy threshold instead of webrtcvad;
    ``vad_mode`` maps to the threshold (mode 3 ≈ −40 dB; each step down
    relaxes by 5 dB).
    """
    if not 0 <= vad_mode <= 3:
        raise ValueError(f"vad_mode must be 0..3, got {vad_mode}")
    threshold_db = energy_db_threshold - 5.0 * (3 - vad_mode)
    original_length = len(signal)
    win_len = int(0.02 * sr)
    hop_len = int(0.02 * sr)
    to_pad = (win_len - hop_len) // 2  # 0 for the reference geometry
    signal = np.pad(signal, (to_pad, to_pad), pad_mode)
    flags = []
    for left in range(0, max(len(signal) - win_len, 0), hop_len):
        frame = signal[left : left + win_len]
        rms = np.sqrt(np.mean(frame.astype(np.float64) ** 2) + 1e-12)
        flags.append(1 if 20.0 * np.log10(max(rms, 1e-10)) > threshold_db else 0)
    is_speech = np.asarray(flags, np.uint8)

    # smoothing: runs shorter than smooth_ms/2.5 frames take the previous
    # run's (smoothed) value, starting from 0
    if smooth_ms is not None and len(is_speech):
        threshold = smooth_ms / 2.5
        i, last = 0, 0
        out = []
        while i < len(is_speech):
            j = i
            while j < len(is_speech) and is_speech[j] == is_speech[i]:
                j += 1
            cur = is_speech[i]
            if j - i < threshold:
                cur = last
            last = cur
            out.extend([cur] * (j - i))
            i = j
        is_speech = np.asarray(out, np.uint8)

    # expand to sample resolution, padded to the original length
    ret = np.repeat(is_speech, hop_len)
    if original_length > len(ret):
        fill = ret[-1] if len(ret) else 0
        ret = np.pad(ret, (0, original_length - len(ret)), constant_values=fill)
    return ret[:original_length].astype(np.uint8)


def vad_to_pairs(is_speech: np.ndarray) -> List[Tuple[int, int]]:
    pairs = []
    i = 0
    while i < len(is_speech):
        if is_speech[i]:
            j = i
            while j < len(is_speech) and is_speech[j]:
                j += 1
            pairs.append((i, j))
            i = j
        else:
            i += 1
    return pairs


def vad_from_pairs(pairs, length: int) -> np.ndarray:
    out = np.zeros(length, np.uint8)
    for s, e in pairs:
        out[s:e] = 1
    return out
