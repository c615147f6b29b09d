"""Host-side (numpy-only) feature extraction for the input pipeline
(counterpart of ``sdfa_tpu/data/features_host.py``, copied).

The dataloader must not touch the card (keeps workers cheap and the device
free), so the mel+Δ+Δ² window features and the train-time mel augmentations
live here, on the host constants of ``audio/dsp.py``. OpenCV's
``resize(..., INTER_LINEAR)``, which the JAX package calls to bring an
augmented spectrogram back to its size, is ``linear_resize`` here: the GPU
host has no OpenCV.

Semantics mirror the reference exactly:
- windowed_features: the reference's speech_anime/datasets/get_features.py:8-223
  (signal window slice + zero pad at edges, optional white noise, mel-axis
  extra/truncate rows, tremolo, linear resize back, multiplicative
  sine scale, additive noise, row dropout; [feat, Δ, Δ²] channel stack; the
  ``random_args`` dict lets the adjacent window reuse identical randomness)
- mel pipeline: saber/data/audio/features/spectrogram.py (torch.stft
  center=False power → slaney mel → dB → normalize).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..audio import dsp
from ..audio.misc import pink_noise


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a·b + c for float32 arrays with one rounding, as a fused multiply-add
    gives it. The product is exact in float64; the float64 sum can round only
    onto a float32 midpoint, where the sum's own rounding error (Knuth's
    two-sum) says which way the exact value lies."""
    p = a.astype(np.float64) * b
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    toward = np.where(s > r64, np.float32(np.inf), np.float32(-np.inf))
    other = np.nextafter(r, toward.astype(np.float32))
    tie = (s != r64) & (2 * s == r64 + other.astype(np.float64)) & (err != 0)
    wrong = tie & ((err > 0) != (other > r))
    return np.where(wrong, other, r).astype(np.float32)


def _resize_axis(n_in: int, n_out: int):
    """Source indices and weights of a linear resize along one axis, with
    OpenCV's conventions: half-pixel centres, src = (dst + 0.5)·in/out − 0.5
    in float64 and its fraction rounded to float32, edges clamped, no
    antialiasing when shrinking."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    frac[lo < 0] = 0
    lo[lo < 0] = 0
    frac[lo >= n_in - 1] = 0
    lo[lo >= n_in - 1] = n_in - 1
    return lo, np.minimum(lo + 1, n_in - 1), frac.astype(np.float32)


def linear_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)`` for a
    2-D float32 array: along the columns, then along the rows, each output
    s0 + (s1 − s0)·w in one fused rounding, as OpenCV computes it."""
    img = np.asarray(img, np.float32)
    x0, x1, wx = _resize_axis(img.shape[1], width)
    y0, y1, wy = _resize_axis(img.shape[0], height)
    cols = _fma32(img[:, x1] - img[:, x0], wx, img[:, x0])
    return _fma32(cols[y1] - cols[y0], wy[:, None], cols[y0])


def mel_window(
    signal: np.ndarray,
    sr: int,
    win_size: int,
    hop_size: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    ref_db: float,
    top_db: float,
    preemphasis: float = 0.0,
    win_fn: str = "hamm",
    normalize: bool = True,
    clip_normalized: bool = True,
    subtract_mean: bool = False,
    padding: bool = False,
) -> np.ndarray:
    """(n_samples,) → (n_mels, n_frames), float32, pure numpy."""
    sig = np.asarray(signal, np.float32)
    if preemphasis:
        sig = np.append(sig[:1], sig[1:] - preemphasis * sig[:-1]).astype(np.float32)
    if padding:
        sig = np.pad(sig, (win_size // 2, win_size // 2))
    nf = 1 + (len(sig) - win_size) // hop_size
    idx = np.arange(nf)[:, None] * hop_size + np.arange(win_size)[None, :]
    frames = sig[idx] * dsp.get_window(win_fn, win_size)
    cos_b, sin_b = dsp.dft_bases(win_size)
    re = frames @ cos_b
    im = frames @ sin_b
    power = (re * re + im * im).T  # (freq, frames)
    mel = dsp.mel_filters(sr, win_size, n_mels, fmin, fmax) @ power
    mel = 10.0 * np.log10(np.maximum(mel, dsp.F32_EPS))
    if normalize:
        mel = (mel - ref_db + top_db) / top_db
        if clip_normalized:
            mel = np.clip(mel, 0.0, 1.0)
    if subtract_mean:
        mel = mel - mel.mean(axis=-1, keepdims=True)
    return mel.astype(np.float32)


def deltas_stack(feat: np.ndarray) -> np.ndarray:
    """(F, T) → (3, F, T): [feat, Δ, Δ²] via the exact delta operators."""
    t = feat.shape[-1]
    d1 = feat @ dsp.delta_matrix(t, 1)
    d2 = feat @ dsp.delta_matrix(t, 2)
    return np.stack([feat, d1, d2], axis=0).astype(np.float32)


def rms_frames(signal: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    nf = 1 + (len(signal) - frame_length) // hop_length
    idx = np.arange(nf)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = signal[idx]
    return np.sqrt(np.mean(frames * frames, axis=-1)).astype(np.float32)


def slice_window(signal: np.ndarray, start: int, end: int) -> np.ndarray:
    """Zero-padded window slice (get_features.py:56-68)."""
    if end <= 0 or start >= len(signal):
        return np.zeros(end - start, np.float32)
    if 0 <= start and end <= len(signal):
        return np.array(signal[start:end], np.float32, copy=True)
    pad_lo = max(-start, 0)
    pad_hi = max(end - len(signal), 0)
    body = signal[max(start, 0) : min(end, len(signal))]
    return np.pad(body, (pad_lo, pad_hi)).astype(np.float32)


def windowed_features(
    signal: np.ndarray,
    signal_stt: int,
    signal_end: int,
    mel_cfg: dict,
    sr: int,
    frames: int,
    signal_noise: Optional[str] = None,
    feat_extra: Optional[Tuple[int, int]] = None,
    feat_scale: Optional[np.ndarray] = None,
    feat_noise: Optional[float] = None,
    feat_tremolo: Optional[float] = None,
    feat_dropout: Optional[float] = None,
    random_args: Optional[dict] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Window slice + augment + mel + deltas → ((3, F, T) feat, wav, random_args)."""
    rng = rng or np.random.default_rng()
    if random_args is None:
        random_args = {}
    hop_size = int(mel_cfg["hop_size"])

    ex_feat, ex_time = 0, 0
    if feat_extra is not None:
        ex_feat, ex_time = feat_extra
    wl = signal_stt - ex_time * hop_size
    wr = signal_end + ex_time * hop_size
    assert wl < wr, f"ex_time {ex_time} too large"
    wav = slice_window(signal, wl, wr)

    if isinstance(signal_noise, str):
        noise_type, noise_scale = signal_noise.split("@")
        if noise_type == "white":
            wav = wav + rng.normal(0, float(noise_scale), len(wav)).astype(np.float32)
        elif noise_type == "pink":
            wav = wav + pink_noise(len(wav), float(noise_scale), rng=rng)

    feat = mel_window(
        wav, sr=sr,
        win_size=int(mel_cfg["win_size"]), hop_size=hop_size,
        n_mels=int(mel_cfg["n_mels"]), fmin=mel_cfg["fmin"], fmax=mel_cfg["fmax"],
        ref_db=mel_cfg["ref_db"], top_db=mel_cfg["top_db"],
        preemphasis=mel_cfg.get("preemphasis", 0.0),
        win_fn=mel_cfg.get("win_fn", "hamm"),
        normalize=mel_cfg.get("normalize", True),
        clip_normalized=mel_cfg.get("clip_normalized", True),
        subtract_mean=mel_cfg.get("subtract_mean", False),
        padding=mel_cfg.get("padding", False),
    )
    n_mels = feat.shape[0]

    # --- extra/truncate mel rows (get_features.py:110-141) ---
    if feat_extra is not None:
        trunck = random_args.setdefault("trunck", bool(rng.uniform() < 0.5))
        pad_mode = random_args.setdefault("pad_mode", str(rng.choice(["reflect", "constant"])))
        lower = random_args.setdefault("lower_freq", bool(rng.uniform() < 0.5))
        if ex_feat < 0:
            feat = feat[-ex_feat:] if lower else feat[:ex_feat]
        elif ex_feat > 0:
            if lower:
                feat = np.pad(feat, [(ex_feat, 0), (0, 0)], "constant")
                if trunck:
                    feat = feat[:-ex_feat]
            else:
                feat = np.pad(feat, [(0, ex_feat), (0, 0)], pad_mode)
                if trunck:
                    feat = feat[ex_feat:]

    # --- tremolo column shifts (get_features.py:143-157) ---
    if feat_tremolo is not None and feat_tremolo > 0:
        t = feat.shape[1]
        shifting = np.abs(np.sin(np.linspace(0, 2 * np.pi, num=t) * feat_tremolo))
        shifting = (shifting * 3.0).astype(np.int32)
        cols = feat.T.copy()
        for c in range(t):
            pad = shifting[c]
            if pad > 0:
                cols[c] = np.pad(cols[c][:-pad], (pad, 0), "constant")
        feat = cols.T

    # --- resize back to (n_mels, frames), bilinear as OpenCV's INTER_LINEAR ---
    if feat.shape != (n_mels, frames):
        feat = linear_resize(feat, frames, n_mels)

    # --- scale / noise / dropout (get_features.py:166-192) ---
    if feat_scale is not None:
        feat = feat * feat_scale
    if feat_noise is not None and feat_noise > 0:
        feat = feat + rng.normal(0.0, feat_noise, size=feat.shape)
    if feat_dropout is not None and feat_dropout > 0:
        mask_len = max(1, int(feat_dropout * n_mels))
        mask_idx = random_args.get("mask_idx")
        if mask_idx is None:
            mask_idx = rng.choice(np.arange(n_mels), mask_len)
        drop_mode = random_args.setdefault("drop_mode", str(rng.choice(["zero", "max"])))
        mask_thres = random_args.setdefault("mask_thres", float(rng.uniform(0.3, 0.6)))
        random_args["mask_idx"] = mask_idx
        if drop_mode == "zero":
            feat[mask_idx] = 0
        # "max" mode: the reference's `feat[mask_idx][where] = mask_thres`
        # (get_features.py:191-192) assigns into a fancy-index COPY — a
        # silent no-op. Reproduced as a no-op for strict parity of the
        # training augmentation distribution (ADVICE r1; PARITY.md A24).

    stacked = deltas_stack(feat.astype(np.float32))
    return stacked, wav, random_args
