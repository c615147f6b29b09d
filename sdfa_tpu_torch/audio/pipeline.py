"""Clip-level frontend for the overlap serving path (counterpart of
``sdfa_tpu/audio/pipeline.py``): ``WindowSpec`` geometry (copied — it is
plain Python) and the mel + Δ + Δ² features on the clip's hop grid.

The DFT, mel and delta products are plain ``torch.matmul`` in float32
(the JAX package runs them at HIGHEST; the port disables TF32).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import dsp


class WindowSpec:
    """Static frontend geometry from a resolved hparams tree."""

    def __init__(self, hparams):
        feat_cfg = hparams.audio.feature
        mel_cfg = dict(hparams.audio[feat_cfg.name])
        sr = int(hparams.audio.sample_rate)
        for key in ("win_size", "hop_size"):
            if isinstance(mel_cfg[key], float):
                mel_cfg[key] = int(mel_cfg[key] * sr)
        self.sr = sr
        self.win_size = int(mel_cfg["win_size"])
        self.hop_size = int(mel_cfg["hop_size"])
        self.n_mels = int(mel_cfg["n_mels"])
        self.fmin = float(mel_cfg["fmin"])
        self.fmax = float(mel_cfg["fmax"])
        self.ref_db = float(mel_cfg["ref_db"])
        self.top_db = float(mel_cfg["top_db"])
        self.preemph = float(mel_cfg.get("preemphasis", 0.0) or 0.0)
        self.win_fn = mel_cfg.get("win_fn", "hamm")
        self.normalize = bool(mel_cfg.get("normalize", True))
        self.clip = bool(mel_cfg.get("clip_normalized", True))
        self.frames = int(feat_cfg.sliding_window_frames)
        self.fps = float(hparams.anime.fps)
        self.ts_delta = float(hparams.anime.feature.ts_delta)
        self.sliding = self.hop_size * (self.frames - 1) + self.win_size

    def window_geom(self, w: int) -> Tuple[int, int]:
        """(start_sample, ts_ms) of the w-th output window (w >= 0)."""
        m = math.floor((w - 1.0) * self.sr / self.fps)
        e = m + self.sliding // 2
        s = e - self.sliding
        ts = int(round((s + e) / 2 * 1000.0 / self.sr - self.ts_delta))
        return s, ts

    def n_windows(self, n_samples: int) -> int:
        """Window count for a clip length (closed form of the reference
        loop condition, adjusted with the exact float comparison)."""
        def ok(w):
            return (w - 1.0) * self.sr / self.fps + self.sliding \
                <= n_samples + 2 * self.sliding
        w = max(0, int((n_samples + self.sliding) * self.fps / self.sr) - 1)
        while not ok(w) and w > 0:
            w -= 1
        while ok(w):
            w += 1
        return w

    def window_starts(self, n_samples: int) -> Tuple[np.ndarray, list]:
        n = self.n_windows(n_samples)
        geo = [self.window_geom(w) for w in range(n)]
        return np.asarray([g[0] for g in geo], np.int32), [g[1] for g in geo]

    def frame_grid(self, n_samples: int, bucket: int = 0):
        """Clip-level hop-grid geometry: (frame_idx (W, frames) int32,
        ts_list, pad_left, pad_right, t_total). Window starts snap to the
        nearest hop multiple; ``bucket`` > 0 rounds t_total up to a bucket
        multiple by extending the zero right-pad; the right pad keeps every
        gathered frame 4 frames inside the Δ operator's interior."""
        if self.sliding % self.hop_size:
            raise ValueError("overlap path needs the window span to be a hop multiple")
        starts, ts_list = self.window_starts(n_samples)
        snapped = np.round(starts / self.hop_size).astype(np.int64) * self.hop_size
        pad = self.sliding
        f0 = (snapped + pad) // self.hop_size
        frame_idx = (f0[:, None] + np.arange(self.frames)[None, :]).astype(np.int32)
        need = int(frame_idx.max()) + 1
        n_min = self.win_size + self.hop_size * (need + 4 - 1)
        pad_right = max(pad, n_min - n_samples - pad)
        t_total = 1 + (n_samples + pad + pad_right - self.win_size) // self.hop_size
        if bucket and t_total % bucket:
            grow = bucket - t_total % bucket
            t_total += grow
            pad_right += grow * self.hop_size
        return frame_idx, ts_list, pad, pad_right, int(t_total)


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def mel_from_frames(frames: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """Framed signal (..., T, win) → normalized mel-dB (..., T, M)."""
    frames = frames * _const(dsp.get_window(spec.win_fn, spec.win_size), frames)
    cos_b, sin_b = dsp.dft_bases(spec.win_size)
    re = torch.matmul(frames, _const(cos_b, frames))
    im = torch.matmul(frames, _const(sin_b, frames))
    power = re * re + im * im
    filt = dsp.mel_filters(spec.sr, spec.win_size, spec.n_mels, spec.fmin, spec.fmax)
    mel = dsp.power_to_db(torch.matmul(power, _const(filt, power).T))
    if spec.normalize:
        mel = dsp.normalize_db(mel, spec.ref_db, spec.top_db, spec.clip)
    return mel


def clip_frame_features_padded(padded: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """Pre-padded signal (n + pad_left + pad_right,) → clip-level features
    (T_total, F, 3) = [mel, Δ, Δ²] on the hop grid."""
    if spec.preemph:
        padded = dsp.preemphasis(padded, spec.preemph)
    frames = dsp.frame_signal(padded, spec.win_size, spec.hop_size)
    feat = mel_from_frames(frames, spec).T  # (M, T)
    t = feat.shape[-1]
    d1 = torch.matmul(feat, _const(dsp.delta_matrix(t, 1), feat))
    d2 = torch.matmul(feat, _const(dsp.delta_matrix(t, 2), feat))
    return torch.stack([feat, d1, d2], dim=-1).transpose(0, 1)  # (T, M, 3)
