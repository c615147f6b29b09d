"""Device frontend (counterpart of ``sdfa_tpu/audio/pipeline.py``):
``WindowSpec`` geometry (copied — it is plain Python), the mel + Δ + Δ²
features on a clip's hop grid (one clip or a batch of equal-length clips)
and the per-window features of the exact path.

The DFT, mel and delta products are plain ``torch.matmul`` in float32
(the JAX package runs them at HIGHEST; the port disables TF32). Their
constant operands (window, DFT bases, mel filters, Δ operators) are
uploaded once per device and kept in a small LRU, ``_CONSTS``.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Tuple

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


_CONSTS: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
_CONSTS_MAX = 16  # 4 frontend constants per spec + 2 Δ operators per frame-count bucket


def _const(key: tuple, build, like: torch.Tensor) -> torch.Tensor:
    """The host constant ``build()`` as a tensor of ``like``'s device and
    dtype, uploaded on first use and kept (least recently used out first)."""
    key = key + (like.device, like.dtype)
    hit = _CONSTS.get(key)
    if hit is None:
        with torch.inference_mode(False):  # a kept tensor must outlive the caller's mode
            hit = torch.from_numpy(build()).to(device=like.device, dtype=like.dtype)
        _CONSTS[key] = hit
        if len(_CONSTS) > _CONSTS_MAX:
            _CONSTS.popitem(last=False)
    else:
        _CONSTS.move_to_end(key)
    return hit


def clear_const_cache():
    _CONSTS.clear()


def _delta_const(n_frames: int, order: int, like: torch.Tensor) -> torch.Tensor:
    return _const(("delta", n_frames, order), lambda: dsp.delta_matrix(n_frames, order), like)


def mel_from_frames(frames: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """Framed signal (..., T, win) → normalized mel-dB (..., T, M)."""
    n = spec.win_size
    frames = frames * _const(("window", spec.win_fn, n),
                             lambda: dsp.get_window(spec.win_fn, n), frames)
    re = torch.matmul(frames, _const(("dft_cos", n), lambda: dsp.dft_bases(n)[0], frames))
    im = torch.matmul(frames, _const(("dft_sin", n), lambda: dsp.dft_bases(n)[1], frames))
    power = re * re + im * im
    mel_key = ("mel", spec.sr, n, spec.n_mels, spec.fmin, spec.fmax)
    filt = _const(mel_key, lambda: dsp.mel_filters(*mel_key[1:]), power)
    mel = dsp.power_to_db(torch.matmul(power, filt.T))
    if spec.normalize:
        mel = dsp.normalize_db(mel, spec.ref_db, spec.top_db, spec.clip)
    return mel


def _with_deltas(mel: torch.Tensor) -> torch.Tensor:
    """mel (..., T, M) → [mel, Δ, Δ²] (..., T, M, 3), deltas along T."""
    feat = mel.transpose(-1, -2)  # (..., M, T)
    t = feat.shape[-1]
    d1 = torch.matmul(feat, _delta_const(t, 1, feat))
    d2 = torch.matmul(feat, _delta_const(t, 2, feat))
    return torch.stack([feat, d1, d2], dim=-1).transpose(-3, -2)


def clip_frame_features_padded(padded: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """Pre-padded signal (n + pad_left + pad_right,) → clip-level features
    (T_total, F, 3) = [mel, Δ, Δ²] on the hop grid; a batch (B, S) of
    equal-length padded clips → (B, T_total, F, 3)."""
    if spec.preemph:
        padded = dsp.preemphasis(padded, spec.preemph)
    frames = dsp.frame_signal(padded, spec.win_size, spec.hop_size)
    return _with_deltas(mel_from_frames(frames, spec))


def clip_frame_features_device(signal: torch.Tensor, spec: WindowSpec, pad_left: int,
                               pad_right: int) -> torch.Tensor:
    """signal (..., S) → clip-level features (..., T_total, F, 3): zero-pads,
    then ``clip_frame_features_padded``."""
    return clip_frame_features_padded(
        torch.nn.functional.pad(signal, (pad_left, pad_right)), spec)


def _gather_windows(signal: torch.Tensor, starts: torch.Tensor, spec: WindowSpec) -> torch.Tensor:
    """signal (S,), starts (W,) → the zero-padded windows (W, sliding). The
    last windows of a clip start up to half a window before its padded end
    and read silence past it (the JAX gather clamps onto the pad's zeros)."""
    pad = spec.sliding
    padded = torch.nn.functional.pad(signal, (pad, 2 * pad))
    idx = (starts.long() + pad)[:, None] + torch.arange(pad, device=signal.device)[None, :]
    return padded[idx]


def window_features_device(signal: torch.Tensor, starts: torch.Tensor,
                           spec: WindowSpec) -> torch.Tensor:
    """The exact per-window frontend: signal (S,), starts (W,) → features
    (W, T, F, 3). Each window is preemphasized and framed on its own, and its
    deltas are fitted on its own 64 frames."""
    wav = _gather_windows(signal, starts, spec)
    if spec.preemph:
        wav = dsp.preemphasis(wav, spec.preemph)
    frames = dsp.frame_signal(wav, spec.win_size, spec.hop_size)  # sliding spans spec.frames
    return _with_deltas(mel_from_frames(frames, spec))


def fetch_audio_features_device(signal: np.ndarray, spec: WindowSpec, device) -> Dict:
    """Per-window features of a whole clip on ``device``: {"tslist",
    "audio_feat" (W, T, F, 3), "energy" (W, T)}."""
    starts, ts_list = spec.window_starts(len(signal))
    sig = torch.from_numpy(np.asarray(signal, np.float32)).to(device)
    starts = torch.from_numpy(starts).to(device)
    energy = dsp.rms_energy(_gather_windows(sig, starts, spec), spec.win_size, spec.hop_size)
    return dict(tslist=ts_list, audio_feat=window_features_device(sig, starts, spec),
                energy=energy)
