"""On-device training feature pipeline: mel + the §2.4 augmentations as
plain torch ops on the model's device (counterpart of
``sdfa_tpu/data/device_features.py``).

Every mel-space augmentation except the elementwise ones is linear along one
axis, so it is an operator applied by a matmul:

- time extension (±et frames) + the linear resize back → a (72, 64)
  operator per et, built by pushing identity columns through
  ``features_host.linear_resize``, the host path's own resize;
- freq extra/truncate rows (zero/reflect pad, low/high side, optional
  truncation) + resize → a (128, 128) operator per (ef, lower, trunc,
  pad_mode) variant, built by pushing identity rows through the same steps;
- multiplicative sine scale and row dropout → elementwise.

The pipeline: raw 5056-sample windows (the slice that covers the largest
time extension) → per-sample preemphasis → 72-frame mel (DFT matmuls) → the
freq and time operators gathered per sample → scale / dropout → Δ/Δ². The
host samples the knobs (same RNG order as the host path) and ships the raw
slice: 40 KB a window instead of 98 KB of features. The operator banks and
the frontend's constants are uploaded once per device and kept
(``audio/pipeline.py::_CONSTS``). The products are float32 matmuls; the
entry points switch TF32 off (``ops.full_float32``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio import dsp
from ..audio.pipeline import _const, _delta_const, mel_from_frames
from . import features_host

MAX_EX_TIME = 4   # random_mel_extra time range (config ±4)
MAX_EX_FEAT = 5   # random_mel_extra freq range (config ±5)
T_OUT = 64
T_EXT = T_OUT + 2 * MAX_EX_TIME  # 72 computed mel frames per raw window
PAD_MODES = ("constant", "reflect")


def raw_window_samples(win_size: int, hop_size: int, frames: int = T_OUT) -> int:
    """Raw slice length covering the maximum time extension."""
    return hop_size * (frames - 1) + win_size + 2 * MAX_EX_TIME * hop_size


# ---------------------------------------------------------------------------
# operator banks (host-built, cached)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def time_op_bank() -> np.ndarray:
    """(9, T_EXT, T_OUT): for et ∈ [−4..4], map the 72 computed frames to the
    64 output frames exactly as slice + resize does on the host."""
    bank = np.zeros((2 * MAX_EX_TIME + 1, T_EXT, T_OUT), np.float32)
    for k, et in enumerate(range(-MAX_EX_TIME, MAX_EX_TIME + 1)):
        t_aug = T_OUT + 2 * et
        lo = MAX_EX_TIME - et  # first used frame inside the 72
        # the resize acts on (rows=F, cols=T): resized[s, t] = weight of
        # input frame s in output frame t
        bank[k, lo: lo + t_aug, :] = features_host.linear_resize(
            np.eye(t_aug, dtype=np.float32), T_OUT, t_aug)
    return bank


@functools.lru_cache(maxsize=None)
def freq_op_bank(n_mels: int = 128) -> np.ndarray:
    """(n_variants, n_mels, n_mels) row operators for every
    (ef, lower, trunc, pad_mode) combination, built by pushing identity rows
    through the host pad/truncate/resize steps."""
    ops = []
    for ef in range(-MAX_EX_FEAT, MAX_EX_FEAT + 1):
        for lower in (False, True):
            for trunc in (False, True):
                for mode in PAD_MODES:
                    feat = np.eye(n_mels, dtype=np.float32)  # rows = mel bins
                    if ef < 0:
                        feat = feat[-ef:] if lower else feat[:ef]
                    elif ef > 0:
                        if lower:
                            feat = np.pad(feat, [(ef, 0), (0, 0)], "constant")
                            if trunc:
                                feat = feat[:-ef]
                        else:
                            feat = np.pad(feat, [(0, ef), (0, 0)], mode)
                            if trunc:
                                feat = feat[ef:]
                    if feat.shape[0] != n_mels:
                        feat = features_host.linear_resize(feat, n_mels, n_mels)
                    # feat[o, i] = weight of input row i in output row o
                    ops.append(feat)
    return np.stack(ops)


def freq_variant_index(ef: int, lower: bool, trunc: bool, pad_mode: str) -> int:
    return (((ef + MAX_EX_FEAT) * 2 + int(lower)) * 2 + int(trunc)) * 2 + int(
        pad_mode == "reflect"
    )


def freq_variant(f_idx: int):
    """The inverse of ``freq_variant_index``: (ef, lower, trunc, pad_mode)."""
    f_idx = int(f_idx)
    return (f_idx // 8 - MAX_EX_FEAT, bool(f_idx // 4 % 2), bool(f_idx // 2 % 2),
            PAD_MODES[f_idx % 2])


# ---------------------------------------------------------------------------
# the device pipeline
# ---------------------------------------------------------------------------
class FeatureSpec:
    """Static mel config of the featurizer (normalized and clipped, as the
    training windows always are)."""

    normalize = True
    clip = True

    def __init__(self, sr: int, win_size: int, hop_size: int, n_mels: int,
                 fmin: float, fmax: float, ref_db: float, top_db: float,
                 win_fn: str = "hamm"):
        self.sr, self.win_size, self.hop_size = sr, win_size, hop_size
        self.n_mels, self.fmin, self.fmax = n_mels, fmin, fmax
        self.ref_db, self.top_db, self.win_fn = ref_db, top_db, win_fn

    @classmethod
    def from_hparams(cls, hp) -> "FeatureSpec":
        mel = dict(hp.audio.mel)
        sr = int(hp.audio.sample_rate)
        for key in ("win_size", "hop_size"):
            if isinstance(mel[key], float):
                mel[key] = int(mel[key] * sr)
        return cls(sr=sr, win_size=int(mel["win_size"]), hop_size=int(mel["hop_size"]),
                   n_mels=int(mel["n_mels"]), fmin=mel["fmin"], fmax=mel["fmax"],
                   ref_db=mel["ref_db"], top_db=mel["top_db"],
                   win_fn=mel.get("win_fn", "hamm"))


def device_train_features(raw_wav, preemph, t_idx, f_idx, feat_scale, drop_rows, drop_is_max,
                          drop_thres, *, spec: FeatureSpec) -> torch.Tensor:
    """Raw windows and their knobs, all tensors on one device → (N, T_OUT,
    n_mels, 3) training features, in parity with the host path:
    raw_wav (N, R) fixed-length raw windows; preemph (N,) per-sample
    preemphasis; t_idx / f_idx (N,) indices into ``time_op_bank`` /
    ``freq_op_bank``; feat_scale (N, n_mels) multiplicative scale (1 = off);
    drop_rows (N, n_mels) 1 where a row is dropped; drop_is_max (N,) 1 for
    "max" mode, 0 for "zero" mode; drop_thres (N,) the "max" mode's
    threshold."""
    # per-sample preemphasis
    wav = torch.cat([raw_wav[:, :1], raw_wav[:, 1:] - preemph[:, None] * raw_wav[:, :-1]], dim=1)
    # reference parity: the host preemphasizes the et-window in isolation, so
    # its first sample keeps no context (misc.py:8-20). That sample sits at
    # (MAX_EX_TIME − et)·hop inside the raw slice: restore it per sample.
    t_idx = t_idx.long()
    start_pos = (2 * MAX_EX_TIME - t_idx) * spec.hop_size  # (MAX_EX_TIME − et)·hop
    first = torch.arange(raw_wav.shape[1], device=raw_wav.device)[None, :] == start_pos[:, None]
    wav = torch.where(first, raw_wav, wav)
    # 72-frame mel → (N, M, T_EXT)
    frames = wav.unfold(1, spec.win_size, spec.hop_size)[:, :T_EXT]
    mel = mel_from_frames(frames, spec).transpose(1, 2)

    # augmentation operators, gathered per sample
    f_ops = _const(("freq_op_bank", spec.n_mels), lambda: freq_op_bank(spec.n_mels), mel)
    t_ops = _const(("time_op_bank",), time_op_bank, mel)
    feat = torch.matmul(torch.matmul(f_ops[f_idx.long()], mel), t_ops[t_idx])  # (N, M, 64)

    # elementwise augmentations
    feat = feat * feat_scale[:, :, None]
    zero_mode = (1.0 - drop_is_max)[:, None, None]
    feat = feat * (1.0 - drop_rows[:, :, None] * zero_mode)  # zero-mode rows
    # "max" dropout mode is a silent no-op in the reference
    # (get_features.py:191-192 writes into a fancy-index copy), reproduced for
    # parity; drop_is_max / drop_thres stay in the batch so the knob remains
    # observable.
    del drop_thres

    # deltas + channel stack → (N, T, M, 3)
    d1 = torch.matmul(feat, _delta_const(T_OUT, 1, feat))
    d2 = torch.matmul(feat, _delta_const(T_OUT, 2, feat))
    return torch.stack([feat, d1, d2], dim=-1).transpose(1, 2)


def host_train_features(raw_wav: np.ndarray, preemph: float, t_idx: int, f_idx: int,
                        feat_scale: np.ndarray, drop_rows: np.ndarray, drop_is_max: float,
                        mel_cfg: dict, sr: int) -> np.ndarray:
    """The host path's features of one raw window and its knobs, the
    reference that ``device_train_features`` is held to → (T_OUT, n_mels, 3)."""
    ext = MAX_EX_TIME * int(mel_cfg["hop_size"])
    ef, lower, trunc, mode = freq_variant(f_idx)
    mask = np.flatnonzero(np.asarray(drop_rows) > 0)
    n_mels = int(mel_cfg["n_mels"])
    feat, _, _ = features_host.windowed_features(
        signal=np.asarray(raw_wav, np.float32), signal_stt=ext, signal_end=len(raw_wav) - ext,
        mel_cfg=dict(mel_cfg, preemphasis=float(preemph)), sr=sr, frames=T_OUT,
        feat_extra=(ef, int(t_idx) - MAX_EX_TIME),
        feat_scale=np.asarray(feat_scale, np.float32)[:, None],
        feat_dropout=len(mask) / n_mels if len(mask) else None,
        random_args=dict(trunck=trunc, pad_mode=mode, lower_freq=lower, mask_idx=mask,
                         drop_mode="max" if drop_is_max else "zero", mask_thres=0.5))
    return np.transpose(feat, (2, 1, 0))
