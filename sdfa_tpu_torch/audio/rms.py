"""RMS dB analysis and normalization (counterpart of ``sdfa_tpu/audio/rms.py``,
copied; reference: saber/data/audio/rms.py:45-78)."""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


def analyze_db(wav: np.ndarray, threshold=None):
    db = 20.0 * np.log10(np.maximum(np.abs(wav), 1e-10))
    max_db = db.max()
    if threshold is None:
        threshold = db.min()
    mask = db >= threshold
    if mask.sum() == 0:
        return None, None
    rms = np.sqrt(np.mean(wav[mask] ** 2))
    return 20.0 * np.log10(rms), max_db


def normalize(wav: np.ndarray, target_db: float = -20.0, threshold=None,
              rms_db=None, max_db=None) -> np.ndarray:
    if rms_db is not None:
        if max_db is None:
            raise ValueError("rms_db given without max_db")
    else:
        rms_db, max_db = analyze_db(wav, threshold=threshold)
    if rms_db is None:  # all silence
        return wav
    delta_db = target_db - rms_db
    if delta_db + max_db > 0:
        log.warning("[rms]: max db %.2f will > 0, signal will be clipped", max_db + delta_db)
    scale = np.power(10.0, delta_db / 20.0)
    return np.clip(wav * scale, -0.999, 0.999).astype(np.float32)
