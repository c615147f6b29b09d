"""Small numpy extensions (counterpart of ``sdfa_tpu/utils/npext.py``,
copied; reference: saber/utils/extension.py:5-15 — monkey-patched
np.first_nonzero/last_nonzero; here plain functions)."""

from __future__ import annotations

import numpy as np


def first_nonzero(arr: np.ndarray, axis: int = -1, invalid_val: int = -1) -> np.ndarray:
    mask = np.asarray(arr) != 0
    return np.where(mask.any(axis=axis), mask.argmax(axis=axis), invalid_val)


def last_nonzero(arr: np.ndarray, axis: int = -1, invalid_val: int = -1) -> np.ndarray:
    mask = np.asarray(arr) != 0
    flipped = np.flip(mask, axis=axis)
    idx = mask.shape[axis] - 1 - flipped.argmax(axis=axis)
    return np.where(mask.any(axis=axis), idx, invalid_val)
