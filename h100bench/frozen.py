"""Frozen copies of the program's inputs-side helpers, so that a later change to
the program cannot move the yardstick.

- ``synthetic_template``: ``sdfa_tpu_torch/mesh/io.py::synthetic_template`` at
  commit cd76b759f00e984f3c2c328d391715c072553d14.
- ``formant_utterance``: ``tools/stream_capacity_torch.py::_formant_utterance``
  at the same commit, with its generator taken from the caller (the tool seeds
  it with 7) and its length not capped at 3 s.
- ``rms_normalize``: ``sdfa_tpu_torch/audio/rms.py::normalize`` (threshold and
  levels left at their defaults), same commit.
"""

from __future__ import annotations

import numpy as np

FLAME_COUNTS = (5023, 9976, 1261)  # vertices, triangles, free vertices


def synthetic_template(seed: int = 0, n_major: int = 58, n_minor: int = 86,
                       n_extra: int = 35, n_free: int = 1261):
    """A torus mesh with FLAME's counts: (verts (V, 3) f64, faces (F, 3) int64,
    cnst_ids (V - n_free,) int64). Every grid vertex past the first ``n_free``
    and every unreferenced vertex is constrained."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    u = 2 * np.pi * i.ravel() / n_major
    v = 2 * np.pi * j.ravel() / n_minor
    big, small = 0.09, 0.04  # metres, head-sized
    grid = np.stack([(big + small * np.cos(v)) * np.cos(u),
                     (big + small * np.cos(v)) * np.sin(u),
                     small * np.sin(v)], axis=1)
    grid += rng.normal(0.0, 2e-4, grid.shape)
    extra = rng.uniform(-0.1, 0.1, (n_extra, 3))
    verts = np.concatenate([grid, extra])
    faces = []
    for a in range(n_major):
        for b in range(n_minor):
            v00 = a * n_minor + b
            v01 = a * n_minor + (b + 1) % n_minor
            v10 = ((a + 1) % n_major) * n_minor + b
            v11 = ((a + 1) % n_major) * n_minor + (b + 1) % n_minor
            faces.append((v00, v10, v01))
            faces.append((v01, v10, v11))
    faces = np.asarray(faces, np.int64)
    cnst_ids = np.arange(n_free, len(verts), dtype=np.int64)
    if (n_major, n_minor, n_extra, n_free) == (58, 86, 35, 1261):
        assert (len(verts), len(faces), len(verts) - len(cnst_ids)) == FLAME_COUNTS
    return verts, faces, cnst_ids


def formant_utterance(rng: np.random.Generator, sr: int, seconds: float) -> np.ndarray:
    """Formant-synthesized speech: a glottal-like pulse train with an f0
    declination through cascaded second-order formant resonators, syllabic
    envelopes, leading and trailing silence."""
    from scipy import signal as sps

    n = int(seconds * sr)
    out = np.zeros(n, np.float64)
    vowels = [(730, 1090, 2440), (270, 2290, 3010), (300, 870, 2240), (660, 1720, 2410)]
    syl, gap, pos, k = 0.22, 0.08, 0.35, 0
    while pos + syl < seconds - 0.3:
        seg_n = int(syl * sr)
        tt = np.arange(seg_n) / sr
        f0 = 150.0 - 25.0 * (pos / seconds) + 8.0 * np.sin(2 * np.pi * 2.0 * tt)
        phase = np.cumsum(2 * np.pi * f0 / sr)
        src = np.power(np.clip(np.sin(phase), 0, None), 3.0) - 0.1
        src = src + rng.normal(0, 0.03, seg_n)
        y = src
        for f, bw in zip(vowels[k % len(vowels)], (90.0, 110.0, 160.0)):
            if f >= sr / 2:
                continue
            r = np.exp(-np.pi * bw / sr)
            y = sps.lfilter([1.0 - r], [1.0, -2.0 * r * np.cos(2 * np.pi * f / sr), r * r], y)
        env = np.clip(np.minimum(tt / 0.03, 1.0), 0, 1) * np.clip(
            np.minimum((syl - tt) / 0.05, 1.0), 0, 1)
        i0 = int(pos * sr)
        out[i0:i0 + seg_n] += y * env
        pos += syl + gap
        k += 1
    out = out / (np.abs(out).max() + 1e-9) * 0.7
    out += rng.normal(0, 1e-4, n)  # noise floor so log-mel stays finite
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def rms_normalize(wav: np.ndarray, target_db: float) -> np.ndarray:
    rms_db = 20.0 * np.log10(np.sqrt(np.mean(wav ** 2)))
    scale = np.power(10.0, (target_db - rms_db) / 20.0)
    return np.clip(wav * scale, -0.999, 0.999).astype(np.float32)
