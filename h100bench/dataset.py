"""A synthetic VOCASET-layout training corpus for the training cells.

A frozen copy of ``sdfa_tpu_torch/data/synthetic.py::generate`` at commit
cd76b759f00e984f3c2c328d391715c072553d14 (speech-like audio, audio-driven
low-rank face motion, the manifests), with three changes: each sentence's
frames are written as the one consolidated file the reader builds from the
per-frame files itself (``<sentence>_frames.npy`` and ``_lips.npy``), so that
the corpus is written once and read as the reader reads it; the PCA bases are
drawn N(0, 0.01) at the shipped sizes instead of fitted (the model's bases and
the targets' projection are the same files); and the corpus is kept in a
fixed directory of the checkout, named by its parameters, so that only a
checkout's first run writes it.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os

import numpy as np

N_TRIS = 9976
N_VERTS = 5023
SPEAKERS = ["m0", "f0", "m1", "m2", "f1", "m3", "f2", "f3"]


def _synth_audio(rng, n_samples: int, sr: int) -> np.ndarray:
    """Speech-like: pitch-modulated harmonics with a syllabic envelope."""
    t = np.arange(n_samples) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.3 * t)
    phase = np.cumsum(2 * np.pi * f0 / sr)
    voiced = sum(np.sin(k * phase) / k for k in range(1, 6))
    envelope = np.clip(np.sin(2 * np.pi * 3.1 * t) + 0.3, 0, None)
    noise = rng.normal(0, 0.05, n_samples)
    sig = (voiced * envelope * 0.2 + noise * 0.2).astype(np.float32)
    return np.clip(sig, -0.99, 0.99)


def _envelope_60fps(signal: np.ndarray, sr: int, n_frames: int) -> np.ndarray:
    hop = sr // 60
    frames = np.array([np.sqrt(np.mean(signal[i * hop:(i + 1) * hop] ** 2))
                       for i in range(n_frames)], np.float32)
    return frames / frames.max() if frames.max() > 0 else frames


def _write_csv(path: str, rows):
    root = os.path.dirname(path)
    with open(path, "w", newline="") as fp:
        w = csv.writer(fp)
        w.writerow(list(rows[0]))
        for row in rows:
            w.writerow([os.path.relpath(v, root) if k.endswith(":path") else v
                        for k, v in row.items()])


def corpus(parent: str, face_type: str, sentences: int, seconds: float, seed: int = 0,
           sr: int = 8000, fps: int = 60) -> str:
    """The corpus's root under ``parent``, written there unless it is."""
    key = json.dumps([face_type, sentences, seconds, seed, sr, fps])
    root = os.path.join(parent, "voca-" + hashlib.sha256(key.encode()).hexdigest()[:12])
    if os.path.exists(os.path.join(root, "DONE")):
        return root
    rng = np.random.default_rng(seed)
    frame_dim = N_TRIS * 9 if face_type == "dgrad_3d" else N_VERTS * 3
    n_basis = 24
    basis = rng.normal(0, 0.01, (n_basis, frame_dim)).astype(np.float32)
    mean_frame = rng.normal(0, 0.002, frame_dim).astype(np.float32)
    rows = []
    for spk in SPEAKERS:
        spk_gain = rng.uniform(0.5, 1.5, n_basis).astype(np.float32)
        for sent in range(1, sentences + 1):
            d = os.path.join(root, "data", spk, "neutral", f"sent{sent:03d}")
            os.makedirs(os.path.dirname(d), exist_ok=True)
            n_samples, n_frames = int(seconds * sr), int(seconds * fps)
            audio = _synth_audio(rng, n_samples, sr)
            env = _envelope_60fps(audio, sr, n_frames)
            np.savez(d + "_audio.npz", sr=sr, start_ts=0.0, audio=audio, audio_8k=audio)
            i = np.arange(n_frames)[:, None]
            coeff = env[:, None] * spk_gain + 0.1 * np.sin(np.arange(n_basis) * 0.7 + i * 0.21)
            frames = (mean_frame + coeff.astype(np.float32) @ basis).astype(np.float32)
            np.save(d + "_frames.npy", frames)
            np.save(d + "_lips.npy", (0.001 + 0.004 * env).astype(np.float32))
            rows.append({"npy_data_path:path": d, "speaker:str": spk, "emotion:str": "neutral",
                         "sample_rate:int": sr, "audio_samples:int": n_samples,
                         "start_ts:float": 0.0, "anime_minfi:int": 0,
                         "anime_maxfi:int": n_frames - 1})
    _write_csv(os.path.join(root, "train.csv"), rows)
    _write_csv(os.path.join(root, "valid.csv"), rows[:sentences])
    pca = os.path.join(root, "pca")
    os.makedirs(pca, exist_ok=True)
    prng = np.random.default_rng([seed, 1])
    parts = ({"scale_": (6 * N_TRIS, 85), "rotat_": (3 * N_TRIS, 180)}
             if face_type == "dgrad_3d" else {"": (3 * N_VERTS, 59)})
    for prefix, (dim, k) in parts.items():
        np.save(os.path.join(pca, prefix + "compT.npy"),
                prng.normal(0, 0.01, (dim, k)).astype(np.float32))
        np.save(os.path.join(pca, prefix + "means.npy"),
                prng.normal(0, 0.01, (dim,)).astype(np.float32))
    # on the disk before the first window opens, not written back during it
    for dirpath, _, files in os.walk(root):
        for f in files:
            fd = os.open(os.path.join(dirpath, f), os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
    open(os.path.join(root, "DONE"), "w").close()
    return root
