"""Synthetic VOCASET-like dataset generator (counterpart of
``sdfa_tpu/data/synthetic.py``, copied: the same seed writes the same arrays).

Produces the exact on-disk layout the preprocessing pipeline emits
(sliding_window.py docstring) with audio-correlated face motion, so the
trainer/evaluator/tests/bench run end-to-end without the real (licensed)
VOCASET download.  Shapes follow SURVEY.md §2.5: dgrad frames 89,784 floats,
offsets frames 15,069 floats, 60 fps, sr 8000.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from . import csvio

N_TRIS = 9976
N_VERTS = 5023


def _synth_audio(rng, n_samples: int, sr: int) -> np.ndarray:
    """Speech-like: pitch-modulated harmonics with syllabic energy envelope."""
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
    frames = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        seg = signal[i * hop : (i + 1) * hop]
        frames[i] = np.sqrt(np.mean(seg**2)) if len(seg) else 0.0
    if frames.max() > 0:
        frames = frames / frames.max()
    return frames


def generate(
    root: str,
    face_type: str = "dgrad_3d",
    speakers: Optional[List[str]] = None,
    sentences_per_speaker: int = 2,
    seconds_per_sentence: float = 2.0,
    sr: int = 8000,
    fps: int = 60,
    seed: int = 0,
    pca_dims=None,
) -> str:
    """Build the dataset under ``root``; returns root."""
    assert face_type in ("dgrad_3d", "verts_off_3d")
    rng = np.random.default_rng(seed)
    speakers = speakers or ["m0", "f0", "m1", "m2", "f1", "m3", "f2", "f3"]
    frame_dim = N_TRIS * 9 if face_type == "dgrad_3d" else N_VERTS * 3

    # low-rank motion basis so PCA is well-posed (like real face motion)
    n_basis = 24
    basis = rng.normal(0, 0.01, (n_basis, frame_dim)).astype(np.float32)
    mean_frame = rng.normal(0, 0.002, frame_dim).astype(np.float32)

    rows = []
    all_frames = []
    for spk in speakers:
        spk_gain = rng.uniform(0.5, 1.5, n_basis).astype(np.float32)
        for sent in range(1, sentences_per_speaker + 1):
            d = os.path.join(root, "data", spk, "neutral", f"sent{sent:03d}")
            os.makedirs(d, exist_ok=True)
            n_samples = int(seconds_per_sentence * sr)
            audio = _synth_audio(rng, n_samples, sr)
            n_frames = int(seconds_per_sentence * fps)
            env = _envelope_60fps(audio, sr, n_frames)
            np.savez(d + "_audio.npz", sr=sr, start_ts=0.0, audio=audio,
                     audio_8k=audio)
            for i in range(n_frames):
                # motion = envelope-driven low-rank pose + small smooth noise
                coeff = env[i] * spk_gain + 0.1 * np.sin(
                    np.arange(n_basis) * 0.7 + i * 0.21
                )
                frame = mean_frame + coeff.astype(np.float32) @ basis
                np.save(os.path.join(d, f"{i:06d}.npy"), frame.astype(np.float32))
                lips = np.float32(0.001 + 0.004 * env[i])
                np.save(os.path.join(d, f"{i:06d}_lips_dist.npy"), lips)
                all_frames.append(frame)
            rows.append({
                "npy_data_path:path": d,
                "speaker:str": spk,
                "emotion:str": "neutral",
                "sample_rate:int": sr,
                "audio_samples:int": n_samples,
                "start_ts:float": 0.0,
                "anime_minfi:int": 0,
                "anime_maxfi:int": n_frames - 1,
            })

    # manifests: all speakers train, first speaker also valid (synthetic)
    csvio.write_csv(os.path.join(root, "train.csv"), rows)
    csvio.write_csv(os.path.join(root, "valid.csv"), rows[:sentences_per_speaker])
    csvio.write_csv(os.path.join(root, "test.csv"), rows[:1])

    # PCA matrices matching the shipped configs' coefficient counts
    frames_arr = np.stack(all_frames)
    os.makedirs(os.path.join(root, "pca"), exist_ok=True)
    if face_type == "dgrad_3d":
        dims = pca_dims or (85, 180)
        _fit_pca(frames_arr.reshape(len(frames_arr), N_TRIS, 9)[:, :, :6].reshape(len(frames_arr), -1),
                 dims[0], os.path.join(root, "pca"), "scale_")
        _fit_pca(frames_arr.reshape(len(frames_arr), N_TRIS, 9)[:, :, 6:].reshape(len(frames_arr), -1),
                 dims[1], os.path.join(root, "pca"), "rotat_")
    else:
        dims = pca_dims or (59,)
        _fit_pca(frames_arr, dims[0], os.path.join(root, "pca"), "")
    return root


def _fit_pca(data: np.ndarray, n_components: int, out_dir: str, prefix: str):
    """PCA via randomized SVD; zero-pads components when data rank < n
    (synthetic data is intentionally low-rank)."""
    means = data.mean(axis=0)
    centered = data - means
    k = min(n_components, min(centered.shape) - 1)
    u, s, vt = np.linalg.svd(centered, full_matrices=False)
    comp = vt[:k]
    if k < n_components:
        pad = np.zeros((n_components - k, data.shape[1]), comp.dtype)
        comp = np.concatenate([comp, pad], axis=0)
    np.save(os.path.join(out_dir, f"{prefix}compT.npy"), comp.T.astype(np.float32))
    np.save(os.path.join(out_dir, f"{prefix}means.npy"), means.astype(np.float32))
