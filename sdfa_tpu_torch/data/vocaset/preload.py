"""VOCASET preprocessing pipeline (counterpart of
``sdfa_tpu/data/vocaset/preload.py``): clean → preload → dgrad → PCA.

The input is the public VOCASET download: ``root/audio/<alias>/sentenceNN.wav``,
``root/unposedcleaneddata/<alias>/sentenceNN/sentenceNN.FFFFFF.ply``,
``root/templates/<alias>.ply``, and the FLAME template the caller names
(with ``mask/non_face.py`` beside its directory, read as data). The output
tree, its files and CSVs are the JAX package's.

Stages:
1. clean: logMMSE denoise → manual trims → energy VAD → VAD-masked RMS
   normalize → cleaned wav + vad pairs (numpy on the host).
2. preload: the silence pad/trim bookkeeping (start_ts), the 60 fps ply
   frames as offsets from the speaker template (non-face vertices re-meaned),
   150 ms blend-to-neutral ramps outside the speech span, per-frame
   ``%06d.npy`` + ``_lips_dist.npy`` + the ``_audio.npz`` blob (with
   ``pitch_variants`` its 8 ``*_ps_*`` keys), the 8/2/2 speaker split's CSVs
   (numpy on the host).
3. generate_dgrad: Gaussian σ=1 temporal smoothing on the host, then the
   float64 deformation-gradient extraction on the device over a sentence's
   frames × triangles at once (``ops.dgrad.deformation_gradients_f64``),
   non-face triangles zeroed.
4. pca: PCA keeping 97% of the variance, fitted in float64 on the device
   (``fit_pca``; ``fit_pca_np`` is its numpy plain version): what
   ``sklearn.decomposition.PCA(n_components=0.97, svd_solver="full")``
   gives, without scikit-learn.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...audio import dsp
from ...audio import io as audio_io
from ...audio import misc as audio_misc
from ...mesh import io as mesh_io
from ...ops.dgrad import deformation_gradients_f64
from .. import csvio
from . import config as vc

log = logging.getLogger(__name__)

_FRAME_RE = re.compile(r"^sentence\d\d\.(\d{6})\.ply$")
# offset/dgrad frame files; may be negative-indexed ("-00001.npy") when a
# sentence's speech starts before the mesh capture
_NPY_FRAME_RE = re.compile(r"^-?\d+\.npy$")
FPS = 60.0

# Per-speaker manual audio trims (samples at the pipeline sample rate) for
# recordings whose head holds non-speech noise, the reference's table.
# Keyed by 0-based sentence id (sentenceNN.wav → id NN−1).
SPEAKER_TRIM_DICT = dict(
    m0={26: 8000, 31: 5900, 39: 5500},
    m1={3: 12000, 8: 8000, 17: 7800, 18: 10500, 24: 8000, 27: 10000,
        29: 10300, 30: 10500, 36: 12500, 37: 12800, 38: 13500},
    m2={18: 8000, 30: 7000, 36: 8200, 37: 10000, 38: 5000},
    m3={35: 4700, 36: 9500, 37: 3000},
    m4={25: 16000, 28: 10000, 29: 0, 30: 8000, 35: 12500, 36: 13000,
        37: 12500, 38: 14000},
    f0={17: 12000, 19: 10000, 35: 10000, 36: 9800, 38: 15000},
    f1={17: 8700, 18: 10000, 19: 11000, 24: 16410, 26: 15000, 28: 21500,
        38: 13500},
    f2={17: 10000, 19: 11000, 28: 12000, 35: 9900},
    f3={0: 11500, 9: 0, 20: 10500, 22: 8500, 35: 10000, 39: 8500},
    f4={6: 11000, 16: 12500, 17: 8500, 18: 7000, 19: 9000, 27: 5200,
        33: 7400, 35: 5400, 37: 8900, 38: 12500, 39: 8100},
)

# Leading spans that must be force-silenced at preload
MUST_SILENT_DICT = dict(
    m3={37: 3000},
)


# ---------------------------------------------------------------------------
# stage 1: clean
# ---------------------------------------------------------------------------
def clean_voca(root: str, clean_root: str, sample_rate: int = 8000,
               target_db: float = -24.5, speakers: Optional[List[str]] = None):
    """Stage 1: denoise → manual trim table → VAD → VAD-masked RMS
    normalize → wav + txt + vad pairs under ``clean_root/<speaker>/``.
    Sentence texts come from root/sentencestext/<alias>.txt when present."""
    speakers = speakers or list(vc.SPEAKER_ALIAS)
    err_list = []
    os.makedirs(clean_root, exist_ok=True)
    for spk in speakers:
        alias = vc.SPEAKER_ALIAS[spk]
        audio_dir = os.path.join(root, "audio", alias)
        if not os.path.isdir(audio_dir):
            log.warning("no audio for %s", alias)
            continue
        sentences: List[str] = []
        txt_path = os.path.join(root, "sentencestext", f"{alias}.txt")
        if os.path.exists(txt_path):
            with open(txt_path) as fp:
                sentences = [ln.strip() for ln in fp if ln.strip()]
        os.makedirs(os.path.join(clean_root, spk), exist_ok=True)
        for name in sorted(os.listdir(audio_dir)):
            m = re.match(r"sentence(\d\d)\.wav$", name)
            if not m:
                continue
            si = int(m.group(1))
            text = sentences[si - 1] if si - 1 < len(sentences) else ""
            prefix = os.path.join(clean_root, spk, f"{spk}_{si:03d}")
            if (os.path.exists(prefix + ".wav") and os.path.exists(prefix + ".txt")
                    and os.path.exists(prefix + ".vad")):
                continue
            signal, sr = audio_io.load(os.path.join(audio_dir, name), sr=sample_rate)
            denoised = denoise_logmmse(signal, sr)

            # manual trim (the sentence id is 0-based in the table)
            manual_trim = SPEAKER_TRIM_DICT.get(spk, {}).get(si - 1, 0)
            signal = signal[manual_trim:]
            denoised = denoised[manual_trim:]

            vad = audio_misc.detect_speech(denoised, sr, vad_mode=3)
            vad_signal = signal[vad > 0]
            if len(vad_signal) == 0:
                err_list.append(f"{spk}_{si:03d}")
                continue

            # VAD-masked RMS normalize with a clipping guard
            db = 20 * np.log10(np.sqrt(np.mean(vad_signal**2)) + 1e-10)
            max_db = 20 * np.log10(np.sqrt(np.max(vad_signal**2)) + 1e-10)
            delta_db = target_db - db
            if max_db + delta_db > 0:
                delta_db = -max_db
            signal = signal * np.power(10.0, delta_db / 20.0)

            audio_io.save(prefix + ".wav", signal.astype(np.float32), sr)
            with open(prefix + ".txt", "w") as fp:
                fp.write(f"{text}\n")
            with open(prefix + ".vad", "w") as fp:
                for lo, hi in audio_misc.vad_to_pairs(vad):
                    fp.write(f"{lo} {hi}\n")
    with open(os.path.join(clean_root, "err_list.txt"), "w") as fp:
        for err in err_list:
            fp.write(f"{err}\n")
    log.info("clean_voca done → %s", clean_root)


def denoise_logmmse(signal: np.ndarray, sr: int, frame_ms: float = 20.0) -> np.ndarray:
    """logMMSE spectral-amplitude denoiser (numpy, the JAX package's)."""
    slen = int(frame_ms * sr / 1000)
    if slen % 2:
        slen += 1
    if len(signal) < slen * 10:
        return signal
    hop = slen // 2
    win = np.hanning(slen + 1)[:-1]
    nfft = 2 * slen
    n_frames = (len(signal) - slen) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(slen)[None, :]
    frames = signal[idx] * win
    spec = np.fft.rfft(frames, nfft, axis=1)
    mag2 = np.abs(spec) ** 2
    # initial noise estimate from the first 6 frames
    noise_mu2 = mag2[:6].mean(axis=0)
    aa, mu, eta_min = 0.98, 0.98, 10 ** (-25 / 10)
    xk_prev = np.zeros_like(noise_mu2)
    out = np.zeros(len(signal) + nfft)
    from scipy.special import exp1

    for i in range(n_frames):
        gammak = np.minimum(mag2[i] / np.maximum(noise_mu2, 1e-12), 40.0)
        if i == 0:
            ksi = aa + (1 - aa) * np.maximum(gammak - 1, 0)
        else:
            ksi = aa * xk_prev / np.maximum(noise_mu2, 1e-12) + (1 - aa) * np.maximum(gammak - 1, 0)
            ksi = np.maximum(eta_min, ksi)
        log_sigma_k = gammak * ksi / (1 + ksi) - np.log(1 + ksi)
        vad_decision = log_sigma_k.mean()
        if vad_decision < 0.15:  # noise-only frame → update noise estimate
            noise_mu2 = mu * noise_mu2 + (1 - mu) * mag2[i]
        vk = ksi * gammak / (1 + ksi)
        ei_vk = 0.5 * exp1(np.maximum(vk, 1e-8))
        hw = ksi / (1 + ksi) * np.exp(ei_vk)
        xk_prev = (hw**2) * mag2[i]
        frame_out = np.fft.irfft(spec[i] * hw, nfft)[:slen]
        out[i * hop : i * hop + slen] += frame_out * win
    return out[: len(signal)].astype(np.float32)


# ---------------------------------------------------------------------------
# stage 2: preload
# ---------------------------------------------------------------------------
def preload_voca(
    voca_root: str,
    clean_root: str,
    output_root: str,
    template_path: str,
    sample_rate: int = 8000,
    speakers: Optional[List[str]] = None,
    blend_ms: float = 150.0,
    min_test_sentence: int = 20,
    pitch_variants: bool = False,
):
    """Stage 2: per sentence the offsets frames, the lips distances and the
    audio blob under ``output_root/data/<speaker>/neutral/<NNN>``, and the
    8/2/2 speaker split's CSVs. ``template_path``: the FLAME template (the
    lips distance is measured on it; its mask gives the non-face vertices)."""
    speakers = speakers or list(vc.SPEAKER_ALIAS)
    non_face_verts, _ = vc.non_face_masks(template_path)
    flame_verts, _ = mesh_io.read_ply(template_path, dtype=np.float64)
    rows_by_speaker: Dict[str, List[dict]] = {}

    for spk in speakers:
        alias = vc.SPEAKER_ALIAS[spk]
        spk_root = os.path.join(voca_root, "unposedcleaneddata", alias)
        template_path = os.path.join(voca_root, "templates", f"{alias}.ply")
        if not os.path.isdir(spk_root):
            log.warning("no mesh data for %s", alias)
            continue
        template, _faces = mesh_io.read_ply(template_path, dtype=np.float64)
        rows = []
        for name in sorted(os.listdir(spk_root)):
            m = re.match(r"sentence(\d\d)$", name)
            if not m:
                continue
            si = int(m.group(1))
            if spk == "m5" and si == 26:  # data error: missing frame 1
                continue
            row = _collect_sentence(
                spk, si,
                sent_dir=os.path.join(spk_root, name),
                clean_prefix=os.path.join(clean_root, spk, f"{spk}_{si:03d}"),
                # the reference's path convention: 0-based sentence id, zfill 3
                out_dir=os.path.join(output_root, "data", spk, "neutral", f"{si - 1:03d}"),
                template=template,
                non_face_verts=non_face_verts,
                flame_verts=flame_verts,
                sample_rate=sample_rate,
                blend_ms=blend_ms,
                pitch_variants=pitch_variants,
            )
            if row is not None:
                rows.append(row)
        rows_by_speaker[spk] = rows

    # 8/2/2 speaker split; valid/test keep only sentences ≥ min_test_sentence
    trainset, validset, testset = [], [], []
    for spk, rows in rows_by_speaker.items():
        if spk in vc.TRAIN_SPEAKERS:
            trainset += rows
        elif spk in vc.VALID_SPEAKERS:
            validset += [r for r in rows if _sent_of(r) >= min_test_sentence]
        else:
            testset += [r for r in rows if _sent_of(r) >= min_test_sentence]
    if trainset:
        csvio.write_csv(os.path.join(output_root, "train.csv"), trainset)
    if validset:
        csvio.write_csv(os.path.join(output_root, "valid.csv"), validset)
    if testset:
        csvio.write_csv(os.path.join(output_root, "test.csv"), testset)
    log.info("preload_voca done → %s", output_root)


def _sent_of(row) -> int:
    if "sentence_id:int" in row:
        return int(row["sentence_id:int"])
    base = os.path.basename(str(row["npy_data_path:path"]))
    return int(base[4:] if base.startswith("sent") else base)


def _interpolate(lower_p, upper_p, lower_v, upper_v, p):
    a = (p - lower_p) / (upper_p - lower_p)
    return lower_v * (1.0 - a) + upper_v * a


def _collect_sentence(
    spk: str, si: int, sent_dir: str, clean_prefix: str, out_dir: str,
    template: np.ndarray, non_face_verts: np.ndarray, flame_verts: np.ndarray,
    sample_rate: int, blend_ms: float, pitch_variants: bool = False,
):
    """One sentence: silence pad/trim with start_ts bookkeeping, the
    speech-span anime window with blend-to-neutral ramps in timestamp space,
    the extended (possibly negative) frame range, the signed lips distance
    against the FLAME template, and the 4-variant audio blob."""
    anime_ts_delta = 100.0
    anime_ends_extra = 50.0
    anime_smooth_threshold = float(blend_ms)

    # --- audio ---
    wav_path = clean_prefix + ".wav"
    if not os.path.exists(wav_path):
        log.warning("missing clean wav: %s", wav_path)
        return None
    sr = sample_rate
    signal, native_sr = audio_io.load(wav_path, sr=None)
    if native_sr != sr:
        signal = dsp.resample(signal, native_sr, sr)
    denoised = denoise_logmmse(signal, sr)

    # the must-silent table
    must_silent = MUST_SILENT_DICT.get(spk, {}).get(si - 1, 0)
    signal[:must_silent] = 0
    denoised[:must_silent] = 0

    # vad pairs from the clean stage (sample indices at the clean sr —
    # rescaled if preload runs at a different rate)
    vad_path = clean_prefix + ".vad"
    if os.path.exists(vad_path):
        pairs = []
        with open(vad_path) as fp:
            for line in fp:
                line = line.strip()
                if line:
                    x, y = line.split()
                    pairs.append((int(int(x) * sr / native_sr),
                                  int(int(y) * sr / native_sr)))
        vad = audio_misc.vad_from_pairs(pairs, len(signal))
    else:
        vad = audio_misc.detect_speech(denoised, sr, vad_mode=3)
    if not vad.any():
        log.warning("no speech in %s", wav_path)
        return None

    # pad back the manually trimmed head so anime frames stay aligned with
    # the original 60fps capture timeline
    manual_trim = SPEAKER_TRIM_DICT.get(spk, {}).get(si - 1, 0)
    if manual_trim > 0:
        vad = np.pad(vad, (manual_trim, 0))
        signal = np.pad(signal, (manual_trim, 0))
        denoised = np.pad(denoised, (manual_trim, 0))
    denoised[vad == 0] = 0

    # pad then trim so exactly 0.5 s of silence flanks the speech span
    silence = sr // 2
    stt_smp = int(np.argmax(vad > 0))
    end_smp = len(vad) - 1 - int(np.argmax(vad[::-1] > 0))
    pad = [0, 0]
    if silence > stt_smp:
        pad[0] = silence - stt_smp
    if silence > len(signal) - end_smp:
        pad[1] = silence - len(signal) + end_smp
    vad = np.pad(vad, pad)
    denoised = np.pad(denoised, pad)
    signal = np.pad(signal, pad)

    stt_smp = int(np.argmax(vad > 0))
    end_smp = len(vad) - 1 - int(np.argmax(vad[::-1] > 0))
    stt_smp = max(stt_smp - silence, 0)
    end_smp = min(end_smp + silence, len(signal))
    vad = vad[stt_smp:end_smp]
    denoised = denoised[stt_smp:end_smp]
    signal = signal[stt_smp:end_smp]

    # ms offset of the processed signal's start on the original timeline
    start_ts = float(stt_smp * 1000.0) / sr - float(pad[0] * 1000.0) / sr

    # anime speech span, snapped to 60 fps frames
    first_sp = float(np.argmax(vad > 0))
    last_sp = float(len(vad) - 1 - np.argmax(vad[::-1] > 0))
    anime_stt_ts = first_sp * 1000.0 / sr + start_ts - anime_ts_delta - anime_ends_extra
    anime_end_ts = last_sp * 1000.0 / sr + start_ts - anime_ts_delta + anime_ends_extra + 20
    anime_stt_fi = int(np.ceil(anime_stt_ts * FPS / 1000.0))
    anime_end_fi = int(np.floor(anime_end_ts * FPS / 1000.0))
    anime_stt_ts = anime_stt_fi * 1000.0 / FPS
    anime_end_ts = anime_end_fi * 1000.0 / FPS

    # --- anime frames ---
    frame_files = sorted(f for f in os.listdir(sent_dir) if _FRAME_RE.match(f))
    if not frame_files:
        return None
    os.makedirs(out_dir, exist_ok=True)

    spk_template = np.copy(template)
    verts_seq = []
    for fname in frame_files:
        verts, _ = mesh_io.read_ply(os.path.join(sent_dir, fname), dtype=np.float64)
        verts_seq.append(verts)
    verts_seq = np.asarray(verts_seq)
    # per-sentence template adjustment: non-face verts re-meaned
    if len(non_face_verts):
        spk_template[non_face_verts] = verts_seq[:, non_face_verts].mean(axis=0)
    verts_seq = verts_seq - spk_template

    anime_minfi = min(0, int(start_ts * FPS / 1000.0))
    anime_maxfi = max(len(verts_seq) - 1, int(len(signal) * FPS / sr))

    def _clip_idx(fi):
        return min(max(fi, 0), len(verts_seq) - 1)

    zeros = np.zeros_like(spk_template)
    th = anime_smooth_threshold
    for fi in range(anime_minfi, anime_maxfi + 1):
        ts = float(fi) * 1000.0 / FPS
        if anime_stt_ts <= ts <= anime_end_ts:
            to_save = verts_seq[_clip_idx(fi)]
        elif ts <= anime_stt_ts - th or ts >= anime_end_ts + th:
            to_save = zeros
        elif anime_stt_ts - th < ts < anime_stt_ts:
            to_save = _interpolate(anime_stt_ts - th, anime_stt_ts,
                                   zeros, verts_seq[_clip_idx(anime_stt_fi)], ts)
        else:  # anime_end_ts < ts < anime_end_ts + th
            to_save = _interpolate(anime_end_ts, anime_end_ts + th,
                                   verts_seq[_clip_idx(anime_end_fi)], zeros, ts)
        np.save(os.path.join(out_dir, f"{fi:06d}.npy"),
                to_save.astype(np.float32).reshape(-1))
        posed = flame_verts + to_save
        dist = np.float32(posed[vc.LIPS_UPPER_VERT, 1] - posed[vc.LIPS_LOWER_VERT, 1])
        np.save(os.path.join(out_dir, f"{fi:06d}_lips_dist.npy"), dist)

    # --- audio blob: 4 source variants ---
    # the reference resamples `signal` for audio_denoised_8k too (an upstream
    # fault); the denoised 8k is stored, so that train-time source
    # augmentation has 4 distinct variants
    resample, pitch_shift = dsp.resample, dsp.pitch_shift
    signal_8k = (signal.astype(np.float32) if sr == 8000
                 else resample(signal, sr, 8000))
    blob = dict(sr=sr, start_ts=start_ts,
                audio=signal.astype(np.float32),
                audio_denoised=denoised.astype(np.float32),
                audio_8k=signal_8k,
                audio_denoised_8k=(denoised.astype(np.float32) if sr == 8000
                                   else resample(denoised, sr, 8000)))
    if pitch_variants:
        # ±2/±4-semitone variants consumed by random_pitch_shift
        for suffix, steps in (("u4", 4), ("u2", 2), ("d2", -2), ("d4", -4)):
            blob[f"audio_ps_{suffix}"] = pitch_shift(blob["audio"], sr, steps)
            blob[f"audio_8k_ps_{suffix}"] = pitch_shift(signal_8k, 8000, steps)
    np.savez(out_dir + "_audio.npz", **blob)

    sent_txt = ""
    if os.path.exists(clean_prefix + ".txt"):
        with open(clean_prefix + ".txt") as fp:
            sent_txt = fp.readline().strip()

    return {
        "speaker:str": spk,
        "emotion:str": "neutral",
        "sentence_id:int": si - 1,  # 0-based, like the reference
        "start_ts:float": start_ts,
        "anime_minfi:int": anime_minfi,
        "anime_maxfi:int": anime_maxfi,
        "anime_mints:float": anime_minfi * 1000.0 / FPS,
        "anime_maxts:float": anime_maxfi * 1000.0 / FPS,
        "audio_samples:int": len(signal),
        "npy_data_path:path": out_dir,
        "sample_rate:int": sr,
        "sentence:str": sent_txt,
    }


# ---------------------------------------------------------------------------
# stage 3: dgrad
# ---------------------------------------------------------------------------
def generate_dgrad(offsets_root: str, dgrad_root: str, template_path: str,
                   voca_root: Optional[str] = None, smooth_sigma: float = 1.0,
                   device="cuda"):
    """Stage 3: the offsets tree → the dgrad tree. Per sentence the frames
    are smoothed in time on the host (scipy's ``gaussian_filter1d``), then
    extracted against the speaker's template (``voca_root/templates``, else
    the FLAME template) in float64 on ``device``, all the sentence's frames
    at once; non-face triangles are zeroed and each frame saved in float32.
    The lips distances and the audio blob are shared, the CSVs re-rooted."""
    from scipy.ndimage import gaussian_filter1d

    _, non_face_tris = vc.non_face_masks(template_path)
    _, faces = mesh_io.read_ply(template_path)
    faces_t = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    non_face_t = torch.as_tensor(np.asarray(non_face_tris, np.int64), device=device)

    data_root = os.path.join(offsets_root, "data")
    for spk in sorted(os.listdir(data_root)):
        alias = vc.SPEAKER_ALIAS.get(spk)
        spk_template = (os.path.join(voca_root, "templates", f"{alias}.ply")
                        if voca_root else template_path)
        if not os.path.exists(spk_template):
            spk_template = template_path
        template, _ = mesh_io.read_ply(spk_template, dtype=np.float64)
        template_t = torch.as_tensor(template, dtype=torch.float64, device=device)
        for emotion in sorted(os.listdir(os.path.join(data_root, spk))):
            for sent in sorted(os.listdir(os.path.join(data_root, spk, emotion))):
                src = os.path.join(data_root, spk, emotion, sent)
                if not os.path.isdir(src):
                    continue
                dst = os.path.join(dgrad_root, "data", spk, emotion, sent)
                os.makedirs(dst, exist_ok=True)
                # frames may be negative-numbered (-00001.npy): sort by number
                frame_files = sorted((f for f in os.listdir(src) if _NPY_FRAME_RE.match(f)),
                                     key=lambda f: int(os.path.splitext(f)[0]))
                frames = np.stack([np.load(os.path.join(src, f)) for f in frame_files])
                frames = gaussian_filter1d(frames, sigma=smooth_sigma, axis=0)
                offsets = torch.as_tensor(frames, device=device).to(torch.float64)
                deformed = template_t + offsets.reshape(len(frames), -1, 3)
                g = deformation_gradients_f64(template_t, deformed, faces_t)
                if len(non_face_tris):
                    g[:, non_face_t] = 0.0
                g = g.to(torch.float32).reshape(len(frames), -1).cpu().numpy()
                for f, row in zip(frame_files, g):
                    np.save(os.path.join(dst, f), row)
                for f in os.listdir(src):
                    if f.endswith("_lips_dist.npy"):
                        np.save(os.path.join(dst, f), np.load(os.path.join(src, f)))
                if os.path.exists(src + "_audio.npz") and not os.path.exists(dst + "_audio.npz"):
                    shutil.copyfile(src + "_audio.npz", dst + "_audio.npz")
    for name in ("train.csv", "valid.csv", "test.csv"):
        src_csv = os.path.join(offsets_root, name)
        if os.path.exists(src_csv):
            rows = csvio.read_csv(src_csv)
            for row in rows:
                row["npy_data_path:path"] = str(row["npy_data_path:path"]).replace(
                    os.path.abspath(offsets_root), os.path.abspath(dgrad_root))
            csvio.write_csv(os.path.join(dgrad_root, name), rows)
    log.info("generate_dgrad done → %s", dgrad_root)


# ---------------------------------------------------------------------------
# stage 4: PCA
# ---------------------------------------------------------------------------
# The fit's two routes. Up to this many bytes of centred float64 data the
# device takes the thin SVD of the centred data (its U as large again). Above,
# it accumulates the covariance XcᵀXc / (n - 1) in place in row chunks and
# takes its leading eigenpairs by block subspace iteration (``_top_eigh``).
# A full ``eigh`` is not used there: at the full dataset's 59856 scale
# columns (about 77k training frames, a centred copy of 37 GB) the covariance
# is 59856² float64 = 26.7 GiB, and syevd's eigenvectors plus its workspace
# (LAPACK's is 2f² more) would not fit beside it on one 80 GB card; the
# iteration keeps f x m blocks, a few hundred columns, beside the covariance.
# ``tools/pca_gram_probe.py`` runs that size on the card. Both routes give the
# same components: sklearn's sign rule reads the rows of Vt, which both have.
PCA_SVD_BYTES = 8 << 30
PCA_CHUNK_ELEMS = 1 << 27  # float64 elements of data on the device per chunk of rows
PCA_BLOCK = 256  # the iteration's first block of columns; doubled while the count needs it
PCA_RESIDUAL_TOL = 1e-11  # a kept pair's |G v - θ v| over the largest θ
PCA_MAX_ITERS = 2000


def _pca_count(var: np.ndarray, variance: float, total: Optional[float] = None) -> int:
    """sklearn's count for a fractional ``n_components``: explained variance
    ``var`` (descending) over ``total`` (by default its sum) → the first count
    whose cumulated ratio exceeds ``variance``
    (``searchsorted(..., side="right") + 1``)."""
    total = var.sum() if total is None else total
    return int(np.searchsorted(np.cumsum(var / total), variance, side="right") + 1)


def _sign_rule(comps: np.ndarray) -> np.ndarray:
    """sklearn's ``svd_flip(u_based_decision=False)``: the entry of largest
    magnitude of each row of Vt made positive."""
    pick = np.abs(comps).argmax(1)
    return comps * np.sign(comps[np.arange(len(comps)), pick])[:, None]


def _top_eigh(gram: torch.Tensor, variance: float, seed: int = 0):
    """The leading eigenpairs of the covariance ``gram`` (symmetric, PSD), as
    many as sklearn's count for ``variance`` of its trace needs → (count,
    eigenvectors (f, count), iterations). Block subspace iteration with a
    Rayleigh–Ritz step each round: the block doubles while the count exceeds
    half of it, and the kept pairs must reach residuals of
    ``PCA_RESIDUAL_TOL`` of the largest eigenvalue, or the fit raises."""
    f = gram.shape[0]
    total = float(torch.trace(gram))
    gen = torch.Generator(device=gram.device).manual_seed(seed)

    def block(m):
        return torch.randn(f, m, generator=gen, dtype=gram.dtype, device=gram.device)

    q = torch.linalg.qr(block(min(f, PCA_BLOCK))).Q
    k, res = 0, float("nan")
    for it in range(1, PCA_MAX_ITERS + 1):
        z = gram @ q
        theta, w = torch.linalg.eigh(q.T @ z)
        theta, w = theta.flip(0), w.flip(1)
        q, z = q @ w, z @ w  # the Ritz vectors and their images, largest first
        m = q.shape[1]
        k = _pca_count(theta.clamp(min=0).cpu().numpy(), variance, total)
        if 2 * k > m and m < f:
            q = torch.linalg.qr(torch.cat([z, block(min(f, 2 * m) - m)], 1)).Q
            continue
        k = min(k, m)
        res = float(torch.linalg.vector_norm(z[:, :k] - q[:, :k] * theta[:k], dim=0).max())
        if res <= PCA_RESIDUAL_TOL * float(theta[0]):
            log.info("pca: top %d of %d eigenpairs in %d iterations of a %d-column block",
                     k, f, it, m)
            return k, q[:, :k], it
        q = torch.linalg.qr(z).Q
    raise RuntimeError(f"PCA: the top {k} eigenpairs of a {f}² covariance did not converge "
                       f"in {PCA_MAX_ITERS} iterations (residual {res:.3g})")


def fit_pca(data: np.ndarray, variance: float = 0.97, device="cuda", route: Optional[str] = None):
    """PCA of the rows of ``data`` (n_samples, n_features) in float64 on
    ``device`` → (components (k, n_features), mean (n_features,)) float64
    numpy. ``route`` "svd" or "gram" overrides the choice by size."""
    n, f = data.shape
    if route is None:
        route = "svd" if n * f * 8 <= PCA_SVD_BYTES else "gram"
    rows = max(1, PCA_CHUNK_ELEMS // f)

    def chunks():
        for i in range(0, n, rows):
            yield torch.as_tensor(np.ascontiguousarray(data[i:i + rows]),
                                  device=device).to(torch.float64)

    mean = sum(c.sum(0) for c in chunks()) / n
    if route == "svd":
        xc = torch.as_tensor(data, device=device).to(torch.float64) - mean
        _, s, vt = torch.linalg.svd(xc, full_matrices=False)
        del xc
        vt = vt[:_pca_count((s * s / (n - 1)).cpu().numpy(), variance)]
    elif route == "gram":
        t0 = time.perf_counter()
        gram = torch.zeros(f, f, dtype=torch.float64, device=device)
        for c in chunks():
            c -= mean
            gram.addmm_(c.T, c)
        gram.div_(n - 1)
        if gram.is_cuda:
            torch.cuda.synchronize(gram.device)
        log.info("pca: the %d² covariance of %d rows in %.3f s", f, n, time.perf_counter() - t0)
        _, v, _ = _top_eigh(gram, variance)
        del gram
        vt = v.T
    else:
        raise ValueError(f"unknown PCA route {route!r}")
    return _sign_rule(vt.cpu().numpy()), mean.cpu().numpy()


def fit_pca_np(data: np.ndarray, variance: float = 0.97):
    """The numpy plain version of ``fit_pca``: the float64 thin SVD of the
    centred data with the same count and sign rule."""
    x = np.asarray(data, np.float64)
    mean = x.mean(0)
    _, s, vt = np.linalg.svd(x - mean, full_matrices=False)
    return _sign_rule(vt[:_pca_count(s * s / (len(x) - 1), variance)]), mean


def pca_offsets(offsets_root: str, variance: float = 0.97, step: int = 1, device="cuda"):
    frames = _load_training_frames(offsets_root, step)
    os.makedirs(os.path.join(offsets_root, "pca"), exist_ok=True)
    _pca_fit_save(frames, variance, os.path.join(offsets_root, "pca"), "", device)


def pca_dgrad(dgrad_root: str, variance: float = 0.97, step: int = 1, device="cuda"):
    frames = _load_training_frames(dgrad_root, step).reshape(-1, vc.N_TRIS, 9)
    out = os.path.join(dgrad_root, "pca")
    os.makedirs(out, exist_ok=True)
    _pca_fit_save(frames[:, :, :6].reshape(len(frames), -1), variance, out, "scale_", device)
    _pca_fit_save(frames[:, :, 6:].reshape(len(frames), -1), variance, out, "rotat_", device)


def _load_training_frames(root: str, step: int) -> np.ndarray:
    rows = csvio.read_csv(os.path.join(root, "train.csv"))
    frames = []
    for row in rows:
        d = str(row["npy_data_path:path"])
        files = sorted((f for f in os.listdir(d) if _NPY_FRAME_RE.match(f)),
                       key=lambda f: int(os.path.splitext(f)[0]))
        for f in files[::step]:
            frames.append(np.load(os.path.join(d, f)).reshape(-1))
    return np.stack(frames)


def _pca_fit_save(data: np.ndarray, variance: float, out_dir: str, prefix: str, device):
    comps, mean = fit_pca(data, variance, device)
    np.save(os.path.join(out_dir, f"{prefix}compT.npy"), comps.T.astype(np.float32))
    np.save(os.path.join(out_dir, f"{prefix}means.npy"), mean.astype(np.float32))
    log.info("pca '%s': %d components", prefix or "offsets", len(comps))


# ---------------------------------------------------------------------------
def run_pipeline(source_root: str, output_root: str, template_path: str,
                 face_type: str = "dgrad_3d", sample_rate: int = 8000,
                 target_db: float = -24.5, pitch_variants: bool = False, device="cuda"):
    """The whole pipeline → (the dataset root, seconds by stage).
    ``template_path``: the FLAME template, ``mask/non_face.py`` beside its
    directory. The dgrad extraction and the PCA fits run on ``device``."""
    if face_type not in ("dgrad_3d", "verts_off_3d"):
        raise ValueError(f"face_type must be dgrad_3d or verts_off_3d, got {face_type!r}")
    vc.non_face_masks(template_path)  # a missing mask fails before any stage runs
    clean_root = os.path.join(output_root, "_clean")
    offsets_root = os.path.join(output_root, "offsets")
    seconds: Dict[str, float] = {}

    def stage(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        log.info("stage %s: %.3f s", name, seconds[name])

    # clean and preload share the pipeline's sample rate
    stage("clean", clean_voca, source_root, clean_root, sample_rate=sample_rate,
          target_db=target_db)
    stage("preload", preload_voca, source_root, clean_root, offsets_root, template_path,
          sample_rate=sample_rate, pitch_variants=pitch_variants)
    stage("pca_offsets", pca_offsets, offsets_root, device=device)
    if face_type != "dgrad_3d":
        return offsets_root, seconds
    dgrad_root = os.path.join(output_root, "dgrad")
    stage("dgrad", generate_dgrad, offsets_root, dgrad_root, template_path,
          voca_root=source_root, device=device)
    stage("pca_dgrad", pca_dgrad, dgrad_root, device=device)
    return dgrad_root, seconds
