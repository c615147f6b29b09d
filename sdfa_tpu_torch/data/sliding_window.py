"""Sliding-window training dataset with adjacent-frame pairing (counterpart
of ``sdfa_tpu/data/sliding_window.py``, copied: from one root and seed both
readers draw the same random numbers in the same order and give the same
batches, bit for bit).

Reference: speech_anime/datasets/sliding_window.py:19-463.
- window geometry: sliding_size = hop·(frames−1)+win (0.568 s); one window
  per 1/60 s with ±sr/3 extra margin
- item i returns windows i and i+1 of the same sentence (motion loss);
  collate doubles the batch: first half = frame i, second half = frame i+1
- anime target = bilinear interp of two 60 fps npy frames at
  window-center-ts − ts_delta, lip-distance weight exp((0.002−d)·50)·2
- train-time augmentations of SURVEY.md §2.4; the adjacent window reuses
  identical ``random_args``.

Storage layout (our .npz variant of the reference pickle blob):
``<npy_data_path>/%06d.npy`` offset/dgrad frames, ``%06d_lips_dist.npy``,
and ``<npy_data_path>_audio.npz`` with keys sr/start_ts/audio[/variants].
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import ConfigDict
from . import device_features as dfeat
from . import features_host
from .speech_anime import SpeechAnimeDataset

_SOURCE_KEYS = ("audio", "audio_denoised", "audio_8k", "audio_denoised_8k")


def _save_whole(path: str, arr: np.ndarray):
    """np.save through a private temporary file and an atomic rename: prefetch
    workers that build the same cache file at once never read one half written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fp:
        np.save(fp, arr)
    os.replace(tmp, path)


class DatasetSlidingWindow(SpeechAnimeDataset):
    def __init__(self, hparams: ConfigDict, training: bool):
        super().__init__(hparams, training)
        feat_cfg = hparams.audio.feature
        self._feat_name = feat_cfg.name
        mel_cfg = dict(hparams.audio[self._feat_name])
        sr = int(hparams.audio.sample_rate)
        # float seconds → samples
        for key in ("win_size", "hop_size"):
            if isinstance(mel_cfg[key], float):
                mel_cfg[key] = int(mel_cfg[key] * sr)
        self._mel_cfg = mel_cfg
        self._sr = sr
        self._frames = int(feat_cfg.sliding_window_frames)
        self._sliding_size = mel_cfg["hop_size"] * (self._frames - 1) + mel_cfg["win_size"]
        self._fps = float(hparams.anime.fps)
        # trainer.compact_targets: ship anime targets to the device as f16
        # (halves the dominant host→device payload; the loss casts back to
        # f32 — see DESIGN.md §9 "target-payload compression")
        tr_cfg = hparams.get("trainer") or {}
        self._compact_targets = bool(tr_cfg.get("compact_targets", False))
        # trainer.pca_targets: ship 85+180-dim PCA coefficients instead of
        # 89,784-float dgrad frames (~350× smaller step upload); the loss
        # decodes on device with the model's own PCA constants. Projection
        # is affine, so the bilinear frame interpolation commutes with it —
        # coefficients are projected once per sentence and cached.
        self._pca_targets = bool(tr_cfg.get("pca_targets", False))
        self._pca_mats = None
        if self._pca_targets:
            out_cfg = hparams.model.output
            assert bool(out_cfg.get("using_pca", False)), (
                "trainer.pca_targets requires model.output.using_pca")
            assert not bool(out_cfg.get("pca_trainable", False)), (
                "trainer.pca_targets needs frozen PCA constants — with "
                "pca_trainable the decoded target would chase the weights")
            if hparams.model.face_data_type == "dgrad_3d":
                self._pca_mats = tuple(
                    (np.load(c).astype(np.float32), np.load(m).astype(np.float32))
                    for c, m in (out_cfg.pca_scale, out_cfg.pca_rotat)
                )
            else:
                self._pca_mats = (
                    (np.load(out_cfg.pca[0]).astype(np.float32),
                     np.load(out_cfg.pca[1]).astype(np.float32)),
                )
        self._face_type = hparams.model.face_data_type
        self._ts_delta = float(hparams.anime.feature.ts_delta)
        # pitch-shift source augmentation (sliding_window.py:140-147): the
        # ±2/±4-semitone blob variants are generated by
        # preload_voca(pitch_variants=True). reverb/time-stretch stay
        # rejected: the reference never generates `audio_reverb` ANYWHERE
        # (not even in the commented-out preload.py:702-730), so enabling
        # the flag upstream would KeyError too — see PARITY.md.
        self._pitch_aug = bool(training and feat_cfg.get("random_pitch_shift"))
        if training:
            for opt in ("random_reverb", "random_time_stretch"):
                if feat_cfg.get(opt):
                    raise NotImplementedError(
                        f"audio.feature.{opt} is not supported: the reference "
                        "never generates this source variant "
                        "(preload.py:702-730)")
        # TB audio-clip plugin (reference logger.py:95-103 ships
        # batch["signal"]): only materialized when plotting is on — the
        # extra ~17 kB/item is pure overhead otherwise
        self._log_signals = bool(tr_cfg.get("plot_gap_steps"))
        self._time_shifting = 0.5 / self._fps
        self._rng = np.random.default_rng(hparams.get("seed", 1234) + int(training))
        self._audio_cache: Dict[str, dict] = {}
        self._frame_stores: Dict[str, tuple] = {}

        # window coordinates (sliding_window.py:44-61)
        self.coordinates: List[dict] = []
        extra = sr // 3
        delta_samples = float(sr) / self._fps
        for i, info in enumerate(self.info_list):
            stt = 0 - extra
            end = int(info["audio_samples:int"]) + extra
            left = float(stt)
            while left + self._sliding_size <= end:
                s = math.ceil(left)
                self.coordinates.append(dict(data_id=i, range=(s, s + self._sliding_size)))
                left += delta_samples

    def __len__(self):
        return len(self.coordinates)

    # ------------------------------------------------------------------
    def _load_audio_blob(self, data_path: str) -> dict:
        if data_path not in self._audio_cache:
            blob = dict(np.load(data_path + "_audio.npz"))
            self._audio_cache[data_path] = blob
        return self._audio_cache[data_path]

    def _choose_source(self, blob: dict, sr: int, require_sr: Optional[int] = None):
        """Training-time source-signal selection (reference
        sliding_window.py:131-147): uniform over the 4 base variants plus
        — when random_pitch_shift — the two pitch-shift families, which
        then draw a ±2/±4-semitone suffix. Returns (signal, sr)."""
        opts = [k for k in _SOURCE_KEYS if k in blob]
        if self._pitch_aug:
            if "audio_ps_u4" not in blob:
                raise KeyError(
                    "audio.feature.random_pitch_shift is enabled but the "
                    "audio blob has no pitch-shift variants — re-run "
                    "`preprocess` with pitch_variants=True")
            opts.extend(["audio_ps", "audio_8k_ps"])
        if require_sr is not None:
            opts = [k for k in opts
                    if (8000 if "_8k" in k else sr) == require_sr]
            assert opts, (
                f"no audio source at required sr {require_sr} (config sr)")
        source = str(self._rng.choice(opts))
        if source.endswith("_ps"):
            source += "_" + str(self._rng.choice(["u4", "u2", "d2", "d4"]))
        return blob[source], (8000 if "_8k" in source else sr)

    def _augment_args(self) -> dict:
        """Sample augmentation knobs (sliding_window.py:121-203)."""
        args = dict(signal_noise=None, feat_extra=None, feat_scale=None,
                    feat_noise=None, feat_tremolo=None, feat_dropout=None,
                    force_preemph=None)
        if not self.training:
            return args
        fc = self.hparams.audio.feature
        rng = self._rng
        if fc.get("random_noise"):
            if rng.choice(["none", "white"]) == "white":
                scale = rng.uniform(fc.random_noise / 5, fc.random_noise)
                args["signal_noise"] = f"white@{scale}"
        if fc.get("random_preemph"):
            args["force_preemph"] = float(rng.uniform(0, fc.random_preemph))
        if fc.get("random_mel_extra") is not None:
            ex_feat, ex_time = fc.random_mel_extra
            args["feat_extra"] = (
                int(rng.integers(-abs(ex_feat), abs(ex_feat) + 1)),
                int(rng.integers(-abs(ex_time), abs(ex_time) + 1)),
            )
        if fc.get("random_mel_scale") is not None:
            n_mels = int(self._mel_cfg["n_mels"])
            scale = np.sin(
                np.linspace(0, 2 * np.pi, num=n_mels) * rng.uniform(-np.pi / 2, np.pi / 2)
                + rng.uniform(0, np.pi)
            ) * fc.random_mel_scale
            args["feat_scale"] = np.exp(scale)[:, None]
        if fc.get("random_mel_noise") is not None:
            args["feat_noise"] = float(fc.random_mel_noise)
        if fc.get("random_mel_dropout") is not None:
            args["feat_dropout"] = float(rng.uniform(0, fc.random_mel_dropout))
        if fc.get("random_mel_tremolo") is not None:
            if rng.uniform() < 0.5:
                args["feat_tremolo"] = float(rng.uniform(0, fc.random_mel_tremolo))
        return args

    def _features(self, signal, stt, end, sr, args, random_args=None):
        mel_cfg = dict(self._mel_cfg)
        if args.get("force_preemph") is not None:
            mel_cfg["preemphasis"] = args["force_preemph"]
        if sr != self._sr:
            # resampled source: rescale window + feature params
            length = int((end - stt) * sr / self._sr)
            stt = int(stt * sr / self._sr)
            end = stt + length
            for key in ("win_size", "hop_size"):
                mel_cfg[key] = int(mel_cfg[key] * sr / self._sr)
        feat, wav, random_args = features_host.windowed_features(
            signal=signal, signal_stt=int(stt), signal_end=int(end),
            mel_cfg=mel_cfg, sr=sr, frames=self._frames,
            signal_noise=args.get("signal_noise"),
            feat_extra=args.get("feat_extra"),
            feat_scale=args.get("feat_scale"),
            feat_noise=args.get("feat_noise"),
            feat_tremolo=args.get("feat_tremolo"),
            feat_dropout=args.get("feat_dropout"),
            random_args=random_args, rng=self._rng,
        )
        # (3, F, T) → (T, F, 3) — model input layout (api.py:108)
        return np.transpose(feat, (2, 1, 0)), wav, random_args

    def _fit_signal(self, wav: np.ndarray) -> np.ndarray:
        """Window audio at a fixed base-sr sample count (linear interp for
        resampled pitch-augmented sources) — TB plugin payloads must stack."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = self._sliding_size
        if len(wav) == n:
            return wav
        if len(wav) == 0:
            return np.zeros(n, np.float32)
        x = np.linspace(0.0, 1.0, n, endpoint=False)
        xp = np.linspace(0.0, 1.0, len(wav), endpoint=False)
        return np.interp(x, xp, wav).astype(np.float32)

    def _frame_store(self, data_path: str, minfi: int, maxfi: int):
        """Consolidated memmap of a sentence's target frames + lip distances.

        The reference loads two %06d.npy files per window per item
        (sliding_window.py:205-240) — with dgrad frames that is ~1.4 MB of
        fresh file I/O per load. We consolidate once into <dir>_frames.npy
        (+ _lips.npy) and serve zero-copy memmap slices afterwards. Each file
        is written whole (``_save_whole``): workers may build it at once.
        """
        store = self._frame_stores.get(data_path)
        if store is None:
            frames_path = data_path + "_frames.npy"
            lips_path = data_path + "_lips.npy"
            if not (os.path.exists(frames_path) and os.path.exists(lips_path)):
                frames = np.stack([
                    np.load(os.path.join(data_path, f"{i:06d}.npy"))
                    for i in range(minfi, maxfi + 1)
                ])
                lips = np.asarray([
                    np.load(os.path.join(data_path, f"{i:06d}_lips_dist.npy"))
                    for i in range(minfi, maxfi + 1)
                ], np.float32)
                _save_whole(frames_path, frames.astype(np.float32))
                _save_whole(lips_path, lips)
            coeffs = None
            if self._pca_targets:
                coeffs_path = data_path + "_coeffs.npy"
                if not os.path.exists(coeffs_path):
                    frames = np.load(frames_path, mmap_mode="r")
                    coeffs = self._project_frames(np.asarray(frames))
                    _save_whole(coeffs_path, coeffs)
                coeffs = np.load(coeffs_path, mmap_mode="r")
            store = (np.load(frames_path, mmap_mode="r"),
                     np.load(lips_path, mmap_mode="r"), minfi, coeffs)
            self._frame_stores[data_path] = store
        return store

    def _project_frames(self, frames: np.ndarray) -> np.ndarray:
        """(N, D) flat target frames → (N, Σk) concatenated PCA coefficients
        (dgrad: scale then rotat branch; others: the single basis)."""
        if self._face_type == "dgrad_3d":
            per_tri = frames.reshape(len(frames), -1, 9)
            parts = [per_tri[:, :, :6].reshape(len(frames), -1),
                     per_tri[:, :, 6:].reshape(len(frames), -1)]
        else:
            parts = [frames.reshape(len(frames), -1)]
        out = []
        for (comp, means), x in zip(self._pca_mats, parts):
            out.append((x - means) @ comp)  # comp: (D, k)
        return np.concatenate(out, axis=-1).astype(np.float32)

    def _anime_target(self, info, data_path, shifted_l, shifted_r):
        """(sliding_window.py:205-240)."""
        start_ts = float(info["start_ts:float"])
        minfi = int(info["anime_minfi:int"])
        maxfi = int(info["anime_maxfi:int"])
        ts = self.sample_to_ms((shifted_l + shifted_r) / 2) - self._ts_delta + start_ts
        pos = ts * self._fps / 1000.0
        lower = int(math.floor(pos))
        upper = lower + 1
        if lower < minfi:
            lower = upper = minfi
        elif upper > maxfi:
            lower = upper = maxfi
        a = float(pos - lower) if upper != lower else 0.0

        frames, lips, base, coeffs = self._frame_store(data_path, minfi, maxfi)
        src = coeffs if self._pca_targets else frames
        feat = src[lower - base] * (1.0 - a) + src[upper - base] * a
        dist = lips[lower - base] * (1.0 - a) + lips[upper - base] * a
        weight = np.exp((0.002 - dist) * 50.0) * 2.0
        return feat.astype(np.float32), np.float32(weight)

    # ------------------------------------------------------------------
    def __getitem__(self, i_frame: int) -> dict:
        j_frame = i_frame + 1
        if (
            j_frame == len(self.coordinates)
            or self.coordinates[i_frame]["data_id"] != self.coordinates[j_frame]["data_id"]
        ):
            j_frame = i_frame
            i_frame = j_frame - 1
        i_info = self.coordinates[i_frame]
        j_info = self.coordinates[j_frame]
        data_id = i_info["data_id"]
        l0, r0 = i_info["range"]
        l1, r1 = j_info["range"]

        shift = 0
        if self.training:
            max_shift = int(self._time_shifting * self._sr)
            shift = int(self._rng.integers(-max_shift, max_shift + 1))
        l0, r0, l1, r1 = l0 + shift, r0 + shift, l1 + shift, r1 + shift

        info = self.info_list[data_id]
        spk_id = self.get_speaker_id(info["speaker:str"])
        emo_id = self.get_emotion_id(info["emotion:str"])
        data_path = info["npy_data_path:path"]
        blob = self._load_audio_blob(data_path)
        sr = int(blob["sr"])

        # choose augmented source signal
        signal = blob["audio"]
        if self.training:
            signal, sr = self._choose_source(blob, sr)

        args = self._augment_args()
        feat0, wav0, random_args = self._features(signal, l0, r0, sr, args)
        feat1, wav1, _ = self._features(signal, l1, r1, sr, args, random_args=random_args)

        ret = dict(
            sr=sr, speaker_id=spk_id, emotion_id=emo_id,
            frame_id_0=i_frame, frame_id_1=j_frame,
            audio_feat_0=feat0, audio_feat_1=feat1,
        )
        # getattr: prefetch workers may unpickle datasets from an older
        # process image that predates the flag
        if getattr(self, "_log_signals", False):
            # fixed base-sr length so collate can stack across items even
            # when pitch-shift augmentation resampled the source
            ret["signal_0"] = self._fit_signal(wav0)
            ret["signal_1"] = self._fit_signal(wav1)
        anime0, ret["anime_weight_0"] = self._anime_target(info, data_path, l0, r0)
        anime1, ret["anime_weight_1"] = self._anime_target(info, data_path, l1, r1)
        self._pack_targets(ret, anime0, anime1)
        return ret

    def _pack_targets(self, ret: dict, anime0, anime1):
        if self._pca_targets:
            if self._face_type == "dgrad_3d":
                k = self._pca_mats[0][0].shape[1]
                for flag, a in ((0, anime0), (1, anime1)):
                    ret[f"dgrad_3d_scale_coef_{flag}"] = a[None, :k]
                    ret[f"dgrad_3d_rotat_coef_{flag}"] = a[None, k:]
            else:
                ret[f"{self._face_type}_coef_0"] = anime0[None, :]
                ret[f"{self._face_type}_coef_1"] = anime1[None, :]
            return
        if self._face_type == "dgrad_3d":
            anime0 = anime0.reshape(-1, 9)
            anime1 = anime1.reshape(-1, 9)
            ret["dgrad_3d_scale_0"] = anime0[None, :, :6]
            ret["dgrad_3d_rotat_0"] = anime0[None, :, 6:]
            ret["dgrad_3d_scale_1"] = anime1[None, :, :6]
            ret["dgrad_3d_rotat_1"] = anime1[None, :, 6:]
        elif self._face_type == "verts_off_3d":
            ret["verts_off_3d_0"] = anime0.reshape(1, -1)
            ret["verts_off_3d_1"] = anime1.reshape(1, -1)
        else:
            raise NotImplementedError(self._face_type)

    # ------------------------------------------------------------------
    # raw mode: host does RNG + wav slicing + target loads only; the mel
    # pipeline + augmentations run on the card (data/device_features.py)
    # ------------------------------------------------------------------
    def raw_item(self, i_frame: int) -> dict:
        j_frame = i_frame + 1
        if (
            j_frame == len(self.coordinates)
            or self.coordinates[i_frame]["data_id"] != self.coordinates[j_frame]["data_id"]
        ):
            j_frame = i_frame
            i_frame = j_frame - 1
        i_info = self.coordinates[i_frame]
        j_info = self.coordinates[j_frame]
        data_id = i_info["data_id"]
        l0, r0 = i_info["range"]
        l1, r1 = j_info["range"]
        shift = 0
        if self.training:
            max_shift = int(self._time_shifting * self._sr)
            shift = int(self._rng.integers(-max_shift, max_shift + 1))
        l0, r0, l1, r1 = l0 + shift, r0 + shift, l1 + shift, r1 + shift

        info = self.info_list[data_id]
        data_path = info["npy_data_path:path"]
        blob = self._load_audio_blob(data_path)
        sr = int(blob["sr"])
        signal = blob["audio"]
        if self.training:
            # raw mode ships the wav slice to the device frontend at the
            # config sr — only sources at that rate are eligible
            signal, sr = self._choose_source(blob, sr, require_sr=self._sr)
        assert sr == self._sr, "raw mode requires dataset sr == config sr"

        hop = int(self._mel_cfg["hop_size"])
        ext = dfeat.MAX_EX_TIME * hop
        wav0 = features_host.slice_window(signal, l0 - ext, r0 + ext)
        wav1 = features_host.slice_window(signal, l1 - ext, r1 + ext)

        rng = self._rng
        fc = self.hparams.audio.feature
        n_mels = int(self._mel_cfg["n_mels"])
        preemph = float(self._mel_cfg.get("preemphasis", 0.0) or 0.0)
        et, f_variant = 0, dfeat.freq_variant_index(0, False, False, "constant")
        feat_scale = np.ones(n_mels, np.float32)
        drop_rows = np.zeros(n_mels, np.float32)
        drop_is_max, drop_thres = 0.0, 0.0
        if self.training:
            if fc.get("random_noise"):
                if rng.choice(["none", "white"]) == "white":
                    scale = rng.uniform(fc.random_noise / 5, fc.random_noise)
                    wav0 = wav0 + rng.normal(0, scale, len(wav0)).astype(np.float32)
                    wav1 = wav1 + rng.normal(0, scale, len(wav1)).astype(np.float32)
            if fc.get("random_preemph"):
                preemph = float(rng.uniform(0, fc.random_preemph))
            if fc.get("random_mel_extra") is not None:
                max_ef, max_et = fc.random_mel_extra
                ef = int(rng.integers(-abs(max_ef), abs(max_ef) + 1))
                et = int(rng.integers(-abs(max_et), abs(max_et) + 1))
                f_variant = dfeat.freq_variant_index(
                    ef,
                    bool(rng.uniform() < 0.5),
                    bool(rng.uniform() < 0.5),
                    str(rng.choice(["reflect", "constant"])),
                )
            if fc.get("random_mel_scale") is not None:
                scale = np.sin(
                    np.linspace(0, 2 * np.pi, num=n_mels)
                    * rng.uniform(-np.pi / 2, np.pi / 2) + rng.uniform(0, np.pi)
                ) * fc.random_mel_scale
                feat_scale = np.exp(scale).astype(np.float32)
            if fc.get("random_mel_dropout") is not None:
                frac = float(rng.uniform(0, fc.random_mel_dropout))
                if frac > 0:
                    mask_len = max(1, int(frac * n_mels))
                    drop_rows[rng.choice(np.arange(n_mels), mask_len)] = 1.0
                    drop_is_max = float(rng.choice([0.0, 1.0]))
                    drop_thres = float(rng.uniform(0.3, 0.6))

        ret = dict(
            speaker_id=self.get_speaker_id(info["speaker:str"]),
            emotion_id=self.get_emotion_id(info["emotion:str"]),
            raw_wav_0=wav0, raw_wav_1=wav1,
            preemph=np.float32(preemph),
            t_idx=np.int32(et + dfeat.MAX_EX_TIME),
            f_idx=np.int32(f_variant),
            feat_scale=feat_scale,
            drop_rows=drop_rows,
            drop_is_max=np.float32(drop_is_max),
            drop_thres=np.float32(drop_thres),
        )
        anime0, ret["anime_weight_0"] = self._anime_target(info, data_path, l0, r0)
        anime1, ret["anime_weight_1"] = self._anime_target(info, data_path, l1, r1)
        self._pack_targets(ret, anime0, anime1)
        return ret

    @staticmethod
    def collate_raw(batch: List[dict]) -> Dict[str, np.ndarray]:
        """Doubled-batch collation for raw items (knobs shared by the pair)."""
        out: Dict[str, List] = {}
        shared = ("speaker_id", "emotion_id", "preemph", "t_idx", "f_idx",
                  "feat_scale", "drop_rows", "drop_is_max", "drop_thres")
        for flag in (0, 1):
            for item in batch:
                for key, val in item.items():
                    if key.endswith(f"_{flag}"):
                        out.setdefault(key[:-2], []).append(val)
        stacked = {k: np.stack(v) for k, v in out.items()}
        for key in shared:
            vals = [item[key] for item in batch] * 2
            stacked[key] = np.stack(vals)
        stacked["speaker_id"] = stacked["speaker_id"].astype(np.int32)
        return stacked

    def raw_batches(self, batch_size: int, shuffle: Optional[bool] = None,
                    drop_last: bool = True, shard: Optional[Tuple[int, int]] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
        """Collated raw batches of ``batch_size`` pairs; with ``shard`` =
        (rank, world), this rank's rows of each global batch (``_index_batches``)."""
        for idx, items in self._index_batches(batch_size, shuffle, drop_last, shard):
            yield self._maybe_compact(self.collate_raw(self._read(self.raw_item, idx, items)))

    def _index_batches(self, batch_size: int, shuffle: Optional[bool], drop_last: bool,
                       shard: Optional[Tuple[int, int]]):
        """(item indices, item streams) of every batch of an epoch: the indices
        in the reader's shuffled order, the streams None (each item draws from
        the reader's one stream, as the JAX reader does).

        With ``shard`` = (rank, world) the global batch of ``batch_size``
        pairs is split before anything is read: this rank takes pairs [r·b,
        (r+1)·b), b = batch_size / world, and its collated rows are the
        pair-keeping shard of the global batch (``parallel.mesh.shard_rows``).
        Each item then draws its augmentation from a stream of its own, seeded
        by (a draw of the reader's stream, its place in the global batch), so
        that its rows do not depend on the items other ranks read: for any
        world size they are bit-equal to the matching rows of ``shard=(0, 1)``.
        The last global batch is dropped unless it is whole."""
        shuffle = self.training if shuffle is None else shuffle
        order = np.arange(len(self))
        if shuffle:
            self._rng.shuffle(order)
        if shard is None:
            for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
                yield order[i : i + batch_size], None
            return
        rank, world = shard
        if batch_size % world:
            raise ValueError(f"a batch of {batch_size} pairs does not split over {world} ranks")
        local = batch_size // world
        for i in range(0, len(order) - (batch_size - 1), batch_size):
            batch_seed = int(self._rng.integers(2 ** 63))
            pos = range(rank * local, (rank + 1) * local)
            yield order[i + pos.start : i + pos.stop], [(batch_seed, p) for p in pos]

    def _read(self, read, idx, streams) -> List[dict]:
        """``read(j)`` for every index; with streams, each item with the reader's
        stream swapped for its own."""
        if streams is None:
            return [read(int(j)) for j in idx]
        saved, items = self._rng, []
        try:
            for j, seed in zip(idx, streams):
                self._rng = np.random.default_rng(seed)
                items.append(read(int(j)))
        finally:
            self._rng = saved
        return items

    def _maybe_compact(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self._compact_targets:
            for key in list(batch):
                # coefficient targets are already ~350× smaller — keep f32
                if (key.startswith(self._face_type) and "_coef" not in key
                        and batch[key].dtype == np.float32):
                    batch[key] = batch[key].astype(np.float16)
        return batch

    # ------------------------------------------------------------------
    @staticmethod
    def collate(batch: List[dict]) -> Dict[str, np.ndarray]:
        """Double the batch: first half = frame i, second = frame i+1
        (sliding_window.py:286-315)."""
        out: Dict[str, List] = {}
        for flag in (0, 1):
            for item in batch:
                for key, val in item.items():
                    if key.endswith(f"_{flag}") and key not in ("frame_id_0", "frame_id_1"):
                        name = key[: -2]
                        out.setdefault(name, []).append(val)
                    elif key in ("speaker_id", "emotion_id", "sr") and flag == 0:
                        pass
        stacked = {k: np.stack(v) for k, v in out.items()}
        for key in ("speaker_id", "emotion_id"):
            vals = [item[key] for item in batch] * 2
            stacked[key] = np.asarray(vals, np.int32)
        return stacked

    def batches(self, batch_size: int, shuffle: Optional[bool] = None,
                drop_last: bool = True, shard: Optional[Tuple[int, int]] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Collated batches of ``batch_size`` pairs; ``shard`` as in
        ``raw_batches``."""
        for idx, items in self._index_batches(batch_size, shuffle, drop_last, shard):
            yield self._maybe_compact(self.collate(self._read(self.__getitem__, idx, items)))

    # ------------------------------------------------------------------
    @classmethod
    def fetch_audio_features(cls, signal: np.ndarray, hparams: ConfigDict) -> dict:
        """Inference windows for a whole clip (sliding_window.py:320-377):
        one center-aligned window per 60 fps output frame, zero padded,
        ts = center − ts_delta; returns tslist/energy/audio_feat."""
        feat_cfg = hparams.audio.feature
        mel_cfg = dict(hparams.audio[feat_cfg.name])
        sr = int(hparams.audio.sample_rate)
        for key in ("win_size", "hop_size"):
            if isinstance(mel_cfg[key], float):
                mel_cfg[key] = int(mel_cfg[key] * sr)
        frames = int(feat_cfg.sliding_window_frames)
        fps = float(hparams.anime.fps)
        ts_delta = float(hparams.anime.feature.ts_delta)
        sliding = mel_cfg["hop_size"] * (frames - 1) + mel_cfg["win_size"]

        ts_list, feats, energy = [], [], []
        idx = -1.0
        while idx * sr / fps + sliding <= len(signal) + sliding * 2:
            m = math.floor(idx * sr / fps)
            e = m + sliding // 2
            s = e - sliding
            ts = int(round((s + e) / 2 * 1000.0 / sr - ts_delta))
            wav = features_host.slice_window(signal, s, e)
            energy.append(features_host.rms_frames(wav, mel_cfg["win_size"], mel_cfg["hop_size"]))
            feat, _, _ = features_host.windowed_features(
                signal=wav, signal_stt=0, signal_end=len(wav),
                mel_cfg=mel_cfg, sr=sr, frames=frames,
            )
            feats.append(np.transpose(feat, (2, 1, 0)))  # (T, F, 3)
            ts_list.append(ts)
            idx += 1.0

        return dict(
            tslist=ts_list,
            energy=np.asarray(energy, np.float32),
            audio_feat=np.asarray(feats, np.float32),
        )
