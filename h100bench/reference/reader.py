"""Plain reference of the training reader in raw mode: each item of a batch
rebuilt from the corpus files alone (``train.csv``, ``<sentence>_audio.npz``,
``_frames.npy`` and the PCA bases), given the window the
reader drew and the state of its random stream before the item.

It follows the semantics of the VOCA sliding-window reader: windows a frame
apart over each sentence padded by a third of a second, the pair (i, i + 1)
inside one sentence, a time shift of up to half a frame, the audio source
drawn among the sentence's variants at the configuration's rate, white noise,
a drawn preemphasis, the mel extra / scale / dropout knobs, and targets
interpolated between the two frames around the window's centre less
``ts_delta`` and projected on the PCA bases, here in float64. Rows are
collated as the reader does: every item's first window, then every item's
second, the shared knobs repeated.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

SOURCE_KEYS = ("audio", "audio_denoised", "audio_8k", "audio_denoised_8k")
MAX_EX_TIME, MAX_EX_FEAT = 4, 5


def freq_index(ef: int, lower: bool, trunc: bool, mode: str) -> int:
    """The frequency variant's index as the training features decode it:
    ef + 5 in the eighths, then lower, trunc and the pad mode (reflect 1)."""
    return (ef + MAX_EX_FEAT) * 8 + 4 * int(lower) + 2 * int(trunc) + int(mode == "reflect")


def _slice(signal: np.ndarray, start: int, end: int) -> np.ndarray:
    """signal[start:end] with zeros outside it, float32."""
    out = np.zeros(end - start, np.float32)
    lo, hi = max(start, 0), min(end, len(signal))
    if hi > lo:
        out[lo - start:hi - start] = signal[lo:hi]
    return out


class Reader:
    """The corpus under ``root`` as the configuration ``hp`` (a plain dict)
    reads it for training."""

    def __init__(self, hp: Dict, root: str):
        audio = hp["audio"]
        fc = audio["feature"]
        mel = dict(audio[fc["name"]])
        self.sr = int(audio["sample_rate"])
        for key in ("win_size", "hop_size"):
            if isinstance(mel[key], float):
                mel[key] = int(mel[key] * self.sr)
        self.hop, self.n_mels = int(mel["hop_size"]), int(mel["n_mels"])
        self.fc, self.fps = fc, float(hp["anime"]["fps"])
        self.ts_delta = float(hp["anime"]["feature"]["ts_delta"])
        self.size = self.hop * (int(fc["sliding_window_frames"]) - 1) + int(mel["win_size"])
        ds = hp["dataset_anime"]
        self.speakers = ds["speakers"]
        self.root = root
        with open(os.path.join(root, ds["train_list"][0])) as fp:
            rows = list(csv.DictReader(fp))
        seen, self.rows = set(), []
        for row in rows:
            key = row[ds["primary_key"]]
            if key in seen or row["speaker:str"] not in self.speakers:
                continue
            seen.add(key)
            self.rows.append(row)
        self.windows: List[Tuple[int, int]] = []  # (row, first sample)
        for i, row in enumerate(self.rows):
            left, end = float(-(self.sr // 3)), int(row["audio_samples:int"]) + self.sr // 3
            while left + self.size <= end:
                self.windows.append((i, math.ceil(left)))
                left += self.sr / self.fps
        face = hp["model"]["face_data_type"]
        names = (("scale_", 6), ("rotat_", 3)) if face == "dgrad_3d" else (("", None),)
        self.bases = [(np.load(os.path.join(root, "pca", n + "compT.npy")).astype(np.float64),
                       np.load(os.path.join(root, "pca", n + "means.npy")).astype(np.float64), g)
                      for n, g in names]
        self._files: Dict[str, tuple] = {}

    def _sentence(self, i: int):
        path = os.path.join(self.root, self.rows[i]["npy_data_path:path"])
        if path not in self._files:
            blob = dict(np.load(path + "_audio.npz"))
            self._files[path] = (blob, np.load(path + "_frames.npy", mmap_mode="r"), {})
        return self._files[path]

    def _coef(self, i: int, frame: int) -> np.ndarray:
        """The PCA coefficients of a sentence's frame, in float64."""
        _, frames, cache = self._sentence(i)
        if frame not in cache:
            x = np.asarray(frames[frame], np.float64)
            parts = []
            for comp, means, group in self.bases:
                if group is None:
                    sub = x
                else:
                    per = x.reshape(-1, 9)
                    sub = (per[:, :6] if group == 6 else per[:, 6:]).reshape(-1)
                parts.append((sub - means) @ comp)
            cache[frame] = np.concatenate(parts)
        return cache[frame]

    def _target(self, i: int, left: int, right: int):
        row = self.rows[i]
        minfi, maxfi = int(row["anime_minfi:int"]), int(row["anime_maxfi:int"])
        ts = (left + right) / 2 * 1000.0 / self.sr - self.ts_delta + float(row["start_ts:float"])
        pos = ts * self.fps / 1000.0
        lo = int(math.floor(pos))
        hi = lo + 1
        if lo < minfi:
            lo = hi = minfi
        elif hi > maxfi:
            lo = hi = maxfi
        a = pos - lo if hi != lo else 0.0
        return self._coef(i, lo - minfi) * (1.0 - a) + self._coef(i, hi - minfi) * a

    def item(self, index: int, rng: np.random.Generator) -> Dict:
        fc, n_mels = self.fc, self.n_mels
        first = index
        if index + 1 == len(self.windows) or self.windows[index + 1][0] != self.windows[index][0]:
            first = index - 1
        i, l0 = self.windows[first]
        l1 = self.windows[first + 1][1]
        shift = int(rng.integers(-int(0.5 / self.fps * self.sr), int(0.5 / self.fps * self.sr) + 1))
        l0, l1 = l0 + shift, l1 + shift
        blob = self._sentence(i)[0]
        sr = int(blob["sr"])
        sources = [k for k in SOURCE_KEYS if k in blob and (8000 if "_8k" in k else sr) == self.sr]
        signal = blob[str(rng.choice(sources))]
        ext = MAX_EX_TIME * self.hop
        wav = [_slice(signal, l - ext, l + self.size + ext) for l in (l0, l1)]
        preemph, et, ef, lower, trunc, mode = 0.0, 0, 0, False, False, "constant"
        feat_scale = np.ones(n_mels, np.float32)
        drop_rows = np.zeros(n_mels, np.float32)
        drop_is_max = 0.0
        if fc.get("random_noise"):
            if rng.choice(["none", "white"]) == "white":
                scale = rng.uniform(fc["random_noise"] / 5, fc["random_noise"])
                wav = [w + rng.normal(0, scale, len(w)).astype(np.float32) for w in wav]
        if fc.get("random_preemph"):
            preemph = float(rng.uniform(0, fc["random_preemph"]))
        if fc.get("random_mel_extra") is not None:
            max_ef, max_et = fc["random_mel_extra"]
            ef = int(rng.integers(-abs(max_ef), abs(max_ef) + 1))
            et = int(rng.integers(-abs(max_et), abs(max_et) + 1))
            lower, trunc = bool(rng.uniform() < 0.5), bool(rng.uniform() < 0.5)
            mode = str(rng.choice(["reflect", "constant"]))
        if fc.get("random_mel_scale") is not None:
            phase = np.linspace(0, 2 * np.pi, num=n_mels) * rng.uniform(-np.pi / 2, np.pi / 2)
            feat_scale = np.exp(np.sin(phase + rng.uniform(0, np.pi))
                                * fc["random_mel_scale"]).astype(np.float32)
        if fc.get("random_mel_dropout") is not None:
            frac = float(rng.uniform(0, fc["random_mel_dropout"]))
            if frac > 0:
                drop_rows[rng.choice(np.arange(n_mels), max(1, int(frac * n_mels)))] = 1.0
                drop_is_max = float(rng.choice([0.0, 1.0]))
                rng.uniform(0.3, 0.6)  # the threshold of the "max" mode, which the step ignores
        return {"speaker_id": self.speakers[self.rows[i]["speaker:str"]], "raw_wav": wav,
                "preemph": preemph, "t_idx": et + MAX_EX_TIME,
                "f_idx": freq_index(ef, lower, trunc, mode), "feat_scale": feat_scale,
                "drop_rows": drop_rows, "drop_is_max": drop_is_max,
                "coef": [self._target(i, l, l + self.size) for l in (l0, l1)]}

    def batch(self, drawn: Sequence[Tuple[int, dict]]) -> Dict[str, np.ndarray]:
        """The collated batch of items (window index, the random stream's
        state before the item)."""
        items = []
        for index, state in drawn:
            rng = np.random.default_rng()
            rng.bit_generator.state = state
            items.append(self.item(int(index), rng))
        out = {"raw_wav": np.stack([it["raw_wav"][f] for f in (0, 1) for it in items]),
               "coef": np.stack([it["coef"][f] for f in (0, 1) for it in items])}
        for key in ("speaker_id", "preemph", "t_idx", "f_idx", "feat_scale", "drop_rows",
                    "drop_is_max"):
            out[key] = np.stack([np.asarray(it[key]) for it in items] * 2)
        return out


def compare(reader: Reader, batches: Sequence[Dict], drawn: Sequence[Sequence]) -> Dict[str, float]:
    """The reader's numbers that decide ``correct``, over the batches the
    program's reader delivered: the widest gap of the raw windows and the
    augmentation knobs from the rebuild, and the widest gap of the PCA
    coefficient targets over the largest coefficient of the rebuild."""
    inputs, target = 0.0, 0.0
    for got, items in zip(batches, drawn):
        want = reader.batch(items)
        for key in ("raw_wav", "speaker_id", "preemph", "t_idx", "f_idx", "feat_scale",
                    "drop_rows", "drop_is_max"):
            g = np.asarray(got[key], np.float64)
            w = np.asarray(want[key], np.float64)
            inputs = max(inputs, float(np.abs(g - w).max()) if g.shape == w.shape else math.inf)
        coef_keys = [k for k in got if k.endswith("_coef")]
        coef_keys.sort(key=lambda k: ("rotat" in k, k))  # scale first, as the bases
        g = np.concatenate([np.asarray(got[k], np.float64).reshape(len(got[k]), -1)
                            for k in coef_keys], axis=1)
        w = want["coef"]
        target = max(target, float(np.abs(g - w).max() / np.abs(w).max())
                     if g.shape == w.shape else math.inf)
    return {"reader_input_gap": inputs, "reader_target_gap": target}


def bfloat16_batch(reader: Reader, drawn: Sequence[Tuple[int, dict]], coef_keys: Sequence[str]
                   ) -> Dict[str, np.ndarray]:
    """The control: the rebuilt batch in bfloat16, the nearest precision
    below the reader's float32, under the program's names (``coef_keys``:
    the target keys, scale first, split at the bases' widths)."""
    import torch

    def bf16(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()

    want = reader.batch(drawn)
    out = {k: (bf16(v) if k in ("raw_wav", "preemph", "feat_scale") else v)
           for k, v in want.items() if k != "coef"}
    at = 0
    for key, (comp, _, _) in zip(coef_keys, reader.bases):
        out[key] = bf16(want["coef"][:, at:at + comp.shape[1]])
        at += comp.shape[1]
    return out
