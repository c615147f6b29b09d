"""Dataset base: CSV manifests, id maps, unit conversions (counterpart of
``sdfa_tpu/data/speech_anime.py``, copied).

Reference: speech_anime/datasets/speech_anime.py:18-164 —
reads train/valid manifests, dedups by primary key, filters unknown
speakers/emotions, exposes ms/sample/frame conversions.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

from ..config import ConfigDict
from . import csvio

log = logging.getLogger(__name__)


class SpeechAnimeDataset:
    def __init__(self, hparams: ConfigDict, training: bool):
        self.hparams = hparams
        self.training = training
        ds = hparams.dataset_anime
        self.root = ds.root
        self.speakers: Dict[str, int] = dict(ds.speakers)
        self.emotions: Dict[str, int] = dict(ds.emotions)
        self.primary_key = ds.get("primary_key", "npy_data_path:path")

        csv_names = ds.train_list if training else ds.valid_list
        rows: List[dict] = []
        for name in csv_names:
            path = name if os.path.isabs(name) else os.path.join(self.root, name)
            if not os.path.exists(path):
                log.warning("manifest not found: %s", path)
                continue
            rows.extend(csvio.read_csv(path))

        # dedup by primary key + filter unknown speakers/emotions
        seen = set()
        self.info_list: List[dict] = []
        for row in rows:
            key = row.get(self.primary_key)
            if key in seen:
                continue
            if row.get("speaker:str") not in self.speakers:
                continue
            if row.get("emotion:str") not in self.emotions:
                continue
            seen.add(key)
            self.info_list.append(row)

        self._sr = int(hparams.audio.sample_rate)
        self._fps = float(hparams.anime.fps)

    def __len__(self):
        return len(self.info_list)

    @property
    def num_speakers(self) -> int:
        return len(self.speakers)

    def get_speaker_id(self, name: str) -> int:
        return self.speakers[name]

    def get_emotion_id(self, name: str) -> int:
        return self.emotions[name]

    # unit conversions (speech_anime.py:128-164)
    def ms_to_sample(self, ms: float) -> float:
        return ms * self._sr / 1000.0

    def sample_to_ms(self, sample: float) -> float:
        return sample * 1000.0 / self._sr

    def frame_to_ms(self, frame: float) -> float:
        return frame * 1000.0 / self._fps

    def ms_to_frame(self, ms: float) -> float:
        return ms * self._fps / 1000.0

    def frame_to_sample(self, frame: float) -> float:
        return frame * self._sr / self._fps

    def sample_to_frame(self, sample: float) -> float:
        return sample * self._fps / self._sr
