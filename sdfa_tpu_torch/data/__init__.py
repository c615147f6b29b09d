"""Readers and loaders of the training path (counterpart of ``sdfa_tpu/data``):
the synthetic dataset, CSV manifests, the sliding-window reader, the host
feature path, the on-device training frontend and the prefetchers."""

from . import csvio, features_host, prefetch, synthetic
from .sliding_window import DatasetSlidingWindow
from .speech_anime import SpeechAnimeDataset

__all__ = [
    "csvio",
    "prefetch",
    "features_host",
    "synthetic",
    "DatasetSlidingWindow",
    "SpeechAnimeDataset",
]
