from . import dsp, features, io, misc, pipeline, rms
from .dsp import mel_spectrogram, preemphasis, spectrogram
from .io import load, save
from .misc import (
    detect_speech,
    inv_mulaw,
    mu_normalize,
    mu_quantize,
    mulaw,
    pink_noise,
    vad_from_pairs,
    vad_to_pairs,
    white_noise,
)

__all__ = [
    "dsp", "features", "io", "misc", "pipeline", "rms",
    "mel_spectrogram", "spectrogram", "preemphasis", "load", "save",
    "white_noise", "pink_noise", "mulaw", "inv_mulaw",
    "mu_quantize", "mu_normalize", "detect_speech",
    "vad_to_pairs", "vad_from_pairs",
]
