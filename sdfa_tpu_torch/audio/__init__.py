from . import dsp, features, io, pipeline, rms
from .dsp import mel_spectrogram, preemphasis, spectrogram
from .io import load, save

__all__ = ["dsp", "features", "io", "load", "mel_spectrogram", "pipeline", "preemphasis", "rms",
           "save", "spectrogram"]
