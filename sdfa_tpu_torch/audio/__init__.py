from . import dsp, io, pipeline, rms
from .io import load, save

__all__ = ["dsp", "io", "load", "pipeline", "rms", "save"]
