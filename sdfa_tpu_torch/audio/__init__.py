from . import dsp, pipeline

__all__ = ["dsp", "pipeline"]
