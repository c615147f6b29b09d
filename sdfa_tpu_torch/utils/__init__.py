from . import argparser, bilateral, filesystem, log, npext, stream
from .argparser import ArgumentParser
from .bilateral import BilateralFilter1D

__all__ = ["ArgumentParser", "BilateralFilter1D", "argparser", "bilateral", "filesystem", "log",
           "npext", "stream", "visualizer"]


def __getattr__(name):
    """``visualizer`` on first use: it reaches matplotlib, which a host may lack."""
    if name == "visualizer":
        import importlib

        return importlib.import_module(".visualizer", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
