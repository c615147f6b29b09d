from . import argparser, filesystem, stream
from .argparser import ArgumentParser

__all__ = ["ArgumentParser", "argparser", "filesystem", "stream"]
