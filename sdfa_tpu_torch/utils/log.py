"""Console/file logger with timing helpers (counterpart of
``sdfa_tpu/utils/log.py``).

The JAX package's API — ``info`` / ``warn`` / ``error`` / ``fatal`` /
``assertion``, ``timeit`` (a context manager) and ``timed`` (its decorator),
``set_log_file``, ``set_verbose`` and a ``tqdm`` re-export — on the stdlib
``logging`` the rest of the port logs through. Its records go to the logger
``sdfa_tpu_torch.log``, which writes them itself and does not pass them on:
to the console as ``[LEVEL] message`` (info and warn on stdout, only while
verbose; error and fatal on stderr, coloured on a terminal) and, after
``set_log_file``, appended to that file, the lines the JAX logger writes.
The port's modules that call ``logging.getLogger`` keep doing so.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
import time
from typing import Optional

try:  # tqdm is optional: without it, iterate the iterable as it is
    from tqdm import tqdm as _tqdm
except ImportError:  # pragma: no cover
    def _tqdm(iterable=None, **kwargs):
        return iterable if iterable is not None else []

tqdm = _tqdm

_COLORS = {"INFO": "\033[36m", "WARN": "\033[33m", "ERROR": "\033[31m", "FATAL": "\033[41m"}
_RESET = "\033[0m"
_LEVELS = {"info": (logging.INFO, "INFO"), "warn": (logging.WARNING, "WARN"),
           "error": (logging.ERROR, "ERROR"), "fatal": (logging.CRITICAL, "FATAL")}
_FORMAT = logging.Formatter("[%(tag)-5s] %(message)s")
_VERBOSE = [True]


class _Console(logging.Handler):
    """Prints a record to the stream of its level as the call happens, so
    that a redirected ``sys.stdout`` / ``sys.stderr`` receives it."""

    def emit(self, record):
        loud = record.levelno >= logging.ERROR
        if not (_VERBOSE[0] or loud):
            return
        stream = sys.stderr if loud else sys.stdout
        line = _FORMAT.format(record)
        if hasattr(stream, "isatty") and stream.isatty():
            line = _COLORS.get(record.tag, "") + line + _RESET
        print(line, file=stream)


_LOGGER = logging.getLogger("sdfa_tpu_torch.log")
_LOGGER.setLevel(logging.INFO)
_LOGGER.propagate = False
_LOGGER.addHandler(_Console())
_FILE: list = [None]  # the FileHandler of set_log_file


def set_log_file(path: Optional[str]):
    """Append every record to ``path`` from now on (its directory is made);
    ``None`` stops writing to a file."""
    if _FILE[0] is not None:
        _LOGGER.removeHandler(_FILE[0])
        _FILE[0].close()
        _FILE[0] = None
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        handler = logging.FileHandler(path, mode="a")
        handler.setFormatter(_FORMAT)
        _LOGGER.addHandler(handler)
        _FILE[0] = handler


def set_verbose(flag: bool):
    """Print info and warn records to the console (errors always print)."""
    _VERBOSE[0] = bool(flag)


def _emit(level: str, *args):
    levelno, tag = _LEVELS[level]
    _LOGGER.log(levelno, " ".join(str(a) for a in args), extra={"tag": tag})


def info(*args):
    _emit("info", *args)


def warn(*args):
    _emit("warn", *args)


def error(*args):
    _emit("error", *args)


def fatal(*args):
    """Logs, then raises ``SystemExit(1)``."""
    _emit("fatal", *args)
    raise SystemExit(1)


def assertion(cond, *args):
    if not cond:
        fatal(*args if args else ("assertion failed",))


@contextlib.contextmanager
def timeit(tag: str = "timeit", verbose: bool = True):
    """Logs ``<tag>: <ms> ms`` for the block it wraps."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if verbose:
        info(f"{tag}: {dt * 1000.0:.2f} ms")


def timed(tag: Optional[str] = None):
    """Decorator variant of :func:`timeit`, tagged with the function's
    qualified name unless ``tag`` is given."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with timeit(tag or fn.__qualname__):
                return fn(*args, **kwargs)

        return wrapper

    return deco
