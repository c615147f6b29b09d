"""Device ops: the deformation solver and the three hand-written Hopper
kernels (``freq_lstm``, ``bilstm2``, ``decode_solve``), each beside its
plain PyTorch version and a launch counter.

``plain_versions()`` routes the model's kernel calls to the plain
versions for the duration of a ``with`` block — the comparison that
holds a CUDA run through the kernels against the same run without them.
The wrappers themselves never fall back: for a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

import contextlib

_PLAIN = [False]


@contextlib.contextmanager
def plain_versions():
    prev = _PLAIN[0]
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = prev


def using_plain() -> bool:
    return _PLAIN[0]
