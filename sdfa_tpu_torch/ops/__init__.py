"""Device ops: the deformation solver and the hand-written Hopper kernels —
``freq_lstm``, ``bilstm2``, ``bilstm_layer`` and ``decode_solve`` on the
serving path, ``bilstm_core`` (forward and backward) on the training path —
each beside its plain PyTorch version and a launch counter.

``plain_versions()`` routes the model's kernel calls to the plain
versions for the duration of a ``with`` block — the comparison that
holds a CUDA run through the kernels against the same run without them.
The wrappers themselves never fall back: for a CUDA tensor they launch
the kernel or raise.

A module picks its route before it launches, from the shape alone, as the
JAX modules gate their Pallas kernels: the kernel wherever one takes the
shape; else the plain recurrence where the JAX package takes its scan, and
a ``ValueError`` where it runs a Pallas kernel the port has not
instantiated. ``PLAIN_ROUTES`` counts the plain routes taken on a CUDA
tensor outside ``plain_versions()``, so that a run on a card can show that
it took none.
"""

from __future__ import annotations

import contextlib

_PLAIN = [False]
PLAIN_ROUTES = 0  # plain recurrences taken on a CUDA tensor because no kernel takes the shape


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


def plain_route(x) -> None:
    """Count a plain route a module takes for ``x`` because no kernel takes
    its shape: on a CUDA tensor outside ``plain_versions()``."""
    global PLAIN_ROUTES
    if x.device.type == "cuda" and not _PLAIN[0]:
        PLAIN_ROUTES += 1


def full_float32():
    """Keep float32 products and convolutions on a card in full float32:
    cuDNN convolutions would otherwise run in TF32 (about three decimal
    digits). The entry points (``AnimationTask``, ``Experiment``) call this,
    so the package's accuracy does not depend on the caller's settings."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
