"""Device ops: the deformation solver and the hand-written Hopper kernels —
``freq_lstm``, ``bilstm2``, ``bilstm_layer`` and ``decode_solve`` on the
serving path, ``bilstm_core`` (forward and backward) on the training path —
each beside its plain PyTorch version and a launch counter.

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


def full_float32():
    """Keep float32 products and convolutions on a card in full float32:
    cuDNN convolutions would otherwise run in TF32 (about three decimal
    digits). The entry points (``AnimationTask``, ``Experiment``) call this,
    so the package's accuracy does not depend on the caller's settings."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
