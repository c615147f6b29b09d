"""Device ops: the deformation solver and the hand-written Hopper kernels —
``freq_lstm``, ``bilstm2``, ``bilstm_layer`` and ``decode_solve`` (its delta
body on identity equation tables, its full body on tables with triangle
correspondences) on the serving path, ``bilstm_core`` (forward and backward)
on the training path — each beside its plain PyTorch version and a launch
counter.

``plain_versions()`` routes the model's kernel calls to the plain
versions for the duration of a ``with`` block — the comparison that
holds a CUDA run through the kernels against the same run without them.
The wrappers themselves never fall back: for a CUDA tensor they launch
the kernel or raise.

A module picks its route before it launches, from the shape alone, as the
JAX modules gate their Pallas kernels: the kernel wherever one takes the
shape (every shape the JAX package sends to a Pallas kernel); else the plain
recurrence, where the JAX package takes its scan. ``PLAIN_ROUTES`` counts
the plain routes taken on a CUDA tensor outside ``plain_versions()``, so
that a run on a card can show that it took none.

Each kernel module also has ``cost(shape...) -> (flops, bytes)``: the work
of one launch, the count ``chip_smoke.py`` reckons the kernel's bound from
(the operations of its products, each input read once and each output
written once). Inside ``count_costs()`` every launch records its cost, which
is how ``train/stepbench.py::StepEnv.cost_stats`` adds the kernels that
PyTorch's own counters cannot see.
"""

from __future__ import annotations

import contextlib

_PLAIN = [False]
_COSTS = [None]  # inside count_costs(): the list each kernel launch appends its cost to
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


@contextlib.contextmanager
def count_costs():
    """Yields a list that collects ``(kernel, flops, bytes)`` for every kernel
    launch inside the block."""
    prev, launches = _COSTS[0], []
    _COSTS[0] = launches
    try:
        yield launches
    finally:
        _COSTS[0] = prev


def note_launch(kernel: str, cost) -> None:
    """A kernel wrapper's launch of ``kernel`` with ``cost`` = (flops, bytes):
    recorded inside ``count_costs()``."""
    if _COSTS[0] is not None:
        _COSTS[0].append((kernel, *cost))


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
    so the package's accuracy does not depend on the caller's settings. The
    ``SDFA_*_PRECISION`` variables may ask for less (``nn/precision.py``);
    unset, they leave full float32."""
    from ..nn import precision

    precision.apply()
