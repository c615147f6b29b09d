"""The card's idle milliseconds per step under the optimizer (``train/zero_grad``
and ``train/clip_adam``: the gradient norm, clipping and Adam):
``stages.idle_by_stage`` of the traced window over the steps it ran."""

from h100bench.stages import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "optimizer")
