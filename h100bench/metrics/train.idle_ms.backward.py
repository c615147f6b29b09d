"""The card's idle milliseconds per step under the backward pass
(``train/backward``): ``stages.idle_by_stage`` of the traced window over the
steps it ran."""

from h100bench.stages import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "backward")
