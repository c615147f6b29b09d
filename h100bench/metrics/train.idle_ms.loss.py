"""The card's idle milliseconds per step under the loss (``train/loss_terms``:
the PCA decode, the terms and the dynamic scalers, with the part of
``train/forward_loss`` outside its children): ``stages.idle_by_stage`` of the
traced window over the steps it ran."""

from h100bench.stages import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "loss")
