"""The whole step's share of the card's peak: the plain reference's FLOPs of
one training step, forward and backward (``FlopCounterMode``), times the steps
the window ran, over 495 TFLOP/s times the traced window."""


def read(ctx):
    f = ctx.model_flops.get("step")
    steps = ctx.counts.get("steps", 0)
    if ctx.trace is None or not f or not steps:
        return None
    return 100.0 * f * steps / (ctx.costs.PEAK_TF32_FLOPS * ctx.trace.window_s)
