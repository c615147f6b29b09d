"""The whole tick's share of the card's peak: the plain reference's FLOPs
(``FlopCounterMode``) for every frame encoded and every window delivered in
the window, over 495 TFLOP/s times the traced window."""


def read(ctx):
    f = ctx.model_flops
    c = ctx.counts
    if ctx.trace is None or not f or not c.get("windows"):
        return None
    flops = f["frame"] * c["encoded"] + f["window"] * c["windows"]
    return 100.0 * flops / (ctx.costs.PEAK_TF32_FLOPS * ctx.trace.window_s)
