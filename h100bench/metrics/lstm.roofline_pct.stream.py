"""Share of the roofline of the recurrent kernels K1 (FreqLstm, one row per
encoded frame) and K2 (the 2-layer biLSTM, one row per window), counted
together: they share the kernels of ``bilstm_layer.cuh``. Least time for the
rows the window ran, over the device time of those kernels."""

KERNELS = ("proj_weights_kernel", "proj_pad_kernel", "proj_kernel", "steps_kernel",
           "wide_steps_kernel", "out_parts_kernel", "out_sum_kernel")


def read(ctx):
    from h100bench.metrics_ctx import summed

    c, layers = ctx.counts, ctx.hp["model"]["audio_encoder"]["layers"]
    ticks = c.get("ticks", 0)
    if not ticks or not c.get("windows"):
        return None
    freq = [s for s in layers if s[0] == "freq-lstm"][0]
    hidden = int([o for o in freq if isinstance(o, str) and o.startswith("hidden_size=")][0]
                 .split("=")[1])
    out = int([o for o in freq if isinstance(o, str) and o.startswith("output_size=")][0]
              .split("=")[1])
    lstm = [s for s in layers if s[0] == "lstm"][0]
    frames = int(ctx.hp["audio"]["feature"]["sliding_window_frames"])
    f1, b1 = summed(ctx.costs.freq_lstm, c["encoded"], 2 * ticks, int(freq[2]), int(freq[1]),
                    hidden, out)
    f2, b2 = summed(ctx.costs.bilstm2, c["windows"], ticks, frames, int(lstm[1]), int(lstm[2]),
                    False)
    return ctx.share(f1 + f2, b1 + b2, KERNELS)
