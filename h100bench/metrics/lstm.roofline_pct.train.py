"""Share of the roofline of the training recurrences (K5, ``ops/bilstm_core.py``:
forward and backward of FreqLstm's layer over the frequency axis and of the
2-layer biLSTM over time): least time for the steps the window ran, over the
device time of K5's kernels."""

KERNELS = ("steps_kernel", "wide_steps_kernel", "core_bwd_kernel", "wide_bwd_kernel")


def read(ctx):
    c, layers = ctx.counts, ctx.hp["model"]["audio_encoder"]["layers"]
    steps, rows = c.get("steps", 0), c.get("rows", 0)
    if not steps or not rows:
        return None
    freq = [s for s in layers if s[0] == "freq-lstm"][0]
    hidden = int([o for o in freq if isinstance(o, str) and o.startswith("hidden_size=")][0]
                 .split("=")[1])
    lstm = [s for s in layers if s[0] == "lstm"][0]
    n_layers = int([o for o in lstm if isinstance(o, str) and o.startswith("num_layers=")][0]
                   .split("=")[1])
    frames = int(ctx.hp["audio"]["feature"]["sliding_window_frames"])
    flops = nbytes = 0.0
    for shape, launches in (((int(freq[2]), rows * frames, hidden), 1),
                            ((frames, rows, int(lstm[2])), n_layers)):
        f, b = ctx.costs.bilstm_core(*shape)
        flops += 2 * launches * steps * f  # a forward and a backward launch each
        nbytes += 2 * launches * steps * b
    return ctx.share(flops, nbytes, KERNELS)
