"""The share of the window's train steps that ran as one CUDA graph replay:
the program's ``train/graph_replay`` spans (``Experiment.train_step``) in the
traced window over the steps the window ran, times 100. None where the trace
holds no such span: a program that replays no graph."""

SPAN = "train/graph_replay"


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    if ctx.trace is None or not steps:
        return None
    replays = sum(1 for name, cat, _, _ in ctx.trace.host
                  if cat == "user_annotation" and name == SPAN)
    return 100.0 * replays / steps if replays else None
