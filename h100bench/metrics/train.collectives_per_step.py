"""Collectives a step: the delta of ``parallel.mesh.CALLS`` over the window
(every op of the program's mesh, device and host groups) over the steps it
ran. ``drivers/train_dp.py`` notes beside it the ``mesh/*`` spans of rank
0's trace and the count the model gives (a pair per BatchNorm module, the
gradient exchange, the dynamic scalers, the step's metrics, the batch's
agreement)."""


def read(ctx):
    calls, steps = ctx.counts.get("collectives"), ctx.counts.get("steps", 0)
    if calls is None or not steps:
        return None
    return calls / steps
