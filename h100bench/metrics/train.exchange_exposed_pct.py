"""Share of the traced window in which an NCCL kernel runs on rank 0's card
and no other kernel, copy or set does: the gradient and statistics exchange,
with the wait on the other ranks, that compute does not hide
(``stages.exposed_us``)."""

from h100bench.stages import exposed_us


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    exposed = exposed_us(tr, "nccl")
    return None if exposed is None else 100.0 * exposed * 1e-6 / tr.window_s
