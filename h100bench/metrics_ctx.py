"""What a per-layer metric's reader gets: the run's counts, host timings, the
reduced trace of the window, the model FLOPs of the plain reference, and the
yardstick's arithmetic. A reader returns a number, or None where it finds
nothing to read; it never returns 0 for a share of a roofline or of a peak."""

from __future__ import annotations

from . import costs


class Context:
    def __init__(self, cell, cfg, mix, out):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.counts = out["counts"]
        self.host = out["host"]
        self.trace = out["trace"]
        self.model_flops = out.get("model_flops", {})
        self.costs = costs

    @property
    def hp(self):
        return self.cfg["hparams"]

    def share(self, flops: float, nbytes: float, kernels) -> float:
        """Percent of the least time for ``flops`` and ``nbytes`` over the
        device time of ``kernels`` in the window; None where they did not run."""
        seconds = self.trace.kernel_s(kernels) if self.trace is not None else 0.0
        if seconds <= 0:
            return None
        return 100.0 * costs.least_seconds(flops, nbytes) / seconds

    def idle_pct(self):
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)


def summed(cost, rows: int, launches: int, *shape):
    """(flops, bytes) of ``launches`` launches that together take ``rows``
    rows: FLOPs grow with the rows, and each launch reads the weights again."""
    flops, nbytes = cost(rows, *shape)
    _, fixed = cost(0, *shape)
    return flops, nbytes + max(launches - 1, 0) * fixed
