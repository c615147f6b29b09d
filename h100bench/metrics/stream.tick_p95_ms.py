"""The 95th percentile of the host's wall time of ``StreamingServer.tick``
over every tick of the window (host clock around each call)."""

import numpy as np


def read(ctx):
    ticks = ctx.host.get("tick_s")
    if not ticks:
        return None
    return float(np.percentile(np.asarray(ticks) * 1e3, 95))
