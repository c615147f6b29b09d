"""Device milliseconds of the device-to-host copies (the wire's pinned
download, ``task.HostBuffer``) in the window, per tick."""


def read(ctx):
    ticks = ctx.counts.get("ticks", 0)
    if ctx.trace is None or not ticks:
        return None
    ms = ctx.trace.copy_s("DtoH") * 1e3
    return ms / ticks if ms > 0 else None
