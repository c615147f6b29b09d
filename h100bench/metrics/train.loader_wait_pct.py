"""Share of the window the training loop spent waiting for the reader's next
batch (host clock around the iterator, as ``Trainer._fetch_put`` times it)."""


def read(ctx):
    wait = ctx.host.get("loader_wait_s")
    if wait is None or ctx.trace is None:
        return None
    return 100.0 * wait / ctx.trace.window_s
