"""Share of the traced window with no kernel, copy or set on the card: one
minus the union of the device's operation intervals over the window."""


def read(ctx):
    return ctx.idle_pct()
