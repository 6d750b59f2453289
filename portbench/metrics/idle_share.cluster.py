"""The card's idle share in the cluster cell's traced window: 1 - the union
of the device events' intervals over the window."""


def read(ctx):
    return 1.0 - ctx.trace.busy_s / ctx.trace.window_s if ctx.trace.window_s > 0 else None
