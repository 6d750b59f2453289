"""Device operations (kernels, copies, fills) a cluster posterior call
launches: the traced window's device events over its calls. The window
issues the program's calls alone (the walkers are drawn in set-up)."""


def read(ctx):
    return ctx.trace.n_device_events / ctx.n_calls if ctx.n_calls else None
