"""The mean card's idle share in the four-card cluster cell's traced window:
1 - the mean over the mesh's cards of each card's busy seconds (the union of
its own device intervals) over the window."""


def read(ctx):
    tr = ctx.trace
    return 1.0 - tr.busy_s / tr.window_s if tr.n_device_events and tr.window_s > 0 else None
