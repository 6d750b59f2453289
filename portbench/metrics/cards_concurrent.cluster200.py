"""Cards busy at once in the four-card cluster cell's traced window: the sum
of every card's busy seconds (the union of its own device intervals) over
the seconds in which any card is busy. 1.0 when the shards run one after
another, the number of cards when they all run at once."""


def read(ctx):
    return ctx.trace.concurrency() if ctx.trace.n_device_events else None
