"""Device milliseconds a four-card cluster posterior call spends in copies
between cards (the walkers out to the other cards, the partial sums back to
the first): the traced window's device events named as peer-to-peer copies
("Memcpy PtoP"), summed over every card, over the window's calls."""

PEER_COPY = "Memcpy PtoP"


def read(ctx):
    seconds, launches = ctx.trace.kernel_s(PEER_COPY)
    return seconds * 1e3 / ctx.n_calls if launches and ctx.n_calls else None
