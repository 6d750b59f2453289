"""The cluster kernel's share of the card's busy time in the traced window:
its launches' device time over the union of every device event's interval."""

CLUSTER_KERNEL = "cluster_marginal"


def read(ctx):
    busy = ctx.trace.busy_s
    seconds, launches = ctx.trace.kernel_s(CLUSTER_KERNEL)
    return seconds / busy if launches and busy > 0 else None
