"""Launches of the catalogue posterior kernel (one a posterior call) in the
traced whole fit, from the profiler's device events."""

CATALOG_KERNEL = "catalog_lnlike"


def read(ctx):
    launches = ctx.trace.kernel_s(CATALOG_KERNEL)[1]
    return launches or None
