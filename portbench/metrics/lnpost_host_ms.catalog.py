"""Median host milliseconds to launch one catalogue posterior call inside a
walk step (an ``isochrones_torch.catalog.lnpost`` span within a
``nested.walk_step``: the call's preparation and kernel E's launch) in the
traced catalogue fit; beside ``lnpost_ms.catalog``, the call's device time."""

import numpy as np

from portbench import spans


def read(ctx):
    d = spans.inside_s(spans.table(ctx.trace), "catalog.lnpost", "nested.walk_step")
    return float(np.median(d)) * 1e3 if d.size else None
