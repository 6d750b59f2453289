"""Median host milliseconds of one walk step of the nested sampler (the
``isochrones_torch.nested.walk_step`` span: the proposal, one posterior call
over every star, the acceptance) in the traced catalogue fit."""

import numpy as np

from portbench import spans


def read(ctx):
    d = spans.durations_s(spans.table(ctx.trace), "nested.walk_step")
    return float(np.median(d)) * 1e3 if d.size else None
