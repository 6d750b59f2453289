"""Host seconds of the nested sampler's per-star weights, evidence and
equal-weight resampling (the ``isochrones_torch.nested.weights`` span) in the
traced catalogue fit."""

from portbench import spans


def read(ctx):
    d = spans.durations_s(spans.table(ctx.trace), "nested.weights")
    return float(d.sum()) if d.size else None
