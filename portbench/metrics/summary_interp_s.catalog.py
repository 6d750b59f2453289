"""Host seconds of the summary's derived interpolation and its read-back (the
``isochrones_torch.summary.derived_interp`` span) in the traced catalogue
fit."""

from portbench import spans


def read(ctx):
    d = spans.durations_s(spans.table(ctx.trace), "summary.derived_interp")
    return float(d.sum()) if d.size else None
