"""Host seconds of the summary's quantiles (the
``isochrones_torch.summary.param_quantiles`` and ``summary.derived_quantiles``
spans) in the traced catalogue fit."""

from portbench import spans


def read(ctx):
    tab = spans.table(ctx.trace)
    d = [spans.durations_s(tab, n) for n in ("summary.param_quantiles", "summary.derived_quantiles")]
    return float(sum(x.sum() for x in d)) if any(x.size for x in d) else None
