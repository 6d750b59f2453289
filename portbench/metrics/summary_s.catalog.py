"""Seconds of ``summarize_batch`` (parameter quantiles, the derived
columns' interpolation and quantiles) in the traced fit, by the host clock."""


def read(ctx):
    return ctx.fit["summary_s"]
