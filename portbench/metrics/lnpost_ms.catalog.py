"""Milliseconds of ``BatchStarFitter.lnpost_batch`` at the walk's shape
(every star, the walk's points of the traced fit's draws), CUDA events over
many calls."""


def read(ctx):
    return ctx.lnpost_ms
