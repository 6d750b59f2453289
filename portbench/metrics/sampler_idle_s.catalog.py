"""Seconds the card sits idle in the traced catalogue fit while the host is
inside the nested sampler: every idle gap of the window (not only the
breakdown's longest) whose middle's innermost ``isochrones_torch.`` span is a
``nested.*`` span."""

from portbench import spans


def read(ctx):
    return spans.idle_s_under(ctx.trace, "nested.")
