"""The share of the nested sampler's steps replayed as one CUDA graph in the
traced catalogue fit: the count of ``isochrones_torch.nested.replay`` spans
over the count of ``isochrones_torch.nested.step`` spans. None where the trace
has no step span (a program without them)."""

from portbench import spans


def read(ctx):
    tab = spans.table(ctx.trace)
    steps = spans.durations_s(tab, "nested.step").size
    return spans.durations_s(tab, "nested.replay").size / steps if steps else None
