"""The cluster kernel's share of its roofline, in percent: the least time
the card needs for the work of the traced window's first calls (counted by
``portbench.work`` on the reference's own ladder rows at those calls'
walkers) over the device time of those calls' launches of the kernel."""

from portbench import work
from portbench.reference import cluster as ref

CLUSTER_KERNEL = "cluster_marginal"
#: calls whose work is counted
CALLS = 4


def read(ctx):
    times = ctx.trace.kernel_durations_s(CLUSTER_KERNEL)
    if not times or len(times) % ctx.n_calls:
        return None
    per_call = len(times) // ctx.n_calls
    k = min(CALLS, ctx.n_calls)
    cfg, tables = ctx.cfg, ctx.tables
    S, B = ctx.n_stars, len(cfg["bands"])
    bound = 0.0
    for p in ctx.walkers[:k]:
        masses, _, _, finite, valid = ref.ladder_rows(p, tables, cfg)
        eeps = ref.ladder(cfg, p.dtype, p.device)
        cells = work.cluster_cells(masses, finite, valid, eeps, cfg["model"]["minq"])
        bound += work.bound_s(*work.cluster_work(cells, p.shape[0], S, eeps.shape[0], B, p.element_size()),
                              p.dtype)[0]
    return 100.0 * bound / sum(times[:k * per_call])
