"""The catalogue posterior kernel's share of its roofline, in percent: the
least time the card needs for one ``lnpost_batch`` call's work at the walk's
shape (counted by ``portbench.work`` from the call's points, with the rows
their corners touch found by the reference's own cell search) over the
kernel's device time a call."""

from portbench import work

CATALOG_KERNEL = "catalog_lnlike"


def read(ctx):
    seconds, launches = ctx.lnpost_trace.kernel_s(CATALOG_KERNEL)
    if not launches:
        return None
    x = ctx.walk_x
    nb = len(ctx.cfg["bands"])
    bound = work.bound_s(*work.catalog_work(x, ctx.tables, nb, ctx.terms, x.element_size()), x.dtype)[0]
    return 100.0 * bound / (seconds / launches)
