"""The cluster kernel's share of its roofline in the four-card cell, in
percent: ``cluster_kernel_roofline``'s reading on this cell's traced window.
Its work is counted for the call's 200 members and its time is the kernel's
launches of the window's first calls summed over the four cards, so this is
the efficiency of one card's launch, comparable with the one-card cell's."""

from portbench import run


def read(ctx):
    return run.read_metric("cluster_kernel_roofline", ctx)
