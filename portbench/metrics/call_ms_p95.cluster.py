"""95th percentile of a cluster posterior call's milliseconds over the
traced window: the device time between the CUDA events that the window's loop
records after each call (and before the first), with no synchronise."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.call_s) * 1e3, 95)) if ctx.call_s else None
