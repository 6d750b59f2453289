"""Host milliseconds to issue one four-card cluster posterior call's shards:
for each call of the traced window (the benchmark's ``lnpost_batch`` span),
the summed host time of the ``isochrones_torch.cluster.shard`` spans inside
it; the median over the calls. A program without the span reads nothing."""

import numpy as np

from portbench import spans
from portbench.trace import SPAN

CALL = SPAN + "lnpost_batch"


def read(ctx):
    tr = ctx.trace
    tab = spans.table(tr)
    idx = [i for i, n in enumerate(tr.cpu_name) if n == CALL]
    if "cluster.shard" not in tab or not idx:
        return None
    s, e = tab["cluster.shard"]
    order = np.argsort(tr.cpu_start[idx], kind="stable")
    call_s, call_e = tr.cpu_start[idx][order], tr.cpu_end[idx][order]
    call = spans.covering(call_s, call_e, s)
    ok = call >= 0
    per_call = np.bincount(call[ok], weights=(e[ok] - s[ok]) * 1e-6, minlength=call_s.size)
    return float(np.median(per_call))
