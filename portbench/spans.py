"""The program's own spans in a traced window: the ``isochrones_torch.<name>``
events of the profiler's host timeline, as ``isochrones_torch/tracing.py``
opens them around the program's layers.

Spans of one name never overlap (none of them recurses) and spans of
different names nest, so the span of one name that covers a moment is the last
of that name to start before it, and the innermost span that covers a moment
is, of those, the one that started last. Where the program has no spans (a
version before they existed), every reader here finds nothing.
"""

from __future__ import annotations

import numpy as np

PREFIX = "isochrones_torch."
_EMPTY = np.zeros(0, dtype=np.int64)


def table(trace):
    """``{name less the prefix: (starts, ends) in ns, by start}`` of the
    program's spans in a traced window (``trace.Trace``'s host events)."""
    rows = {}
    for i, n in enumerate(trace.cpu_name):
        if n.startswith(PREFIX):
            rows.setdefault(n[len(PREFIX):], []).append(i)
    out = {}
    for name, idx in rows.items():
        s, e = trace.cpu_start[idx], trace.cpu_end[idx]
        order = np.argsort(s, kind="stable")
        out[name] = (s[order], e[order])
    return out


def durations_s(tab, name):
    """Each span ``name``'s host seconds, by start."""
    s, e = tab.get(name, (_EMPTY, _EMPTY))
    return (e - s) * 1e-9


def covering(starts, ends, points):
    """For spans of one name (by start, none overlapping), the index of the
    span that covers each point (start <= point <= end), or -1."""
    points = np.asarray(points, dtype=np.int64)
    if starts.size == 0:
        return np.full(points.shape, -1)
    i = np.searchsorted(starts, points, side="right") - 1
    return np.where((i >= 0) & (ends[np.maximum(i, 0)] >= points), i, -1)


def innermost(tab, points):
    """For each point (ns), the name of the innermost program span that covers
    it, or None where none does."""
    points = np.asarray(points, dtype=np.int64)
    best = np.full(points.shape, -1)
    best_start = np.full(points.shape, np.iinfo(np.int64).min)
    best_len = np.zeros(points.shape, dtype=np.int64)
    found = sorted(tab)
    for k, name in enumerate(found):
        s, e = tab[name]
        i = covering(s, e, points)
        j = np.maximum(i, 0)
        start, length = s[j], e[j] - s[j]
        # the later start is inside; at a tie of starts, the shorter span
        inner = (i >= 0) & ((start > best_start) | ((start == best_start) & (length < best_len)))
        best = np.where(inner, k, best)
        best_start = np.where(inner, start, best_start)
        best_len = np.where(inner, length, best_len)
    return [found[k] if k >= 0 else None for k in best]


def idle_s_under(trace, prefix):
    """Seconds of every idle gap of the card in the window whose middle's
    innermost program span is named ``prefix...``; None where the window holds
    no program span."""
    tab = table(trace)
    if not tab:
        return None
    gs, ge = trace.gaps()
    inner = innermost(tab, (gs + ge) // 2)
    sel = np.array([n is not None and n.startswith(prefix) for n in inner], dtype=bool)
    return float((ge[sel] - gs[sel]).sum()) * 1e-9


def inside_s(tab, name, outer):
    """Host seconds of each span ``name`` that lies inside a span ``outer``."""
    s, e = tab.get(name, (_EMPTY, _EMPTY))
    o_s, o_e = tab.get(outer, (_EMPTY, _EMPTY))
    i = covering(o_s, o_e, s)
    ok = i >= 0
    ok[ok] = o_e[i[ok]] >= e[ok]
    return (e[ok] - s[ok]) * 1e-9
