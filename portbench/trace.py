"""One traced window: ``torch.profiler`` over the card, read into arrays.

The window is the span of a ``record_function`` named :data:`WINDOW` that
the driver opens around the traced work and closes after a synchronise.
Device-busy time is the union of the device events' intervals inside the
window, so kernels that overlap are counted once; idle gaps are the
stretches between them, each named by the innermost host event that covers
its middle (what the host was doing while the card had nothing to run).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

#: the prefix of the benchmark's spans, and the traced window's span
SPAN = "portbench."
WINDOW = SPAN + "window"
#: gaps attributed to host events, longest first
ATTRIBUTED_GAPS = 500


def profiled():
    """The profiler context for a traced window (host and device events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def span(name):
    """A span of the benchmark's own around a call into a layer of the program."""
    return torch.profiler.record_function(SPAN + name)


@contextlib.contextmanager
def window():
    """The traced window's span; ends with a synchronise inside it."""
    with torch.profiler.record_function(WINDOW):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _union(starts, ends):
    """Merged intervals ``(starts, ends)`` of possibly overlapping ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return s[first], reach[last]


class Trace:
    """The device and host events of one profiled window, in nanoseconds of
    the profiler's clock."""

    def __init__(self, prof):
        dev, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                cpu.append(rec)
            elif not (e.is_user_annotation() or rec[2].startswith(SPAN)):  # a span's copy on the device's timeline
                dev.append(rec)
        spans = [r for r in cpu if r[2] == WINDOW]
        if not spans:
            raise RuntimeError("the trace has no window span")
        self.t0, self.t1 = spans[0][0], spans[0][1]
        dev = [r for r in dev if r[1] > self.t0 and r[0] < self.t1]
        self.dev_start = np.array([max(r[0], self.t0) for r in dev], dtype=np.int64)
        self.dev_end = np.array([min(r[1], self.t1) for r in dev], dtype=np.int64)
        self.dev_name = [r[2] for r in dev]
        cpu = [r for r in cpu if r[2] != WINDOW and r[1] > self.t0 and r[0] < self.t1]
        self.cpu_start = np.array([r[0] for r in cpu], dtype=np.int64)
        self.cpu_end = np.array([r[1] for r in cpu], dtype=np.int64)
        self.cpu_name = [r[2] for r in cpu]
        self.busy_start, self.busy_end = _union(self.dev_start, self.dev_end)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return float((self.busy_end - self.busy_start).sum()) * 1e-9

    @property
    def n_device_events(self) -> int:
        return len(self.dev_name)

    def kernel_s(self, part):
        """Device seconds and launches of the events whose name holds ``part``."""
        sel = np.array([part in n for n in self.dev_name], dtype=bool)
        if not sel.any():
            return 0.0, 0
        return float((self.dev_end[sel] - self.dev_start[sel]).sum()) * 1e-9, int(sel.sum())

    def kernel_durations_s(self, part):
        """Each launch's device seconds, in launch order, of the events whose
        name holds ``part``."""
        sel = [i for i, n in enumerate(self.dev_name) if part in n]
        sel.sort(key=lambda i: self.dev_start[i])
        return [(self.dev_end[i] - self.dev_start[i]) * 1e-9 for i in sel]

    def device_ops(self, top=10):
        """``[[name, seconds], ...]``: the device operations that took most time."""
        tot = {}
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            tot[n] = tot.get(n, 0) + int(e - s)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v * 1e-9] for n, v in best]

    def gaps(self):
        """Idle stretches ``(starts, ends)`` of the card inside the window."""
        edges_s = np.concatenate([[self.t0], self.busy_end])
        edges_e = np.concatenate([self.busy_start, [self.t1]])
        keep = edges_e > edges_s
        return edges_s[keep], edges_e[keep]

    def idle_gaps(self, top=10):
        """``[[host event, seconds], ...]``: idle time of the card by what the
        host was doing, over the longest gaps."""
        gs, ge = self.gaps()
        order = np.argsort(-(ge - gs))[:ATTRIBUTED_GAPS]
        dur = self.cpu_end - self.cpu_start
        tot = {}
        for i in order:
            mid = (gs[i] + ge[i]) // 2
            cover = (self.cpu_start <= mid) & (self.cpu_end >= mid)
            name = "host outside any recorded op"
            if cover.any():
                name = self.cpu_name[int(np.argmin(np.where(cover, dur, np.iinfo(np.int64).max)))]
            tot[name] = tot.get(name, 0) + int(ge[i] - gs[i])
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v * 1e-9] for n, v in best]
