"""One traced window over the cards of a mesh: ``trace.Trace`` with each
device event's card kept.

A card's busy time is the union of its own events' intervals inside the
window. ``busy_s`` is the mean over the mesh's cards of each card's busy
seconds, so ``1 - busy_s / window_s`` is the idle share of the mean card (a
card with no event counts as idle throughout). ``any_busy_s`` is the union
over every card: the seconds in which at least one card is busy, and
``concurrency()`` the sum of the cards' busy seconds over it (1.0 when the
cards take turns, the number of cards when they all run at once). Idle gaps
(``gaps``, ``idle_gaps``) are the stretches in which no card is busy, each
named by the innermost host event that covers its middle. ``device_ops``
sums each operation's device time over every card.
"""

from __future__ import annotations

import numpy as np
import torch

from .trace import SPAN, Trace, _union


class MeshTrace(Trace):
    """The events of one profiled window on ``cards`` (the CUDA device
    indices of the mesh's distinct devices)."""

    def __init__(self, prof, cards):
        super().__init__(prof)
        index = []
        for e in prof.profiler.kineto_results.events():  # the device events Trace kept, in its order
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation() or e.name().startswith(SPAN):
                continue
            if e.start_ns() + e.duration_ns() > self.t0 and e.start_ns() < self.t1:
                index.append(e.device_index())
        if len(index) != len(self.dev_name):
            raise RuntimeError(f"{len(index)} device indices for {len(self.dev_name)} device events")
        self.dev_index = np.array(index, dtype=np.int64)
        self.cards = tuple(int(c) for c in cards)

    def card_busy_s(self):
        """``{card: seconds}``: the union of each card's own intervals."""
        out = {}
        for c in self.cards:
            sel = self.dev_index == c
            s, e = _union(self.dev_start[sel], self.dev_end[sel])
            out[c] = float((e - s).sum()) * 1e-9
        return out

    @property
    def busy_s(self) -> float:
        return sum(self.card_busy_s().values()) / len(self.cards) if self.cards else 0.0

    @property
    def any_busy_s(self) -> float:
        return float((self.busy_end - self.busy_start).sum()) * 1e-9

    def concurrency(self):
        """Cards busy at once on average over the seconds in which any card
        is busy; None when none is."""
        any_busy = self.any_busy_s
        return sum(self.card_busy_s().values()) / any_busy if any_busy > 0 else None
