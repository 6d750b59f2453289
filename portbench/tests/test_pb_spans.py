"""``portbench/spans.py`` and the readers of the program's spans.

First on hand-built windows whose answers are exact (innermost-span
attribution of idle gaps, durations, spans inside spans, a gap no program span
covers, a window without program spans); then the six readers on a tiny traced
catalogue fit on the CPU, and on a traced window of a program without spans,
where each finds nothing."""

import math
import types

import numpy as np
import pytest
import torch

from portbench import run, spans
from portbench.drivers import catalog_fit
from portbench.trace import Trace, profiled, window

P = spans.PREFIX
READERS = ("sampler_idle_s.catalog", "walk_step_ms.catalog", "weights_s.catalog", "lnpost_host_ms.catalog",
           "summary_interp_s.catalog", "summary_host_s.catalog")


def hand_trace(events, gaps):
    """A window of host events ``(name, start, end)`` in ns and idle gaps
    ``(start, end)``, with the fields of ``trace.Trace`` that the readers use."""
    gs = np.array([g[0] for g in gaps], dtype=np.int64)
    ge = np.array([g[1] for g in gaps], dtype=np.int64)
    return types.SimpleNamespace(cpu_name=[e[0] for e in events],
                                 cpu_start=np.array([e[1] for e in events], dtype=np.int64),
                                 cpu_end=np.array([e[2] for e in events], dtype=np.int64), gaps=lambda: (gs, ge))


#: a run with one chunk of one step of two walk steps (each with a posterior
#: call, the first with an aten op inside), the weights, then a summary after
#: the run; events listed out of order
EVENTS = [(P + "nested.walk_step", 40, 48), (P + "nested.run", 0, 100), (P + "nested.chunk", 10, 60),
          (P + "nested.step", 20, 50), (P + "nested.walk_step", 25, 35), (P + "catalog.lnpost", 28, 32),
          ("aten::add", 29, 31), (P + "catalog.lnpost", 42, 44), (P + "nested.weights", 70, 90),
          (P + "summary.param_quantiles", 110, 130), ("portbench.fit_multinest", 0, 105)]
#: gap middles 28 (a posterior call), 37 (the step), 43 (a posterior call in
#: the second walk step), 46 (that walk step), 80 (the weights), 97 (the run),
#: 103 (no program span), 115 (the summary)
GAPS = [(27, 29), (36, 38), (42, 44), (45, 47), (75, 85), (95, 99), (101, 105), (112, 118)]


def test_innermost_span_of_each_gap():
    tr = hand_trace(EVENTS, GAPS)
    tab = spans.table(tr)
    gs, ge = tr.gaps()
    assert spans.innermost(tab, (gs + ge) // 2) == ["catalog.lnpost", "nested.step", "catalog.lnpost",
                                                    "nested.walk_step", "nested.weights", "nested.run", None,
                                                    "summary.param_quantiles"]
    # the ends are inside; past the run's end no span covers
    assert spans.innermost(tab, [0, 25, 35, 100, 101]) == ["nested.run", "nested.walk_step", "nested.walk_step",
                                                           "nested.run", None]


def test_idle_seconds_under_the_sampler():
    tr = hand_trace(EVENTS, GAPS)
    # the step's 2, the walk step's 2, the weights' 10 and the run's 4 ns; not
    # the posterior calls', the uncovered gap's or the summary's
    assert spans.idle_s_under(tr, "nested.") == pytest.approx(18e-9, rel=0, abs=1e-18)
    assert spans.idle_s_under(tr, "catalog.") == pytest.approx(4e-9, rel=0, abs=1e-18)
    assert spans.idle_s_under(tr, "summary.") == pytest.approx(6e-9, rel=0, abs=1e-18)


def test_a_tie_of_starts_goes_to_the_shorter_span():
    tr = hand_trace([(P + "nested.chunk", 10, 60), (P + "nested.step", 10, 50), (P + "nested.run", 10, 70)], [])
    assert spans.innermost(spans.table(tr), [10, 30, 55, 65, 71]) == ["nested.step", "nested.step",
                                                                      "nested.chunk", "nested.run", None]


def test_durations_and_spans_inside_spans():
    tab = spans.table(hand_trace(EVENTS + [(P + "catalog.lnpost", 2, 7)], GAPS))
    np.testing.assert_allclose(spans.durations_s(tab, "nested.walk_step"), [10e-9, 8e-9], rtol=0, atol=1e-18)
    np.testing.assert_allclose(spans.durations_s(tab, "catalog.lnpost"), [5e-9, 4e-9, 2e-9], rtol=0, atol=1e-18)
    np.testing.assert_allclose(spans.inside_s(tab, "catalog.lnpost", "nested.walk_step"), [4e-9, 2e-9], rtol=0,
                               atol=1e-18)
    assert spans.inside_s(tab, "catalog.lnpost", "nested.absent").size == 0
    assert spans.durations_s(tab, "nested.absent").size == 0


def test_a_window_without_program_spans_reads_nothing():
    tr = hand_trace([("portbench.fit_multinest", 0, 100), ("aten::add", 10, 20)], [(30, 40)])
    assert spans.table(tr) == {}
    assert spans.innermost(spans.table(tr), [35]) == [None]
    assert spans.idle_s_under(tr, "nested.") is None
    ctx = types.SimpleNamespace(trace=tr, fit={})
    assert [run.read_metric(m, ctx) for m in READERS] == [None] * len(READERS)


def test_readers_on_a_traced_catalogue_fit(tiny_cell):
    _, _, cfg, traffic = tiny_cell("catalog4096.nested")
    torch.set_num_threads(1)
    state = catalog_fit.setup(cfg, traffic, 2 ** 31 + 977, torch.device("cpu"))
    with profiled() as prof:
        with window():
            rec = catalog_fit._fit(state, nested=dict(max_iter=64))
    tr = Trace(prof)
    ctx = types.SimpleNamespace(trace=tr, fit=rec)
    got = {m: run.read_metric(m, ctx) for m in READERS}
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got["sampler_idle_s.catalog"] <= tr.window_s - tr.busy_s + 1e-9
    n = {k: len(s) for k, (s, _) in spans.table(tr).items()}
    assert n["nested.walk_step"] == rec["n_dead"] // traffic["nested"]["n_batch"] * traffic["nested"]["n_repeat"]
    assert n["nested.run"] == n["nested.weights"] == n["summary.derived_interp"] == 1
