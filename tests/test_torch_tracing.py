"""The port's spans (``isochrones_torch.tracing``) on the CPU.

A span is a ``torch.profiler.record_function`` named ``isochrones_torch.<name>``
while a profiler records, and one shared no-op context otherwise. Under the
profiler the family sampler, the catalogue fit and its summary open their
spans in the counts and the nesting the benchmark's readers rely on
(``portbench/spans.py``), and a fit is bitwise the fit without a profiler.
"""

import contextlib

import numpy as np
import pytest
import torch

from isochrones_torch import StarCatalog, get_ichrone, tracing
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.samplers.nested import run_nested, run_nested_vmapped
from isochrones_torch.summary import summarize_batch

SIGMA = 0.05
CENTERS = np.array([[0.35, 0.6], [0.5, 0.45], [0.62, 0.4]])  # three problems in the unit square
#: a hard cap of 384 dead points at 32 live: a chunk of 256 and a short one of
#: 128 (min_ess keeps the run to the cap)
FAMILY = dict(n_live=32, n_batch=8, n_chains=4, n_repeat=6, max_iter=384, min_ess=1e6, seed=5, device="cpu")
BANDS = ("J", "H", "K")
TRUTHS = np.array([[40.0, 8.6, -0.3, 150.0, 0.05], [55.0, 9.0, 0.0, 200.0, 0.1], [70.0, 9.3, 0.2, 300.0, 0.2],
                   [60.0, 8.8, -0.1, 250.0, 0.15]])
CATALOG_FIT = dict(n_live_points=32, n_batch=8, n_chains=4, n_repeat=4, max_iter=64, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the small tensors of these tests run several times
    faster than with a pool of threads, and the test workers share the
    host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def traced(fn):
    """``(fn(), {span name less the prefix: [(start, end) in us, ...] by
    start})`` under a CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            spans.setdefault(e.name[len(tracing.PREFIX):], []).append((e.time_range.start, e.time_range.end))
    return out, {k: sorted(v) for k, v in spans.items()}


def inside(inner, outer):
    """For each span of ``inner``, how many spans of ``outer`` hold it."""
    return [sum(a <= s and e <= b for a, b in outer) for s, e in inner]


def lnlike_fam(centers, u):
    """(M, B, 2) unit-cube points -> (M, B): problem m's Gaussian about
    centers[m]."""
    return -0.5 * (((u - centers[:, None, :]) / SIGMA) ** 2).sum(-1)


def _family_fit():
    u0 = np.random.default_rng(11).random((len(CENTERS), FAMILY["n_live"], 2))
    c = torch.as_tensor(CENTERS, dtype=torch.float64)
    return run_nested_vmapped(lnlike_fam, c, u0, lnlike_fam(c, torch.as_tensor(u0)).numpy(), **FAMILY)


@pytest.fixture(scope="module")
def family():
    """The family fit without and with the profiler, and the spans."""
    plain = _family_fit()
    out, spans = traced(_family_fit)
    return plain, out, spans


@pytest.fixture(scope="module")
def catalog():
    """A four-star catalogue of observations at the truths (the port's own
    interpolation) on the small synthetic grid: the fit without and with the
    profiler, their spans, and the fitter."""
    iso = get_ichrone("synthetic", device="cpu", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    Teff, logg, _, mags = iso.interp_mag([TRUTHS[:, i] for i in range(5)], list(BANDS))
    cols = {f"{b}_mag": np.asarray(mags)[:, i] for i, b in enumerate(BANDS)}
    cols.update({f"{b}_mag_unc": np.full(len(TRUTHS), 0.02) for b in BANDS})
    cols.update(Teff=np.asarray(Teff), Teff_unc=np.full(len(TRUTHS), 80.0), logg=np.asarray(logg),
                logg_unc=np.full(len(TRUTHS), 0.05), parallax=1000.0 / TRUTHS[:, 3],
                parallax_unc=np.full(len(TRUTHS), 0.05))

    def fit():
        fitter = BatchStarFitter(iso, StarCatalog(dict(cols), bands=BANDS), bands=BANDS)
        return fitter, fitter.fit_multinest(**CATALOG_FIT)

    plain = fit()
    (fitter, out), spans = traced(fit)
    return plain, (fitter, out), spans


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = tracing.span("nested.step"), tracing.span("summary.derived_interp")
    assert a is b and isinstance(a, contextlib.nullcontext)


def test_span_records_its_prefixed_name_under_a_profiler():
    def work():
        with tracing.span("catalog.lnpost"):
            return torch.ones(3).sum()

    _, spans = traced(work)
    assert tracing.PREFIX == "isochrones_torch."
    assert list(spans) == ["catalog.lnpost"] and len(spans["catalog.lnpost"]) == 1


def test_span_is_the_no_op_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(tracing, "_capturing", lambda: True)

    def work():
        return tracing.span("nested.walk_step")

    got, spans = traced(work)
    assert isinstance(got, contextlib.nullcontext) and spans == {}


def test_graphed_family_spans(monkeypatch):
    """With a stand-in for the CUDA graph (its replays open no span, as a
    graph's do not): every step keeps its span, each replayed step holds one
    replay span, the capture one capture span inside the second step, and
    only the eager first step has walk steps."""
    import isochrones_torch.samplers.nested as tn

    def capture(body, g):
        def replay():
            with pytest.MonkeyPatch.context() as m:
                m.setattr(tracing, "_capturing", lambda: True)
                return body()
        return replay

    monkeypatch.setattr(tn, "_graphed", lambda device, mesh: mesh is None)
    monkeypatch.setattr(tn, "_capture", capture)
    out, spans = traced(_family_fit)
    steps = spans["nested.step"]
    assert len(steps) * FAMILY["n_batch"] == out["n_dead"] == FAMILY["max_iter"]
    assert len(spans["nested.replay"]) == len(steps) - 1
    assert inside(spans["nested.replay"], steps) == [1] * (len(steps) - 1)
    assert inside(spans["nested.capture"], steps[1:2]) == [1]
    assert inside(spans["nested.walk_step"], steps[:1]) == [1] * FAMILY["n_repeat"]
    assert len(spans["nested.walk_step"]) == FAMILY["n_repeat"]


@pytest.mark.parametrize("check", ["walk_steps", "steps", "run", "weights", "chunks"])
def test_family_span_counts(family, check):
    _, out, spans = family
    n = {k: len(v) for k, v in spans.items()}
    if check == "walk_steps":
        assert n["nested.walk_step"] == n["nested.step"] * FAMILY["n_repeat"]
    elif check == "steps":
        assert n["nested.step"] * FAMILY["n_batch"] == out["n_dead"] == FAMILY["max_iter"]
    elif check == "run":
        assert n["nested.run"] == 1
    elif check == "weights":
        assert n["nested.weights"] == 1
        (ws, we), = spans["nested.weights"]
        assert all(e <= ws for _, e in spans["nested.chunk"])  # after the last chunk
    else:
        assert n["nested.chunk"] == n["nested.readback"] == n["nested.evidence"] == 2
        # each chunk's steps, then its read-back, then its evidence
        per_chunk = [sum(a <= s and e <= b for s, e in spans["nested.step"]) for a, b in spans["nested.chunk"]]
        assert per_chunk == [32, 16]
        for (_, c_end), (r_start, r_end), (e_start, _) in zip(spans["nested.chunk"], spans["nested.readback"],
                                                               spans["nested.evidence"]):
            assert c_end <= r_start and r_end <= e_start


def test_family_spans_nest(family):
    _, _, spans = family
    assert inside(spans["nested.walk_step"], spans["nested.step"]) == [1] * len(spans["nested.walk_step"])
    assert inside(spans["nested.step"], spans["nested.chunk"]) == [1] * len(spans["nested.step"])
    for name in ("nested.chunk", "nested.readback", "nested.evidence", "nested.weights"):
        assert inside(spans[name], spans["nested.run"]) == [1] * len(spans[name]), name
    assert set(spans) == {"nested.run", "nested.chunk", "nested.readback", "nested.evidence", "nested.step",
                          "nested.walk_step", "nested.weights"}


def test_single_run_spans():
    """A single run steps as a family of one: the same chunk, read-back,
    evidence, step and walk-step spans as the family's, nested alike."""
    g = torch.Generator()
    g.manual_seed(5)
    kw = {k: FAMILY[k] for k in ("n_live", "n_batch", "n_chains", "n_repeat", "max_iter", "min_ess")}
    out, spans = traced(lambda: run_nested(lambda x: -0.5 * (((x - 0.5) / SIGMA) ** 2).sum(-1), lambda u: u, 2, g,
                                           rng=5, **kw))
    n = {k: len(v) for k, v in spans.items()}
    assert n["nested.step"] * FAMILY["n_batch"] == out.n_iter == FAMILY["max_iter"]
    assert n["nested.walk_step"] == n["nested.step"] * FAMILY["n_repeat"]
    assert n["nested.chunk"] == n["nested.readback"] == n["nested.evidence"] == 2
    assert inside(spans["nested.walk_step"], spans["nested.step"]) == [1] * n["nested.walk_step"]
    assert inside(spans["nested.step"], spans["nested.chunk"]) == [1] * n["nested.step"]


@pytest.mark.parametrize("engine", ["family", "catalog"])
def test_a_fit_is_bitwise_the_fit_without_a_profiler(family, catalog, engine):
    if engine == "family":
        plain, out, _ = family
        for k in ("samples_u", "logz", "logzerr", "lnl"):
            np.testing.assert_array_equal(plain[k], out[k])
        assert plain["n_dead"] == out["n_dead"]
    else:
        (f0, o0), (f1, o1), _ = catalog
        np.testing.assert_array_equal(f0.samples, f1.samples)
        np.testing.assert_array_equal(f0._lnprob, f1._lnprob)
        np.testing.assert_array_equal(o0["logz"], o1["logz"])
        assert o0["n_dead"] == o1["n_dead"] == CATALOG_FIT["max_iter"]


def test_catalog_walk_steps_hold_one_posterior_call_each(catalog):
    _, (_, out), spans = catalog
    walk, lnpost = spans["nested.walk_step"], spans["catalog.lnpost"]
    assert len(walk) == out["n_dead"] // CATALOG_FIT["n_batch"] * CATALOG_FIT["n_repeat"]
    assert inside(walk, lnpost) == [0] * len(walk)
    held = [sum(a <= s and e <= b for s, e in lnpost) for a, b in walk]
    assert held == [1] * len(walk)
    # the other posterior calls are the start's, before the run
    (st_start, st_end), = spans["catalog.start"]
    (run_start, _), = spans["nested.run"]
    rest = [s for s in lnpost if not any(a <= s[0] and s[1] <= b for a, b in walk)]
    assert rest and all(st_start <= s and e <= st_end for s, e in rest) and st_end <= run_start


def test_summary_spans_once_in_order(catalog):
    _, (fitter, _), _ = catalog
    summary, spans = traced(lambda: summarize_batch(fitter, qs=(0.16, 0.5, 0.84), derived=True,
                                                    max_derived_draws=50))
    assert "mass_50" in summary and "eep_50" in summary
    order = ["summary.param_quantiles", "summary.derived_interp", "summary.derived_quantiles"]
    assert sorted(spans) == sorted(order) and all(len(spans[k]) == 1 for k in order)
    bounds = [spans[k][0] for k in order]
    assert all(bounds[i][1] <= bounds[i + 1][0] for i in range(2))
