"""The family nested sampler's step replayed as one CUDA graph, on the card.

Marked ``cuda``: every test skips without a CUDA card. This file imports no
JAX; from the repository root:

    python -m pytest --noconftest -o filterwarnings=error -m cuda tests/test_torch_nested_graph.py

A catalogue of 64 stars on the small synthetic grid (``chip_smoke.catalog_table``
with its holes), fitted as the benchmark's catalogue cell fits (8 dead points
a step, 8 chains, 24 walk steps) at 32 live points for two chunks of 32 steps,
in float64, and in float32 with a round of dynamic threads. The graphed fit is
held bitwise to the same fit with the graph turned off: its checkpoint (dead
points, live set, scales, the generator's state), its draws, their posterior
values and the evidences. The catalogue wrapper's launch counter counts a
replay's launches and not the capture's, so a graphed fit counts the eager
fit's launches.
"""

import logging
import pickle

import numpy as np
import pytest
import torch

from chip_smoke import CAT_BANDS, CLI_EEP_BOX, catalog_table
from isochrones_torch import get_ichrone, tracing
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.ops.catalog_cuda import catalog_lnpost_cuda
from isochrones_torch.parallel import Mesh
from isochrones_torch.samplers import nested

pytestmark = pytest.mark.cuda

_SMALL = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
#: two chunks of 32 steps (256 dead points each at 32 live); the ESS target
#: keeps every star running to the cap
FIT = dict(n_live_points=32, n_batch=8, n_chains=8, n_repeat=24, max_iter=512, min_ess=1e6, seed=5)
STEPS = FIT["max_iter"] // FIT["n_batch"]
#: a float32 fit whose base runs end on the evidence test before the cap, then
#: one round of threads, which replay the same graph
DYNAMIC = dict(dynamic=True, min_ess=150.0, max_iter=2048, max_dynamic_rounds=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def table():
    ic = get_ichrone("synthetic", device="cpu", **_SMALL)
    return catalog_table(ic, 64, (CLI_EEP_BOX[0] / 2, CLI_EEP_BOX[1] / 2), seed=0)[1]


def _fitter(device, table, dtype=torch.float64):
    return BatchStarFitter(get_ichrone("synthetic", device=device, dtype=dtype, **_SMALL), table, bands=CAT_BANDS)


def _fit(fitter, graphs=True, calls=None, **kw):
    """``(the fit's output, the catalogue wrapper's launches)``; with
    ``graphs=False`` every step eager. ``calls``, a dict, counts the captures
    and the replays."""
    with pytest.MonkeyPatch.context() as m:
        if not graphs:
            m.setattr(nested, "_graphed", lambda device, mesh: False)
        if calls is not None:
            m.setattr(nested, "_capture", _counted(nested._capture, calls))
        before = catalog_lnpost_cuda.launches
        out = fitter.fit_multinest(**{**FIT, **kw})
        torch.cuda.synchronize()
    return out, catalog_lnpost_cuda.launches - before


def _counted(capture, calls):
    calls.update(captures=0, replays=0)

    def counted_capture(body, g):
        calls["captures"] += 1
        replay = capture(body, g)

        def counted_replay():
            calls["replays"] += 1
            return replay()
        return counted_replay
    return counted_capture


def _same_fit(a, b):
    (fa, oa), (fb, ob) = a, b
    assert oa["n_dead"] == ob["n_dead"]
    for k in ("logz", "logzerr", "ess", "converged"):
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    np.testing.assert_array_equal(fa.samples, fb.samples)
    np.testing.assert_array_equal(fa._lnprob, fb._lnprob)


def _checkpoint(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_checkpoint(a, b):
    for k in ("dead_u", "dead_lnl", "live_u", "live_lnl", "generator_state", "scale"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["n_dead_total"] == b["n_dead_total"] and a["rng_state"] == b["rng_state"]


@pytest.mark.parametrize("case", ["float64", "float32-dynamic"])
def test_graphed_fit_is_bitwise_the_eager_fit(dev, table, tmp_path, case):
    dtype, kw = (torch.float64, {}) if case == "float64" else (torch.float32, DYNAMIC)
    eager, graphed = _fitter(dev, table, dtype), _fitter(dev, table, dtype)
    out_e, launches_e = _fit(eager, graphs=False, checkpoint=str(tmp_path / "eager.ckpt"), **kw)
    calls = {}
    out_g, launches_g = _fit(graphed, calls=calls, checkpoint=str(tmp_path / "graph.ckpt"), **kw)
    # one capture at the second step; every later step of the base runs and
    # of the threads a replay, which the counter counts as the eager step
    assert calls == dict(captures=1, replays=out_g["n_dead"] // FIT["n_batch"] - 1)
    assert launches_g == launches_e > 0
    if case == "float64":
        assert out_g["n_dead"] == FIT["max_iter"]
    else:
        assert out_g["dynamic_rounds"] == 1
    _same_checkpoint(_checkpoint(tmp_path / "eager.ckpt"), _checkpoint(tmp_path / "graph.ckpt"))
    _same_fit((eager, out_e), (graphed, out_g))


def test_graphed_resume_is_bitwise_the_run_that_never_stopped(dev, table, tmp_path):
    ck = str(tmp_path / "fit.ckpt")
    full = _fitter(dev, table)
    out_full, _ = _fit(full)
    part, _ = _fit(_fitter(dev, table), checkpoint=ck, max_iter=FIT["max_iter"] // 2)
    assert part["n_dead"] == FIT["max_iter"] // 2
    resumed = _fitter(dev, table)
    out_res, _ = _fit(resumed, checkpoint=ck, resume=True)
    _same_fit((full, out_full), (resumed, out_res))


def test_a_likelihood_that_reads_back_falls_back_to_the_eager_run(dev, table, caplog):
    """``.item()`` inside the posterior call cannot be captured: the run
    warns once and goes on eagerly, bitwise the eager run."""
    eager = _fitter(dev, table)
    out_e, launches_e = _fit(eager, graphs=False)
    reading = _fitter(dev, table)

    def lnpost(x, his=None):
        out = BatchStarFitter._lnpost(reading, x, his)
        out.max().item()
        return out

    reading._lnpost = lnpost
    with caplog.at_level(logging.WARNING, logger="isochrones_torch"):
        out_r, launches_r = _fit(reading)
    assert caplog.text.count("could not be captured as a CUDA graph") == 1
    assert launches_r == launches_e  # every step eager; the failed capture counts nothing
    _same_fit((eager, out_e), (reading, out_r))


def test_a_graphed_fit_after_a_failed_capture_still_replays(dev, table):
    """A capture that fails leaves nothing behind in the process: the next
    fit captures, replays every later step and is bitwise the eager fit."""
    eager = _fitter(dev, table)
    out_e, _ = _fit(eager, graphs=False)
    reading = _fitter(dev, table)

    def lnpost(x, his=None):
        out = BatchStarFitter._lnpost(reading, x, his)
        out.max().item()
        return out

    reading._lnpost = lnpost
    failed, calls = {}, {}
    _fit(reading, calls=failed)
    assert failed == dict(captures=1, replays=0)
    graphed = _fitter(dev, table)
    out_g, _ = _fit(graphed, calls=calls)
    assert calls == dict(captures=1, replays=STEPS - 1)
    _same_fit((eager, out_e), (graphed, out_g))


def _spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], acc_events=True) as prof:
        fn()
    names = [e.name[len(tracing.PREFIX):] for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    return {n: names.count(n) for n in set(names)}


@pytest.mark.parametrize("where", ["card", "mesh", "cpu"])
def test_replay_spans_only_on_a_card_without_a_mesh(dev, table, where):
    short = dict(max_iter=64)
    if where == "cpu":
        fitter, kw = _fitter("cpu", table), short
    else:
        fitter = _fitter(dev, table)
        kw = dict(short, mesh=Mesh([dev, dev], ("stars",))) if where == "mesh" else short
    n = _spans(lambda: fitter.fit_multinest(**{**FIT, **kw}))
    assert n["nested.step"] == 8
    if where == "card":
        assert n["nested.replay"] == 7 and n["nested.capture"] == 1
        assert n["nested.walk_step"] == FIT["n_repeat"]  # the eager first step's
    else:
        assert "nested.replay" not in n and "nested.capture" not in n
        assert n["nested.walk_step"] == 8 * FIT["n_repeat"]


def test_a_planted_stuck_walk_is_replayed_stuck(dev, table, tmp_path):
    """``portbench.faults``' stuck walk, planted before the fit, is the walk
    the graph captures: the fit returns its unchanged starts (no dead or live
    point of a star outside its initial live set), bitwise the eager fit
    under the fault, where the sound fit makes new points."""
    from portbench import faults

    ck = {k: str(tmp_path / f"{k}.ckpt") for k in ("sound", "eager", "graphed")}
    short = dict(max_iter=128)
    _fit(_fitter(dev, table), checkpoint=ck["sound"], **short)
    with faults.plant("stuck", "catalog"):
        eager, graphed = _fitter(dev, table), _fitter(dev, table)
        out_e, _ = _fit(eager, graphs=False, checkpoint=ck["eager"], **short)
        calls = {}
        out_g, _ = _fit(graphed, calls=calls, checkpoint=ck["graphed"], **short)
    assert calls == dict(captures=1, replays=short["max_iter"] // FIT["n_batch"] - 1)
    _same_checkpoint(_checkpoint(ck["eager"]), _checkpoint(ck["graphed"]))
    _same_fit((eager, out_e), (graphed, out_g))

    def distinct(path):  # each star's distinct dead and live points
        c = _checkpoint(path)
        return [len(np.unique(x, axis=0)) for x in np.concatenate([c["dead_u"], c["live_u"]], axis=1)]

    live = FIT["n_live_points"]
    assert max(distinct(ck["graphed"])) <= live
    assert np.median(distinct(ck["sound"])) > live
