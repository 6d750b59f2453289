"""The port's problem-family nested sampler on the CPU:
``run_nested_vmapped`` (a family of problems with their own data, one
likelihood call a walk step) and ``run_nested(n_runs > 1)`` (independent runs
of one problem), against the JAX package's functions and analytic evidences.

The family shares one ``torch.Generator`` where the JAX package splits a key
per problem, so the two packages draw other numbers: evidences are held to
the bar of ``tests/test_torch_nested.py``, 3 sqrt(logzerr1^2 + logzerr2^2),
with fixed seeds. A resumed run is bitwise the run that never stopped.
"""

import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_torch.samplers.nested as tn
from isochrones_torch import tracing
from isochrones_tpu.samplers.nested import run_nested as jax_run_nested
from isochrones_tpu.samplers.nested import run_nested_vmapped as jax_run_nested_vmapped
from isochrones_torch.samplers.nested import run_nested, run_nested_vmapped

SIGMA = 0.05
CENTERS = np.array([[0.35, 0.6], [0.5, 0.45], [0.62, 0.4]])  # three problems in the unit square
KW = dict(n_live=80, n_batch=8, n_chains=4, n_repeat=8)
#: ln Z of a Gaussian of width SIGMA per axis inside the unit square (the
#: truncation is below 1e-10 here)
LOGZ = 2 * np.log(SIGMA * np.sqrt(2 * np.pi))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the small tensors of these tests run several times
    faster than with a pool of threads, and the test workers share the
    host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lnlike_fam(centers, u):
    """(M, B, 2) unit-cube points -> (M, B): problem m's Gaussian about
    centers[m]; a NaN center means no support (-inf everywhere)."""
    ll = -0.5 * (((u - centers[:, None, :]) / SIGMA) ** 2).sum(-1)
    return torch.where(torch.isnan(ll), float("-inf"), ll)


def _start(centers=CENTERS, seed=11, n_live=80):
    u0 = np.random.default_rng(seed).random((len(centers), n_live, 2))
    c = torch.as_tensor(centers, dtype=torch.float64)
    return c, u0, lnlike_fam(c, torch.as_tensor(u0)).numpy()


def _run(c, u0, l0, **kw):
    return run_nested_vmapped(lnlike_fam, c, u0, l0, device="cpu", **{**KW, **kw})


def test_family_matches_jax_and_analytic():
    c, u0, l0 = _start()
    got = _run(c, u0, l0, seed=13)

    def make_lnlike_u(center):
        return lambda u: -0.5 * jnp.sum(((u - center) / SIGMA) ** 2, axis=-1)

    ref = jax_run_nested_vmapped(make_lnlike_u, jnp.asarray(CENTERS), u0, l0, seed=13, **KW)
    assert set(got) == set(ref)
    assert got["converged"].all() and ref["converged"].all()
    assert got["samples_u"].shape == ref["samples_u"].shape == (3, 2000, 2)
    for m in range(3):
        bar = 3 * np.hypot(got["logzerr"][m], ref["logzerr"][m])
        assert abs(got["logz"][m] - ref["logz"][m]) < bar, (m, got["logz"][m], ref["logz"][m], bar)
        assert abs(got["logz"][m] - LOGZ) < 3 * got["logzerr"][m]
        np.testing.assert_allclose(got["samples_u"][m].mean(0), CENTERS[m], atol=0.01)
        np.testing.assert_allclose(got["samples_u"][m].std(0), SIGMA, rtol=0.15)
    # each problem's draws come from its own posterior, above its dead points
    assert (got["lnl"] > -20).all() and got["n_dead"] % KW["n_batch"] == 0


@pytest.mark.parametrize("M", [3, 1], ids=["three_problems", "family_of_one"])
def test_family_core_invariants(M):
    """Per problem: dead points ascending within each batch, the thresholds
    rising batch to batch, the scattered replacements above every dead point,
    every point in the cube, the scales in their clamp. A family of one is
    how a single run steps."""
    c, u0, l0 = _start(CENTERS[:M])
    g = torch.Generator()
    g.manual_seed(0)
    u, lnl = torch.as_tensor(u0), torch.as_tensor(l0)
    scale = torch.full((M,), 0.5, dtype=torch.float64)
    steps = tn._FamilySteps(lambda x: lnlike_fam(c, x), g, 80, 4, 8, 8)
    du, dl, u2, l2, s2 = steps.chunk(u, lnl, scale, 5)
    assert du.shape == (M, 40, 2) and dl.shape == (M, 40) and s2.shape == (M,)
    batches = dl.reshape(M, 5, 8)
    assert (batches[..., 1:] >= batches[..., :-1]).all()
    assert (batches[:, 1:, 0] >= batches[:, :-1, -1]).all()
    assert (l2.min(dim=1).values >= dl.max(dim=1).values).all() and torch.isfinite(l2).all()
    assert ((u2 >= 0) & (u2 <= 1)).all()
    np.testing.assert_array_equal(l2.numpy(), lnlike_fam(c, u2).numpy())
    assert ((s2 >= 1e-4) & (s2 <= 4.0)).all()


def test_no_support_problem_gives_nan_while_others_converge():
    centers = CENTERS.copy()
    centers[1] = np.nan
    c, u0, l0 = _start(centers)
    out = _run(c, u0, l0, seed=3, max_iter=1280)
    assert np.isnan(out["samples_u"][1]).all() and np.isneginf(out["lnl"][1]).all()
    assert out["logz"][1] == -np.inf and not out["converged"][1]
    assert out["converged"][[0, 2]].all() and np.isfinite(out["samples_u"][[0, 2]]).all()
    for m in (0, 2):
        assert abs(out["logz"][m] - LOGZ) < 3 * out["logzerr"][m]


def test_family_dynamic_reaches_the_ess():
    """Dynamic threads lift every problem's ESS to the target; evidences stay
    analytic, within the JAX package's bar for this test (4 logzerr): the
    threads sharpen the posterior, not the evidence, whose scatter over seeds
    0-7 here (sd ~0.17) is that of the static run while the merged logzerr
    reads ~0.14."""
    c, u0, l0 = _start()
    dyn = _run(c, u0, l0, seed=2, dynamic=True, min_ess=500.0, max_iter=2400)
    assert dyn["dynamic_rounds"] >= 1 and (dyn["ess"] >= 500).all() and dyn["converged"].all()
    for m in range(3):
        assert abs(dyn["logz"][m] - LOGZ) < 4 * max(dyn["logzerr"][m], 0.05)


def _assert_same_family(a, b):
    assert a["n_dead"] == b["n_dead"] and a["dynamic_rounds"] == b["dynamic_rounds"]
    for k in ("logz", "logzerr", "ess", "converged", "samples_u", "lnl"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_family_resume_bitwise(tmp_path):
    c, u0, l0 = _start()
    full = _run(c, u0, l0, seed=13)
    ck = str(tmp_path / "fam.ckpt")
    part = _run(c, u0, l0, seed=13, max_iter=256, checkpoint=ck)
    assert part["n_dead"] == 256 < full["n_dead"]
    with open(ck, "rb") as f:
        cfg = pickle.load(f)["config"]
    assert (cfg["kind"], cfg["n_problems"], cfg["package"], cfg["device"]) == ("vmapped", 3, "isochrones_torch", "cpu")
    _assert_same_family(full, _run(c, u0, l0, seed=13, checkpoint=ck, resume=True))
    with pytest.raises(tn.CheckpointConfigError):
        _run(c, u0, l0, seed=13, checkpoint=ck, resume=True, n_chains=3)


def test_family_dynamic_resume_bitwise(tmp_path):
    c, u0, l0 = _start()
    kw = dict(seed=9, dynamic=True, min_ess=900.0, max_iter=4000)
    full = _run(c, u0, l0, **kw)
    assert full["dynamic_rounds"] >= 2, "the fixture must need two thread rounds"
    ck = str(tmp_path / "dyn.ckpt")
    part = _run(c, u0, l0, checkpoint=ck, max_dynamic_rounds=1, **kw)
    assert part["dynamic_rounds"] == 1
    with open(ck, "rb") as f:
        assert pickle.load(f)["phase"] == "dynamic"
    _assert_same_family(full, _run(c, u0, l0, checkpoint=ck, resume=True, **kw))


def test_family_refuses_mesh_and_wrong_live_count():
    c, u0, l0 = _start()
    with pytest.raises(TypeError, match="Mesh"):
        _run(c, u0, l0, mesh=object())
    with pytest.raises(ValueError, match="n_live"):
        run_nested_vmapped(lnlike_fam, c, u0, l0, device="cpu", n_live=40)


# ------------------------------------------------ the step as a CUDA graph
# On the CPU a stand-in takes the graph's place: its capture runs nothing and
# each replay runs the captured step with the spans off, as a graph's replay
# opens none. So the run's bookkeeping around the graph (the static buffers,
# the chunks' dead rows, the threads, the checkpoint, the fallback) is held to
# the eager run here; tests/test_torch_nested_graph.py replays real graphs on
# the card.


def _graph_stand_in(monkeypatch, fail=False):
    """Engage the graphed step on the CPU with a stand-in capture; returns
    the counts of captures and replays. With ``fail`` the capture draws from
    the generator and raises, as a capture that meets a read-back does."""
    calls = dict(captures=0, replays=0)

    def capture(body, g):
        calls["captures"] += 1
        if fail:
            torch.rand(3, generator=g)
            raise RuntimeError("CUDA error: operation not permitted when stream is capturing")

        def replay():
            calls["replays"] += 1
            with pytest.MonkeyPatch.context() as m:
                m.setattr(tracing, "_capturing", lambda: True)
                return body()
        return replay

    monkeypatch.setattr(tn, "_graphed", lambda device, mesh: mesh is None)
    monkeypatch.setattr(tn, "_capture", capture)
    return calls


def test_graphs_engage_on_a_card_without_a_mesh():
    from isochrones_torch.parallel import default_mesh

    assert tn._graphed(torch.device("cuda", 0), None)
    assert not tn._graphed(torch.device("cpu"), None)
    assert not tn._graphed(torch.device("cuda", 0), default_mesh(2, ("problems",), device="cpu"))


def test_the_launch_counters_are_the_kernel_wrappers():
    """What a capture sets back and a replay adds: each counting wrapper of
    the loaded ``ops`` modules, once."""
    from isochrones_torch.ops.catalog_cuda import catalog_lnlike_cuda, catalog_lnpost_cuda
    from isochrones_torch.ops.star_cuda import star_lnlike_cuda

    found = tn._launch_counters()
    assert len({id(fn) for fn in found}) == len(found)
    for fn in (catalog_lnlike_cuda, catalog_lnpost_cuda, star_lnlike_cuda):
        assert sum(f is fn for f in found) == 1


@pytest.mark.parametrize("dynamic", [False, True])
def test_graphed_family_run_is_bitwise_the_eager_run(monkeypatch, dynamic):
    """One capture at the run's second step, every later step of the base
    runs and of the threads a replay, and the run bitwise the eager one."""
    c, u0, l0 = _start()
    kw = dict(seed=9, dynamic=True, min_ess=900.0, max_iter=4000) if dynamic else dict(seed=13)
    eager = _run(c, u0, l0, **kw)
    calls = _graph_stand_in(monkeypatch)
    graphed = _run(c, u0, l0, **kw)
    _assert_same_family(eager, graphed)
    assert calls["captures"] == 1 and calls["replays"] == graphed["n_dead"] // KW["n_batch"] - 1
    assert (graphed["dynamic_rounds"] >= 1) == dynamic


def _checkpoint(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_graphed_family_checkpoint_and_resume_bitwise(tmp_path, monkeypatch):
    """The graphed run's checkpoint (dead points, live set, scales, the
    generator's state) is the eager run's, and a graphed run resumed from it
    is the run that never stopped."""
    c, u0, l0 = _start()
    full = _run(c, u0, l0, seed=13)
    eager_ck, graph_ck = str(tmp_path / "eager.ckpt"), str(tmp_path / "graph.ckpt")
    _run(c, u0, l0, seed=13, max_iter=256, checkpoint=eager_ck)
    calls = _graph_stand_in(monkeypatch)
    part = _run(c, u0, l0, seed=13, max_iter=256, checkpoint=graph_ck)
    assert part["n_dead"] == 256 and calls["replays"] == 256 // KW["n_batch"] - 1
    a, b = _checkpoint(eager_ck), _checkpoint(graph_ck)
    for k in ("dead_u", "dead_lnl", "live_u", "live_lnl", "generator_state", "scale"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["n_dead_total"] == b["n_dead_total"] and a["rng_state"] == b["rng_state"]
    _assert_same_family(full, _run(c, u0, l0, seed=13, checkpoint=graph_ck, resume=True))
    assert calls["captures"] == 2  # one a call


def test_a_capture_that_raises_leaves_the_run_eager(monkeypatch, caplog):
    """The failed capture's draws are undone: the run is bitwise the eager
    one, with one warning."""
    c, u0, l0 = _start()
    eager = _run(c, u0, l0, seed=13)
    calls = _graph_stand_in(monkeypatch, fail=True)
    with caplog.at_level(logging.WARNING, logger="isochrones_torch"):
        got = _run(c, u0, l0, seed=13)
    _assert_same_family(eager, got)
    assert calls == dict(captures=1, replays=0)
    assert caplog.text.count("could not be captured as a CUDA graph") == 1
    assert "operation not permitted when stream is capturing" in caplog.text


# ------------------------------------------------------------ n_runs > 1
MU = np.array([0.3, -0.2])
SIG2 = np.array([0.15, 0.1])
MULTI = dict(n_live=100, n_batch=8, n_chains=4, n_repeat=8)


def lnpost_v(x):
    mu, sig = torch.as_tensor(MU, dtype=x.dtype), torch.as_tensor(SIG2, dtype=x.dtype)
    return -0.5 * (((x - mu) / sig) ** 2 + torch.log(2 * np.pi * sig ** 2)).sum(-1)


def prior_transform(u):
    return u * 4.0 - 2.0  # box [-2, 2]^2: ln Z = -ln 16


def _multi(seed=3, rng=5, **kw):
    g = torch.Generator()
    g.manual_seed(seed)
    return run_nested(lnpost_v, prior_transform, 2, g, rng=rng, **{**MULTI, **kw})


def test_multi_run_matches_jax_and_analytic():
    got = _multi(n_runs=3)
    ref = jax_run_nested(
        lambda x: -0.5 * jnp.sum(((x - MU) / SIG2) ** 2 + jnp.log(2 * np.pi * SIG2 ** 2), axis=-1),
        prior_transform, 2, jax.random.PRNGKey(3), rng=5, n_runs=3, **MULTI,
    )
    truth = -np.log(16.0)
    assert got.logz_runs.shape == (3,) and np.all(np.abs(got.logz_runs - truth) < 0.6)
    assert abs(got.logz - ref.logz) < 3 * np.hypot(got.logzerr, ref.logzerr), (got.logz, ref.logz)
    assert abs(got.logz - truth) < 3 * got.logzerr
    # the reported error is at least the runs' empirical scatter
    assert got.logzerr >= np.std(got.logz_runs, ddof=1) / np.sqrt(3) - 1e-12
    assert got.logz == pytest.approx(float(np.logaddexp.reduce(got.logz_runs) - np.log(3)), abs=1e-12)
    assert got.posterior.shape == (4000, 2) and not got.truncated and got.ess > 300
    assert got.samples.shape[0] == got.n_iter + 3 * 100
    np.testing.assert_allclose(got.posterior.mean(0), MU, atol=0.03)
    np.testing.assert_allclose(got.posterior.std(0), SIG2, rtol=0.15)


def test_multi_run_resume_bitwise(tmp_path):
    full = _multi(n_runs=3)
    ck = str(tmp_path / "multi.ckpt")
    part = _multi(n_runs=3, max_iter=256, checkpoint=ck)
    assert part.n_iter == 3 * 256 < full.n_iter
    with open(ck, "rb") as f:
        assert pickle.load(f)["config"]["kind"] == "multi"
    resumed = _multi(n_runs=3, checkpoint=ck, resume=True)
    assert (full.logz, full.logzerr, full.ess, full.n_iter) == (resumed.logz, resumed.logzerr, resumed.ess,
                                                                resumed.n_iter)
    for name in ("samples", "logl", "logwt", "posterior", "logl_posterior", "logz_runs"):
        np.testing.assert_array_equal(getattr(full, name), getattr(resumed, name), err_msg=name)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
