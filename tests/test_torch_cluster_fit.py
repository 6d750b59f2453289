"""Port parity of the cluster simulator and the nested cluster fit
(``isochrones_torch.cluster``) against the JAX package, on the CPU in
float64 on small synthetic grids (the ``clusterfit`` entry point:
``tests/test_torch_clusterfit_entry.py``).

``SimulatedCluster``/``simulate_cluster``/``evolve`` draw on the host from a
numpy generator in the JAX class's order, so the same seed gives the same
catalogue: the drawn columns (binary flags, masses, distances, parallaxes)
exactly, the EEPs and magnitudes to 1e-9 (the same interpolation arithmetic,
sums in another order). One knife edge is known and kept out of the seeds
used here: where the four corner tracks agree on an integer EEP, the fast
inversion's blend ``(1 - d) * e + d * e`` gives ``e`` or ``e`` less one unit
in the last place, depending on whether the compiler contracts it into a
fused multiply-add. At the last valid EEP of an isochrone the first reads the
NaN-padded neighbour (``0 * NaN``) and the star is redrawn, the second does
not: from there on the two catalogues hold different stars (seed 42 of the
second configuration below does so).

The nested fit draws on the device from a ``torch.Generator`` and cannot give
JAX's numbers; one seeded fit in each package is held to the bar of
``tests/test_torch_nested.py``: ln Z within 3 sqrt(logzerr1^2 + logzerr2^2).
Both fits are deterministic for their seed.
"""

import os

import numpy as np
import pytest
import torch

import isochrones_torch.cluster as tcluster
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.cluster import SimulatedCluster as JaxSimulatedCluster
from isochrones_tpu.cluster import StarClusterModel as JaxStarClusterModel
from isochrones_tpu.cluster import simulate_cluster as jax_simulate_cluster
from isochrones_torch import get_ichrone
from isochrones_torch.catalog import StarCatalog
from isochrones_torch.cluster import SimulatedCluster, StarClusterModel, simulate_cluster

DIMS = dict(n_feh=5, n_mass=20, n_eep=60, n_age=20)
TRUTH = [9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3]
#: the cluster of tests/test_cluster.py::test_cluster_fit_defaults_to_dynamic, with two more stars
SIM = dict(age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3, bands=("J", "K"),
           mass_range=(0.6, 2.0))
MODEL = dict(eep_bounds=(1, 49), eep_step=2.0, max_distance=2000)
EXACT = ("is_binary", "distance", "mass_pri", "mass_sec", "parallax", "parallax_unc", "age", "feh", "AV")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread from the module's first fixture on: at these
    sizes a pool of threads beside the other test workers' is many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _assert_same_catalogue(data, df):
    assert list(data) == list(df.columns)
    for c in df.columns:
        ref, got = df[c].values.astype(float), np.asarray(data[c], dtype=float)
        assert got.shape == ref.shape, c
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=c)
        fin = ~np.isnan(ref)
        if c in EXACT or c.endswith("_unc"):
            np.testing.assert_array_equal(got[fin], ref[fin], err_msg=c)
        else:
            np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-9, err_msg=c)


class CountingCluster(SimulatedCluster):
    """Counts the passes of the star simulation: more than one is a redraw."""

    passes = 0

    def _simulate_stars(self, *args):
        type(self).passes += 1
        return super()._simulate_stars(*args)


@pytest.mark.parametrize("rng, kw", [
    (0, {}),
    (43, dict(bands=("J", "H", "K"), mass_range=(0.5, 3.0), distance_scatter=2.0, phot_unc=0.02)),
    (7, dict(age=9.6, bands="JHK", mass_range=(0.3, 2.5), fB=0.5)),  # stars past their tracks' ends: redraws
])
def test_simulated_cluster_matches_jax(ics, rng, kw):
    jiso, tiso = ics
    args = dict(SIM, **kw)
    ref = JaxSimulatedCluster(30, ic=jiso, rng=rng, **args)
    CountingCluster.passes = 0
    got = CountingCluster(30, ic=tiso, rng=rng, **args)
    _assert_same_catalogue(got.data, ref.df)
    assert got.bands == ref.bands and got.props == ref.props == ("parallax",) and len(got) == 30
    assert got.pars == ref.pars
    # no dead stars: every magnitude is finite, so lnlike(truth) can be
    for b in got.bands:
        assert np.isfinite(got.data[f"{b}_mag"]).all()
    assert (CountingCluster.passes > 1) == (rng == 7)
    # singles have no secondary: mass 0, EEP NaN
    single = ~got.data["is_binary"]
    assert single.any() and (got.data["mass_sec"][single] == 0).all() and np.isnan(got.data["eep_sec"][single]).all()
    # the same stars at another age: the generator goes on from where generation left it
    _assert_same_catalogue(got.evolve(8.7).data, ref.evolve(8.7).df)
    # the track interpolator simulates the same catalogue as the isochrone one
    again = SimulatedCluster(30, ic=tiso.track, rng=rng, **args)
    for c in got.data:
        np.testing.assert_array_equal(again.data[c], got.data[c])


def test_simulate_cluster_matches_jax(ics):
    jiso, tiso = ics
    ref = jax_simulate_cluster(12, 9.1, -0.2, 400.0, 0.1, -2.3, 0.3, 0.4, bands="JK", iso=jiso, rng=3)
    got = simulate_cluster(12, 9.1, -0.2, 400.0, 0.1, -2.3, 0.3, 0.4, bands="JK", iso=tiso, rng=3)
    assert type(got) is StarCatalog and got.bands == ("J", "K") and got.props == ("parallax",)
    _assert_same_catalogue(got.data, ref.df)
    assert (got.data["age"] == 9.1).all() and (got.data["mass_pri"] >= 0.8).all()


@pytest.fixture(scope="module")
def models(ics):
    """The same 8-star cluster in both packages (catalogues equal by the test
    above), with a 25-point ladder. Magnitude errors of 0.05 keep the
    likelihood smooth on that coarse ladder: at 0.01 the ln Z of either
    package scatters by ~3 over seeds, at 0.05 by ~0.7 (logzerr ~0.37)."""
    jiso, tiso = ics
    jsim = JaxSimulatedCluster(8, ic=jiso, rng=0, phot_unc=0.05, **SIM)
    tsim = SimulatedCluster(8, ic=tiso, rng=0, phot_unc=0.05, **SIM)
    return JaxStarClusterModel(jiso, jsim, **MODEL), StarClusterModel(tiso, tsim, **MODEL)


def test_overridden_members(models, ics, tmp_path):
    jm, tm = models
    assert tm.labelstring == jm.labelstring == "cluster"
    named = StarClusterModel(ics[1], tm.stars, name="m67", directory=str(tmp_path), **MODEL)
    assert named.labelstring == "cluster_m67" and named.directory == str(tmp_path)
    assert named.mnest_basename == os.path.join(str(tmp_path), "chains", "m67-iso-cluster_m67-")
    assert tm.n_params == jm.n_params == 7 and tm.param_names == jm.param_names
    assert tm.N is None and tm.kwargs == {} and tm.use_emcee is False and tm.mesh is None
    assert tm._default_dynamic is True and tm.evidence is None
    with pytest.raises(AttributeError):
        tm.samples
    with pytest.raises(TypeError, match="Mesh"):
        StarClusterModel(ics[1], tm.stars, mesh=object(), **MODEL)
    assert tm.lnpost(TRUTH) == pytest.approx(jm.lnpost(TRUTH), rel=1e-9)
    assert np.isfinite(tm.star_lnmarginals(TRUTH)).all()

    # the checkpoint's hash of the problem follows the catalogue and the ladder
    base = tm._config_data_repr()
    assert base == StarClusterModel(ics[1], tm.stars, **MODEL)._config_data_repr()
    data = {c: np.array(v) for c, v in tm.stars.data.items()}
    data["K_mag"][3] += 1e-6
    moved = StarClusterModel(ics[1], StarCatalog(data, bands=("J", "K"), props=["parallax"]), **MODEL)
    assert moved._config_data_repr() != base and moved._fit_config_hash(0) != tm._fit_config_hash(0)
    for change in (dict(eep_step=1.0), dict(eep_bounds=(1, 47)), dict(mass_bounds=(0.5, 2.5)), dict(minq=0.2),
                   dict(q_jacobian=True)):
        other = StarClusterModel(ics[1], tm.stars, **dict(MODEL, **change))
        assert other._config_data_repr() != base, change
    assert tm._fit_config_hash(0) != tm._fit_config_hash(1)

    # prior draws with support, as columns or as the array
    draws = tm.sample_from_prior(6, rng=1)
    assert list(draws) == list(tm.param_names) and all(len(v) == 6 for v in draws.values())
    arr = tm.sample_from_prior(6, values=True, rng=1)
    np.testing.assert_array_equal(arr, np.stack([draws[p] for p in tm.param_names], axis=-1))
    np.testing.assert_array_equal(arr, jm.sample_from_prior(6, values=True, rng=1))
    assert np.isfinite(tm.lnpost_batch(arr).numpy()).all()


def test_lnlike_dataset_matches_lnlike_batch(models):
    _, tm = models
    obs = tuple(torch.as_tensor(x) for x in tm.stars.observation_stacks())
    fn = tm._build_lnlike_dataset()
    pts = tm.sample_from_prior(5, values=True, rng=2)
    np.testing.assert_array_equal(fn(torch.as_tensor(pts), *obs).numpy(), tm.lnlike_batch(pts).numpy())
    assert float(fn(torch.as_tensor(pts[0]), *obs)) == tm.lnlike(pts[0])
    # other observations of the same shape: a star a magnitude redder lowers the likelihood at the truth
    # (moved in every band alike it would only sit at another EEP)
    mags = obs[0].clone()
    mags[2, 0] += 1.0
    assert float(fn(torch.as_tensor(TRUTH), mags, *obs[1:])) < tm.lnlike(TRUTH)


def test_chunked_lnlike_batch_equals_unchunked(models, ics, monkeypatch):
    """A walker batch past the byte budget goes through in pieces; the
    pieces give what one call gives (rtol 1e-12: a reduction over a batch of
    another length may round otherwise), -inf pattern identical."""
    _, tm = models
    los, his = tm._bounds_arrays()
    pts = np.vstack([TRUTH, los + (his - los) * np.random.default_rng(5).random((36, 7))])
    whole = tm.lnlike_batch(pts).numpy()
    assert np.isfinite(whole).sum() > 5 and np.isneginf(whole).any()

    per_walker = tcluster._walker_bytes(len(tm.stars), tm._n_ladder, len(tm.bands), 8)
    assert tcluster._WALKER_BYTES_BUDGET // per_walker > 1024  # the fit's batch goes in one call
    monkeypatch.setattr(tcluster, "_WALKER_BYTES_BUDGET", 5 * per_walker)
    sizes = []
    inner = tcluster.cluster_lnmarginal
    monkeypatch.setattr(tcluster, "cluster_lnmarginal", lambda lnprop, *a, **k: (sizes.append(lnprop.shape[0]),
                                                                                    inner(lnprop, *a, **k))[1])
    small = StarClusterModel(ics[1], tm.stars, **MODEL)
    got = small.lnlike_batch(pts).numpy()
    assert sizes == [5] * 7 + [2]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(whole))
    fin = np.isfinite(whole)
    np.testing.assert_allclose(got[fin], whole[fin], rtol=1e-12)
    assert small.lnlike_batch(pts.reshape(1, 37, 7)).shape == (1, 37)
    np.testing.assert_allclose(small.lnpost_batch(pts).numpy()[fin], tm.lnpost_batch(pts).numpy()[fin], rtol=1e-12)


def test_fit_is_dynamic_by_default(models, monkeypatch):
    """The three cases of tests/test_cluster.py::test_cluster_fit_defaults_to_dynamic."""
    _, tm = models
    captured = {}

    def fake_run_nested(*a, **kw):
        captured.update(kw)
        raise RuntimeError("stop-at-engine")

    monkeypatch.setattr("isochrones_torch.samplers.nested.run_nested", fake_run_nested)
    with pytest.raises(RuntimeError, match="stop-at-engine"):
        tm.fit(n_live_points=50)
    assert captured.get("dynamic") is True and captured["n_live"] == 50

    captured.clear()
    with pytest.raises(RuntimeError, match="stop-at-engine"):
        tm.fit_multinest(n_live_points=50, dynamic=False)
    assert captured.get("dynamic") is False

    captured.clear()
    with pytest.raises(RuntimeError, match="stop-at-engine"):
        tm.fit_multinest(n_live_points=50, n_runs=2)
    assert "dynamic" not in captured  # n_runs > 1 does not go with dynamic
    monkeypatch.undo()
    # independent runs of the cluster fit: two short runs, dynamic refused
    # with them as in the JAX package; a mesh that is not a Mesh is refused
    res = tm.fit(n_live_points=20, n_runs=2, n_batch=5, n_chains=2, n_repeat=2, max_iter=10, seed=0)
    assert res.logz_runs.shape == (2,) and res.n_iter == 20
    with pytest.raises(ValueError, match="n_runs=1"):
        tm.fit(n_live_points=50, n_runs=2, dynamic=True)
    with pytest.raises(TypeError, match="Mesh"):
        tm.fit(n_live_points=50, mesh=object())

    # use_emcee sends fit() to the ensemble sampler
    walker = StarClusterModel(tm.ic, tm.stars, use_emcee=True, **MODEL)
    samples = walker.fit(nwalkers=8, nburn=2, niter=2, seed=0)
    assert len(samples["lnprob"]) == 16 and walker.evidence is None
    with pytest.raises(TypeError, match="Mesh"):
        walker.fit(nwalkers=8, nburn=1, niter=1, mesh=object())


FIT = dict(n_live_points=100, n_batch=25, n_chains=2, seed=0)


@pytest.fixture(scope="module")
def cluster_fits(models):
    jm, tm = models
    return tm, tm.fit(**FIT), jm, jm.fit(**FIT)


def test_nested_cluster_fit_matches_jax(cluster_fits):
    tm, tres, jm, jres = cluster_fits
    assert not tres.truncated and tres.ess > 100 and np.isfinite(tres.logz)
    assert tm.evidence == (tres.logz, tres.logzerr)
    bar = 3 * np.hypot(tres.logzerr, jres.logzerr)
    assert abs(tres.logz - jres.logz) < bar, (tres.logz, jres.logz, bar)
    assert set(tm.samples) == set(jm.samples.columns) == set(tm.param_names) | {"lnprob"}
    los, his = tm._bounds_arrays()
    for i, c in enumerate(tm.param_names):
        assert len(tm.samples[c]) == 4000 and (tm.samples[c] >= los[i]).all() and (tm.samples[c] <= his[i]).all()
    lo, hi = np.quantile(tm.samples["distance"], [0.025, 0.975])
    assert lo < 300.0 < hi


def test_nested_cluster_fit_derived_samples(cluster_fits):
    """Cluster samples are the raw chain, in both packages."""
    tm, _, jm, _ = cluster_fits
    d = tm.derived_samples
    assert d is not tm.samples and set(d) == set(jm.derived_samples.columns)
    for c, v in tm.samples.items():
        np.testing.assert_array_equal(d[c], v)
    assert np.isfinite(tm.samples["lnprob"]).all()
    assert len(tm.random_samples(10, rng=0)["age"]) == 10
