"""The slice end to end on the CPU: ``isochrones_torch.StarClusterModel``
against the JAX package's ``StarClusterModel`` on one simulated cluster
(the setup of ``tests/test_cluster.py``), handed to the port as a dict of
arrays, float64.

``lnpost_batch``, ``lnlike`` and ``star_lnmarginals`` agree within rtol
1e-9 with an identical -inf pattern at the truth and at 32 seeded points of
the prior box against the JAX XLA grid path, and within rtol 1e-9 against
the JAX Pallas kernel in interpret mode (``ISOTPU_CLUSTER_PALLAS=1``).

The two JAX paths themselves differ in one documented way
(``cluster_pallas.py`` module docstring): where every weighted cell of a
star's plane lies more than ~745 nats below the plane's maximum, the grid
path's max-shifted trapezoid underflows to -inf while the kernel's
streaming log-sum-exp resolves a tiny finite value. The port's plain path
is the grid path, so at such points it is -inf where the Pallas kernel is
finite and far below any physical value.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import isochrones_torch
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.cluster import SimulatedCluster
from isochrones_tpu.cluster import StarClusterModel as JaxStarClusterModel

TRUTH = np.array([9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3])
_MODEL_KW = dict(eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2)
_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(scope="module")
def sim():
    ic = jax_get_ichrone("synthetic", **_DIMS)
    return SimulatedCluster(
        30, age=9.0, feh=0.0, distance=500.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3,
        bands=("J", "H", "K"), mass_range=(0.5, 3.0), distance_scatter=2.0,
        ic=ic, rng=42, phot_unc=0.02,
    )


@pytest.fixture(scope="module")
def port_model(sim):
    ic = isochrones_torch.get_ichrone("synthetic", device="cpu", **_DIMS)
    data = {c: sim.df[c].values for c in sim.df.columns}
    return isochrones_torch.StarClusterModel(ic, data, bands=("J", "H", "K"), props=["parallax"], **_MODEL_KW)


def _points(model):
    los, his = model._bounds_arrays()
    rng = np.random.default_rng(7)
    return np.vstack([TRUTH, los + (his - los) * rng.random((32, 7))])


def _assert_match(got, ref, underflow_ok=False):
    got, ref = np.asarray(got), np.asarray(ref)
    m = np.isfinite(ref)
    if underflow_ok:  # grid-path underflow where the kernel stays finite
        deviant = m & np.isneginf(got)
        assert np.all(ref[deviant] < -1e4)
        m &= ~deviant
    assert np.array_equal(np.isfinite(got), m)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-9)
    return m


@pytest.mark.parametrize("pallas", ["0", "1"], ids=["xla", "pallas_interpret"])
def test_cluster_model_matches_jax(sim, port_model, monkeypatch, pallas):
    monkeypatch.setenv("ISOTPU_CLUSTER_PALLAS", pallas)
    jm = JaxStarClusterModel(sim.ic, sim, **_MODEL_KW)
    np.testing.assert_array_equal(port_model._bounds_arrays(), jm._bounds_arrays())
    pts = _points(port_model)
    underflow_ok = pallas == "1"
    ref = np.asarray(jm.lnpost_batch(jnp.asarray(pts)))
    got = port_model.lnpost_batch(pts).numpy()
    agree = _assert_match(got, ref, underflow_ok)
    assert agree[0] and agree.sum() >= 20 and np.isneginf(got).any()
    for p in pts[:3]:
        _assert_match([port_model.lnlike(p), port_model.lnprior(p)], [jm.lnlike(p), jm.lnprior(p)])
    _assert_match(port_model.star_lnmarginals(TRUTH), jm.star_lnmarginals(TRUTH).values)


def test_fit_mcmc_smoke(port_model):
    samples = port_model.fit_mcmc(nwalkers=16, nburn=20, niter=10, seed=0, moves="mixed")
    assert set(samples) == set(port_model.param_names) | {"lnprob"}
    assert len(samples["lnprob"]) == 160
    assert np.isfinite(samples["lnprob"]).all()
    assert port_model.sampler_state.n_accept.sum() > 0


def test_emcee_p0_inside_support(port_model):
    p0 = port_model.emcee_p0(8, rng=1)
    los, his = port_model._bounds_arrays()
    assert np.all((p0 >= los) & (p0 <= his))
    assert np.isfinite(port_model.lnpost_batch(p0).numpy()).all()


def test_fixture_catalogue_has_support():
    """The committed 50-star catalogue (the card's smoke run fits it) loads
    without pandas, infers its bands and property, and every member has
    support at the truth on a coarse grid of the same EEP scale."""
    from isochrones_torch.catalog import StarCatalog, read_csv

    data = read_csv("isochrones_torch/data/cluster50_synthetic.csv")
    cat = StarCatalog(data)
    assert len(cat) == 50 and cat.bands == ("J", "H", "K") and cat.props == ("parallax",)
    ic = isochrones_torch.get_ichrone("synthetic", device="cpu", n_feh=5, n_mass=40, n_eep=1710, n_age=20)
    model = isochrones_torch.StarClusterModel(
        ic, cat, eep_bounds=(1, 1400), eep_step=20.0, max_distance=3000, minq=0.2, mass_bounds=(0.6, 2.0),
    )
    truth = [9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3]
    assert np.isfinite(model.star_lnmarginals(truth)).all()
    assert np.isfinite(model.lnpost(truth))
