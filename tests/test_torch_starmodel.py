"""Port parity of the single/binary/triple star models,
``isochrones_torch.starmodel``, against the JAX package, float64, on the small
synthetic grid (n_feh=7, n_mass=30, n_eep=100, n_age=30).

- layout (parameter names, bands, bounds, the prior transform): exact;
- ``lnpost_batch``/``lnlike_batch``/``lnprior_batch`` on the fused and the
  composed path, with parallax and with ``nu_max``/``delta_nu``: rtol 1e-10
  with identical finite patterns, on points that include NaN, out-of-bounds
  and exact-knot coordinates;
- the interpolator's ``__call__`` and the derived samples on the same
  posterior draws: rtol 1e-12 with identical NaN patterns;
- the unported ``fit_multinest`` options raise. The fit itself is held
  to the JAX fit in ``tests/test_torch_nested.py``.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.priors as jpriors
import isochrones_torch.priors as tpriors
from chip_smoke import star_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu import starmodel as jsm
from isochrones_torch import get_ichrone
from isochrones_torch import starmodel as tsm

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
_TRUTH = [60.0, 9.0, 0.0, 200.0, 0.1]  # eep, age, feh, distance, AV
_CLASSES = {1: "SingleStarModel", 2: "BinaryStarModel", 3: "TripleStarModel"}


@pytest.fixture(scope="module")
def ics():
    return get_ichrone("synthetic", device="cpu", **_DIMS), jax_get_ichrone("synthetic", **_DIMS)


def _observations(jic, seismic=False):
    Teff, logg, _, mags = jic.interp_mag(_TRUTH, ["J", "H", "K", "G"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05))
    obs.update({b: (float(m), 0.02) for b, m in zip("JHKG", np.asarray(mags))})
    if seismic:
        nu_max, delta_nu = np.asarray(jic.interp_value(_TRUTH[:3], ["nu_max", "delta_nu"]))
        obs.update(nu_max=(float(nu_max) * 1.01, 0.05 * float(nu_max)), delta_nu=(float(delta_nu), 1.0))
    return obs


def _composed(module, name):
    """A subclass that overrides the prior builder: both packages then take
    the composed (unfused) posterior."""
    base = getattr(module, name)

    class Composed(base):
        def _build_lnprior_batch(self):
            return super()._build_lnprior_batch()

    return Composed


def _models(ics, N, path="fused", seismic=False):
    tic, jic = ics
    obs = _observations(jic, seismic)
    name = _CLASSES[N]
    if path == "composed":
        return _composed(tsm, name)(tic, **obs), _composed(jsm, name)(jic, **obs)
    return getattr(tsm, name)(tic, **obs), getattr(jsm, name)(jic, **obs)


def _points(tm, N, n=1024, seed=0):
    """Adversarial rows (``chip_smoke.star_points``) and rows drawn in the
    model's box near the truth, where the posterior is finite."""
    pts = star_points(tm.ic.model.knots, N, n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    near = np.empty((n // 2, N + 4))
    near[:, :N] = np.sort(rng.uniform(20, 90, (n // 2, N)), axis=1)[:, ::-1]
    near[:, N:] = np.asarray(_TRUTH[1:]) + rng.normal(0, [0.3, 0.2, 20.0, 0.05], (n // 2, 4))
    near[:, N + 3] = np.abs(near[:, N + 3])
    return np.concatenate([pts, near])


def _assert_same(got, ref, rtol=1e-10):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=0)
    return m


@pytest.mark.parametrize("N", [1, 2, 3])
def test_layout_matches_jax(ics, N):
    tm, jm = _models(ics, N)
    assert tm.param_names == tuple(jm.param_names)
    assert list(tm.bands) == list(jm.bands) and list(tm.props) == list(jm.props)
    np.testing.assert_array_equal(np.asarray(tm.spec_props), np.asarray(jm.spec_props))
    for g, r in zip(tm._bounds_arrays(), jm._bounds_arrays()):
        np.testing.assert_array_equal(g, r)
    u = np.random.default_rng(N).random((64, tm.n_params))
    np.testing.assert_array_equal(tm.prior_transform_batch(torch.as_tensor(u)).numpy(),
                                  np.asarray(jm.prior_transform_batch(jnp.asarray(u))))


@pytest.mark.parametrize("seismic", [False, True], ids=["parallax", "seismic"])
@pytest.mark.parametrize("path", ["fused", "composed"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_lnpost_batch_matches_jax(ics, N, path, seismic):
    tm, jm = _models(ics, N, path, seismic)
    assert (tm._build_lnpost_fused() is not None) == (path == "fused")
    p = _points(tm, N, seed=N)
    got = tm.lnpost_batch(p).numpy()
    m = _assert_same(got, jm.lnpost_batch(jnp.asarray(p)))
    assert m.sum() > 100 and (~m).sum() > 100
    if path == "composed":  # the builders the fused path shares
        _assert_same(tm.lnlike_batch(p).numpy(), jm.lnlike_batch(jnp.asarray(p)))
        _assert_same(tm.lnprior_batch(p).numpy(), jm.lnprior_batch(jnp.asarray(p)))
    i = int(np.argmax(np.where(m, got, -np.inf)))
    assert tm.lnpost(p[i]) == pytest.approx(float(got[i]), rel=1e-12)


def test_bounds_and_prior_changes_follow_jax(ics):
    """``set_bounds`` and ``set_prior`` rebuild the posterior in both
    packages alike; a bound that fails the prior's integral test is kept,
    without raising, as the JAX package keeps it."""
    tm, jm = _models(ics, 2)
    for m, pri in ((tm, tpriors), (jm, jpriors)):
        m.set_bounds(distance=(0, 400))
        m.set_prior(feh=pri.FlatPrior((-0.5, 0.4)))
    for g, r in zip(tm._bounds_arrays(), jm._bounds_arrays()):
        np.testing.assert_array_equal(g, r)
    p = _points(tm, 2, 512, seed=9)
    _assert_same(tm.lnpost_batch(p).numpy(), jm.lnpost_batch(jnp.asarray(p)))

    tm.set_bounds(AV=(0.5, 0.5))
    jm.set_bounds(AV=(0.5, 0.5))
    assert tm.bounds("AV") == jm.bounds("AV") == (0.5, 0.5)
    assert tm._priors["AV"].bounds == jm._priors["AV"].bounds


def test_interpolator_call_and_accessors_match_jax(ics):
    tic, jic = ics
    rng = np.random.default_rng(0)
    eep, age, feh = rng.uniform(1, 100, 300), rng.uniform(8, 10, 300), rng.uniform(-1, 0.4, 300)
    dist, av = rng.uniform(50, 500, 300), rng.uniform(0, 0.5, 300)
    got = tic(eep, age, feh, dist, av)
    ref = jic(eep, age, feh, dist, av)
    assert list(got) == list(ref.columns)
    for c in ref.columns:
        _assert_same(got[c], ref[c].values, rtol=1e-12)
    for prop in ("mass", "radius", "Teff", "logg", "density", "nu_max"):
        _assert_same(getattr(tic, prop)(eep, age, feh), np.asarray(getattr(jic, prop)(eep, age, feh)), rtol=1e-12)
    assert tic.Teff(60.0, 9.0, 0.0) == pytest.approx(float(jic.Teff(60.0, 9.0, 0.0)), rel=1e-12)


@pytest.mark.parametrize("N", [1, 2])
def test_derived_samples_match_jax(ics, N):
    """The same posterior draws through both packages' post-processing."""
    tm, jm = _models(ics, N)
    draws = tm.sample_from_prior(400, values=True, rng=1)
    ln = tm.lnpost_batch(draws).numpy()
    assert np.isfinite(ln).all()
    eeps = draws[:, :N]
    assert (np.diff(eeps, axis=1) <= 0).all()  # components ordered by EEP, descending
    cols = {n: draws[:, i] for i, n in enumerate(tm.param_names)}
    cols["lnprob"] = ln
    tm._samples = dict(cols)
    jm._samples = pd.DataFrame(cols)
    got, ref = tm.derived_samples, jm.derived_samples
    assert set(got) == set(ref.columns)
    for c in ref.columns:
        _assert_same(got[c], ref[c].values, rtol=1e-12)
    assert tm.posterior_predictive == pytest.approx(float(jm.posterior_predictive), rel=1e-12)


def test_fit_multinest_options_not_ported(ics):
    """``n_runs > 1`` runs (and refuses ``dynamic``, as the JAX package
    does); ``mesh`` is still not ported."""
    tm, _ = _models(ics, 1)
    res = tm.fit_multinest(n_live_points=40, n_runs=2, n_batch=4, n_chains=4, n_repeat=8, max_iter=80, seed=0)
    assert res.logz_runs.shape == (2,) and tm.evidence == (res.logz, res.logzerr)
    assert len(tm.samples["lnprob"]) == 4000
    with pytest.raises(ValueError, match="n_runs=1"):
        tm.fit_multinest(n_live_points=40, n_runs=2, dynamic=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.fit_multinest(n_live_points=40, mesh=object())
    assert type(tm)._default_dynamic is False  # the flat model's fit stays static unless asked
