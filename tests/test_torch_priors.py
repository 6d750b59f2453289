"""Port parity: the tensor ``lnpdf`` of each concrete prior against the JAX
package's ``lnpdf_jax``, float64, including out-of-bounds and NaN points.
Values within rtol 1e-12; the -inf and NaN patterns must be identical."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_tpu.priors as jp
import isochrones_torch.priors as tp

_CASES = {
    "flat": (lambda m: m.FlatPrior((0.0, 0.6)), (-0.5, 1.2)),
    "flatlog": (lambda m: m.FlatLogPrior((6, 10.15)), (5.0, 11.0)),
    "gaussian": (lambda m: m.GaussianPrior(0.3, 0.1), (-0.5, 1.2)),
    "gaussian_truncated": (lambda m: m.GaussianPrior(0.3, 0.1, bounds=(0, 1)), (-0.5, 1.5)),
    "powerlaw": (lambda m: m.PowerLawPrior(alpha=2.0, bounds=(0, 3000)), (-100.0, 3500.0)),
    "powerlaw_negative": (lambda m: m.PowerLawPrior(-2.35, (0.1, 10)), (0.0, 12.0)),
    "feh": (lambda m: m.FehPrior(halo_fraction=0.5), (-5.0, 2.0)),
    "feh_bounded": (lambda m: _bounded(m.FehPrior(), (-2.0, 0.5)), (-3.0, 1.0)),
}


def _bounded(prior, bounds):
    prior.bounds = bounds
    return prior


@pytest.mark.parametrize("name", list(_CASES))
def test_lnpdf_matches_lnpdf_jax(name):
    make, (lo, hi) = _CASES[name]
    x = np.concatenate([np.linspace(lo, hi, 101), [np.nan, 0.0]])
    ref = np.asarray(make(jp).lnpdf_jax(jnp.asarray(x)))
    got = make(tp).lnpdf(torch.as_tensor(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.any() and (~m).any()
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-12)


@pytest.mark.parametrize("name", ["flat", "flatlog", "gaussian", "powerlaw_negative", "feh_bounded"])
def test_sample_matches_reference(name):
    """Host sampling is the same numpy code: same draws from the same seed."""
    make, _ = _CASES[name]
    np.testing.assert_array_equal(make(tp).sample(50, rng=3), make(jp).sample(50, rng=3))


def test_float32_floors_flush_like_jax():
    """``1e-300`` floors flush to 0 in float32: ln p(0) of a power law with
    positive index is -inf, as under JAX's weak typing."""
    x = torch.tensor([0.0, 10.0], dtype=torch.float32)
    got = tp.PowerLawPrior(alpha=2.0, bounds=(0, 3000)).lnpdf(x)
    assert got[0] == -np.inf and np.isfinite(got[1].item())


# ---------------------------------------------------------- the star model's priors
_MORE = {
    "lognormal": (lambda m: m.LogNormalPrior(math.log(0.079), 0.69 * math.log(10)), (-0.5, 3.0)),
    "chabrier": (lambda m: m.ChabrierPrior(), (0.0, 120.0)),
    "chabrier_narrow": (lambda m: m.ChabrierPrior(bounds=(0.2, 5.0)), (0.0, 6.0)),
    "broken_three": (lambda m: m.BrokenPrior([m.PowerLawPrior(-1.5, (0.1, 1.0)), m.FlatPrior((1.0, 2.0)),
                                               m.PowerLawPrior(-2.0, (2.0, 10.0))], [1.0, 2.0], bounds=(0.1, 10.0)),
                     (0.0, 11.0)),
    "age": (lambda m: m.AgePrior(), (4.0, 11.0)),
    "distance": (lambda m: m.DistancePrior(), (-10.0, 11000.0)),
    "distance_max": (lambda m: m.DistancePrior(max_distance=400), (-10.0, 500.0)),
    "av": (lambda m: m.AVPrior(), (-0.2, 1.2)),
    "q": (lambda m: m.QPrior(), (0.0, 1.2)),
    "salpeter": (lambda m: m.SalpeterPrior(), (0.0, 12.0)),
}


@pytest.mark.parametrize("name", list(_MORE))
def test_star_model_prior_lnpdf_matches_lnpdf_jax(name):
    make, (lo, hi) = _MORE[name]
    x = np.concatenate([np.linspace(lo, hi, 257), [np.nan, 1.0, 0.1, 0.0]])
    ref = np.asarray(make(jp).lnpdf_jax(jnp.asarray(x)))
    got = make(tp).lnpdf(torch.as_tensor(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.any() and (~m).any()
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-12)


@pytest.mark.parametrize("name", ["lognormal", "chabrier", "broken_three", "age", "distance", "q", "salpeter"])
def test_star_model_prior_pdf_and_sample_match_reference(name):
    """Host pdf (through ``__call__``) to rtol 1e-12 and sampling draw for
    draw: the same numpy code on the same seed."""
    make, (lo, hi) = _MORE[name]
    x = np.linspace(max(lo, 0.01), hi, 101)
    np.testing.assert_allclose(make(tp)(x), make(jp)(x), rtol=1e-12, atol=0)
    np.testing.assert_allclose(make(tp).sample(200, rng=5), make(jp).sample(200, rng=5), rtol=1e-12, atol=0)


def test_prior_call_is_pdf():
    p = tp.ChabrierPrior()
    x = np.array([0.05, 0.5, 1.0, 3.0, 200.0])
    np.testing.assert_array_equal(p(x), p.pdf(x))
    assert p(0.5) == p.pdf(0.5) and p(200.0) == 0.0
    assert tp.FehPrior()(0.1) == tp.FehPrior().pdf(0.1)


@pytest.mark.parametrize("make, bounds", [
    (lambda m: m.FlatPrior((0, 1)), (1, 1)),
    (lambda m: m.PowerLawPrior(2.0, (0, 10)), (5, 5)),
], ids=["flat_empty", "powerlaw_empty"])
def test_bounds_setter_runs_test_integral(make, bounds):
    """Bounds that leave the pdf without unit mass raise ``ValueError`` in
    both packages (the star model's ``set_bounds`` relies on it)."""
    with pytest.raises(ValueError, match="integral test failed"):
        make(jp).bounds = bounds
    with pytest.raises(ValueError, match="integral test failed"):
        make(tp).bounds = bounds
    good = make(tp)
    good.bounds = (0.5, 2.0)
    good.test_integral()


def test_base_prior_bounds_renormalize():
    """A quadrature-normalized prior renormalizes when its bounds move, as
    the JAX package's does, and still integrates to one."""
    t, j = tp.FehPrior(), jp.FehPrior()
    t.bounds = j.bounds = (-1.0, 0.3)
    assert t._norm == pytest.approx(j._norm, rel=1e-14)
    t.test_integral()
    x = np.linspace(-1.5, 0.5, 41)
    ref = np.asarray(j.lnpdf_jax(jnp.asarray(x)))
    got = t.lnpdf(torch.as_tensor(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-12)


@pytest.fixture(scope="module")
def ics():
    from isochrones_tpu import get_ichrone as jax_get_ichrone
    from isochrones_torch import get_ichrone

    dims = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
    return get_ichrone("synthetic", device="cpu", **dims), jax_get_ichrone("synthetic", **dims)


def test_eep_prior_lnpdf_matches_jax(ics):
    """The conditioned change-of-variables prior on tensors, rtol 1e-12 and
    identical -inf patterns, over EEPs past both ends of the ladder, exact
    knots, NaN and ages/metallicities off the grid."""
    tic, jic = ics
    rng = np.random.default_rng(4)
    n = 4000
    eep = rng.uniform(-5, 110, n)
    eep[:500] = rng.integers(0, 101, 500)
    age = rng.uniform(7.5, 10.3, n)
    feh = rng.uniform(-2.2, 0.6, n)
    age[500:600] = np.asarray(jic.model.knots[0])[rng.integers(0, 30, 100)]
    eep[600:610] = np.nan
    feh[610:620] = np.nan
    t = tp.EEP_prior(tic, tp.ChabrierPrior(), bounds=(1, 90))
    j = jp.EEP_prior(jic, jp.ChabrierPrior(), bounds=(1, 90))
    got = t.lnpdf(torch.as_tensor(eep), age=torch.as_tensor(age), feh=torch.as_tensor(feh)).numpy()
    ref = np.asarray(j.lnpdf_jax(jnp.asarray(eep), age=jnp.asarray(age), feh=jnp.asarray(feh)))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.sum() > 500 and (~m).sum() > 500
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-12)

    ladder = np.arange(1.0, 91.0)
    c0, c1 = np.full(90, 9.0), np.full(90, 0.0)
    np.testing.assert_allclose(t._ladder_weights(ladder, c0, c1), j._ladder_weights(ladder, c0, c1), rtol=1e-12,
                               atol=0)


def test_eep_prior_sample_follows_row_conditioning(ics):
    """Vector conditioning: every draw lies on the ladder inside the bounds
    and has support under its own row's (age, feh)."""
    tic, _ = ics
    t = tp.EEP_prior(tic, tp.ChabrierPrior(), bounds=(1, 90))
    rng = np.random.default_rng(2)
    age = rng.uniform(8.0, 10.0, 300)
    feh = rng.uniform(-1.0, 0.3, 300)
    eep = t.sample(300, rng=3, age=age, feh=feh)
    assert eep.shape == (300,) and np.array_equal(eep, np.round(eep))
    assert (eep >= 1).all() and (eep <= 90).all()
    ln = t.lnpdf(torch.as_tensor(eep), age=torch.as_tensor(age), feh=torch.as_tensor(feh)).numpy()
    assert np.isfinite(ln).mean() > 0.95
