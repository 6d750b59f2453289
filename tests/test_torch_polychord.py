"""The port's PolyChord-style nested sampler
(``isochrones_torch.samplers.polychord``) on the CPU against analytic targets,
the three fast tests of ``tests/test_polychord.py`` with the same bars:

- a Gaussian likelihood in a uniform box: ln Z within max(3 logzerr, 0.1) of
  the analytic value, posterior means within 0.02 of 0, standard deviations
  within 15% of sigma;
- a strongly correlated Gaussian (rho = 0.95): ln Z within max(3 logzerr,
  0.15), the posterior covariance within 25% (+ 0.1 sigma^2);
- dynamic threads replay the slice core (the ``core=`` contract): at least one
  round, the ESS target reached, ln Z and the standard deviations as above.

And ``run_nested``'s ``core=`` hook itself: the slice core's checkpoint
refuses a walk-core run's, and ``n_runs > 1`` refuses a core.
"""

import numpy as np
import pytest
import torch

from isochrones_torch.samplers.nested import CheckpointConfigError, run_nested
from isochrones_torch.samplers.polychord import _polychord_core, run_polychord


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _gauss(sigma):
    def lnpost_v(x):
        return -0.5 * torch.sum((x / sigma) ** 2, dim=-1) - x.shape[-1] * 0.5 * np.log(2 * np.pi * sigma ** 2)

    return lnpost_v


def _box(u):
    return -1.0 + 2.0 * u


def test_polychord_gaussian_evidence():
    sigma, n_params = 0.1, 2
    res = run_polychord(_gauss(sigma), _box, n_params, _gen(2), n_live=400, max_iter=6000, rng=3)
    expected = np.log(1.0 / 2.0 ** n_params)
    assert res.logz == pytest.approx(expected, abs=max(3 * res.logzerr, 0.1))
    assert np.abs(res.posterior.mean(axis=0)).max() < 0.02
    np.testing.assert_allclose(res.posterior.std(axis=0), sigma, rtol=0.15)


def test_polychord_correlated_gaussian():
    rho, sigma = 0.95, 0.08
    cov = sigma ** 2 * np.array([[1.0, rho], [rho, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov))
    norm = -0.5 * np.log((2 * np.pi) ** 2 * np.linalg.det(cov))

    def lnpost_v(x):
        return -0.5 * torch.einsum("bi,ij,bj->b", x, prec, x) + norm

    res = run_polychord(lnpost_v, _box, 2, _gen(4), n_live=400, max_iter=8000, rng=5)
    assert res.logz == pytest.approx(np.log(1.0 / 2.0 ** 2), abs=max(3 * res.logzerr, 0.15))
    np.testing.assert_allclose(np.cov(res.posterior.T), cov, rtol=0.25, atol=0.1 * sigma ** 2)


def test_polychord_dynamic_threads():
    sigma, d, min_ess = 0.1, 3, 1200
    res = run_polychord(_gauss(sigma), _box, d, _gen(5), n_live=200, n_batch=8, dlogz=0.01, min_ess=min_ess,
                        rng=7, dynamic=True)
    assert res.dynamic_rounds >= 1
    assert res.ess >= min_ess and not res.truncated
    assert res.logz == pytest.approx(np.log(1.0 / 2.0 ** d), abs=max(3 * res.logzerr, 0.1))
    np.testing.assert_allclose(res.posterior.std(axis=0), sigma, rtol=0.15)


def test_core_hook(tmp_path):
    path = str(tmp_path / "ckpt.pkl")
    kw = dict(n_live=40, max_iter=80, n_batch=4, rng=0, checkpoint=path)
    run_nested(_gauss(0.3), _box, 2, _gen(0), **kw)
    with pytest.raises(CheckpointConfigError):
        run_nested(_gauss(0.3), _box, 2, _gen(0), core=_polychord_core, resume=True, **kw)
    with pytest.raises(ValueError, match="core= runs one problem at a time"):
        run_nested(_gauss(0.3), _box, 2, _gen(0), n_live=40, n_runs=2, core=_polychord_core)


def test_fit_polychord_matches_fit_multinest():
    """``BasicStarModel.fit_polychord`` on a single star of the small
    synthetic grid: the samples are a ``Frame`` with lnprob, and the
    evidence agrees with ``fit_multinest``'s within 3 combined logzerr (the
    JAX package's bar between the two samplers, ``tests/test_polychord.py``)."""
    from isochrones_torch import get_ichrone
    from isochrones_torch.starmodel import SingleStarModel
    from isochrones_torch.summary import Frame

    iso = get_ichrone("synthetic", device="cpu", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    Teff, logg, feh, mags = iso.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
    m = SingleStarModel(iso, Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), feh=(float(feh), 0.1),
                        J=(float(mags[0]), 0.02), H=(float(mags[1]), 0.02), K=(float(mags[2]), 0.02),
                        parallax=(5.0, 0.05))
    mn = m.fit_multinest(n_live_points=100, n_batch=25, n_chains=8, seed=1)
    pc = m.fit_polychord(n_live_points=100, n_batch=25, n_repeat=4, seed=2)
    assert isinstance(m.samples, Frame) and np.isfinite(m.samples["lnprob"]).all()
    assert m.evidence == (pc.logz, pc.logzerr)
    assert abs(pc.logz - mn.logz) < 3.0 * np.hypot(pc.logzerr, mn.logzerr), (pc.logz, mn.logz)
    lo, hi = np.quantile(m.samples["distance"], [0.005, 0.995])
    assert lo < 200.0 < hi
