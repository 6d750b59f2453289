"""The fits of the joint isochrone + track model,
``isochrones_torch.starmodel.IsoTrackModel``, against the JAX package on the
small synthetic pair (the models of ``tests/test_torch_isotrack.py``):

- a seeded short ``fit_mcmc`` (runs to its end, finite, the distance's 95%
  interval holds the truth) and a seeded ``fit_multinest`` in each package
  (evidence within the two runs' combined logzerr);
- ``derived_samples`` and ``save_hdf`` raising ``TypeError`` in both
  packages (the reference calls the track interpolator with six columns).

Torch runs on one thread from the module's first fixture on: at these sizes a
pool of threads beside the other test workers' is many times slower.
"""

import numpy as np
import pytest
import torch

from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_torch import get_ichrone
from test_torch_isotrack import _DIMS, _TRUTH, _models


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """The synthetic pair: (port iso, port track, JAX iso, JAX track)."""
    return {"synthetic": (get_ichrone("synthetic", device="cpu", **_DIMS),
                          get_ichrone("synthetic", tracks=True, device="cpu", **_DIMS),
                          jax_get_ichrone("synthetic", **_DIMS), jax_get_ichrone("synthetic", tracks=True, **_DIMS))}


@pytest.fixture(scope="module")
def mcmc_fit(pairs):
    """A seeded short MCMC in the port: ``(samples, the port model)``."""
    tm, _ = _models(pairs, "synthetic")
    return tm.fit_mcmc(nwalkers=32, nburn=100, niter=50, seed=0), tm


@pytest.fixture(scope="module")
def nested_fits(pairs):
    """A seeded 100-live-point nested fit in each package (both with
    ``n_batch=16``, ``n_chains=8``): ``(port result, JAX result, port model,
    JAX model)``."""
    tn, jm = _models(pairs, "synthetic")
    nested = dict(n_live_points=100, n_batch=16, n_chains=8, seed=0)
    return tn.fit_multinest(**nested), jm.fit_multinest(**nested), tn, jm


def test_fit_mcmc(mcmc_fit):
    ts, tm = mcmc_fit
    assert set(ts) == set(tm.param_names) | {"lnprob"} and len(ts["lnprob"]) == 32 * 50
    assert np.isfinite(ts["lnprob"]).all()
    assert tm.sampler is tm.sampler_state and int(tm.sampler.n_accept.sum()) > 0
    d = ts["distance"]
    assert np.quantile(d, 0.025) < _TRUTH["synthetic"][3] < np.quantile(d, 0.975)


def test_fit_multinest(nested_fits):
    tr, _, tn, jn = nested_fits
    (tz, tzerr), (jz, jzerr) = tn.evidence, jn.evidence
    assert np.isfinite(tz) and tn.mnest_analyzer is tr and tzerr > 0
    assert abs(tz - jz) < np.hypot(tzerr, jzerr), (tn.evidence, jn.evidence)
    d = tn.samples["distance"]
    assert np.quantile(d, 0.025) < _TRUTH["synthetic"][3] < np.quantile(d, 0.975)


def test_derived_samples_raise_type_error(mcmc_fit, nested_fits, tmp_path):
    """The reference's quirk, kept: both packages call the track
    interpolator with all six columns."""
    tm, jm = mcmc_fit[1], nested_fits[3]
    for m in (tm, jm):
        with pytest.raises(TypeError):
            m.derived_samples
    with pytest.raises(TypeError):
        tm.save_hdf(str(tmp_path / "isotrack.npz"))
    with pytest.raises(TypeError):
        jm.save_hdf(str(tmp_path / "isotrack.h5"))
