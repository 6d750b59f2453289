"""Port parity: the tensor ``lnpdf`` of each concrete prior against the JAX
package's ``lnpdf_jax``, float64, including out-of-bounds and NaN points.
Values within rtol 1e-12; the -inf and NaN patterns must be identical."""

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
