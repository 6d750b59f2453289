"""The port's NUTS (``isochrones_torch.samplers.nuts``) on the CPU.

- ``_popcount`` and ``_trailing_zeros`` on int64 tensors equal the JAX
  package's on uint32 arrays, bit for bit, over 0, powers of two, their
  neighbours and seeded words up to 2**32 - 1;
- exact-target statistics (``tests/test_nuts.py``'s Gaussian target and
  mass-matrix test, the same bars at 300 + 600 and 400 + 400 transitions in
  place of 500 + 1000 and 600 + 600): a correlated 4-d Gaussian (no divergence,
  acceptance above 0.6, means within 5 effective standard errors with tau ~
  10, covariance within 12% of its largest entry) and a badly scaled 3-d one
  (each scale within a factor 1.6, the adapted inverse masses three decades
  apart);
- the frozen-sampler guard warns for a step size below 100 * eps(dtype) and
  counts those chains;
- ``mesh=`` takes a :class:`~isochrones_torch.parallel.Mesh` and refuses
  anything else (``tests/test_torch_parallel.py`` holds sharded NUTS to the
  unsharded run).

The star-model parity with ``fit_multinest`` is ``tests/test_torch_nuts_parity.py``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isochrones_tpu.samplers.nuts import _popcount as jax_popcount
from isochrones_tpu.samplers.nuts import _trailing_zeros as jax_trailing_zeros
from isochrones_torch.samplers.nuts import NutsResult, _popcount, _trailing_zeros, _warn_frozen, run_nuts


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


def test_bit_tricks_match_jax():
    rng = np.random.default_rng(0)
    pows = np.array([1 << k for k in range(32)], dtype=np.int64)
    words = np.concatenate([[0, 1, 2, 3, 2 ** 32 - 1], pows, pows - 1, pows + 1, np.arange(600),
                            rng.integers(0, 2 ** 32, 2000)]) % (2 ** 32)
    t = torch.as_tensor(words, dtype=torch.int64)
    j = jnp.asarray(words.astype(np.uint32))
    np.testing.assert_array_equal(_popcount(t).numpy(), np.asarray(jax_popcount(j)))
    np.testing.assert_array_equal(_trailing_zeros(t).numpy(), np.asarray(jax_trailing_zeros(j)))
    assert _popcount(t).dtype == torch.int64


def test_gaussian_target():
    dim = 4
    rng = np.random.default_rng(0)
    A = rng.normal(size=(dim, dim))
    cov = A @ A.T + dim * np.eye(dim)
    prec = torch.as_tensor(np.linalg.inv(cov))
    mu_np = np.array([1.0, -2.0, 0.5, 3.0])
    mu = torch.as_tensor(mu_np)

    def logp(x):
        d = x - mu
        return -0.5 * torch.einsum("bi,ij,bj->b", d, prec, d)

    x0 = torch.as_tensor(rng.normal(size=(8, dim)))
    res = run_nuts(logp, x0, _gen(0), n_warmup=300, n_samples=600)
    assert isinstance(res, NutsResult)
    assert res.samples.shape == (600, 8, dim) and res.lnp.shape == (600, 8)
    assert res.n_divergent.sum() == 0
    assert (res.accept_rate > 0.6).all()
    flat = res.samples.reshape(-1, dim)
    se = np.sqrt(np.diag(cov) / (len(flat) / 10))
    assert (np.abs(flat.mean(0) - mu_np) < 5 * se).all()
    rel = np.abs(np.cov(flat.T) - cov).max() / np.abs(cov).max()
    assert rel < 0.12


def test_mass_matrix_adaptation():
    """A badly scaled Gaussian: adaptation learns the per-dimension variances."""
    scales = torch.tensor([0.01, 1.0, 100.0], dtype=torch.float64)

    def logp(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(rng.normal(size=(4, 3)))
    res = run_nuts(logp, x0, _gen(1), n_warmup=400, n_samples=400)
    stds = res.samples.reshape(-1, 3).std(axis=0)
    ratio = stds / scales.numpy()
    assert (np.abs(np.log(ratio)) < np.log(1.6)).all(), ratio
    im = res.inv_mass.mean(axis=0)
    assert im[2] / im[0] > 1e3


def test_frozen_chain_warning(caplog):
    eps32 = float(torch.finfo(torch.float32).eps)
    logger = logging.getLogger("isochrones_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="isochrones_torch"):
            assert _warn_frozen(np.array([0.1, 50 * eps32, 0.2, 10 * eps32]), torch.float32) == 2
        assert "2/4 chains adapted a step size below the torch.float32 resolution floor" in caplog.text
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="isochrones_torch"):
            assert _warn_frozen(np.array([50 * eps32]), torch.float64) == 0
        assert "frozen" not in caplog.text
    finally:
        logger.removeHandler(caplog.handler)


def test_mesh_not_ported():
    with pytest.raises(TypeError, match="Mesh"):
        run_nuts(lambda x: -x.pow(2).sum(-1), torch.zeros(2, 2, dtype=torch.float64), _gen(0), mesh=object())


@pytest.mark.parametrize("kind", ["tree", "isotrack"])
def test_fit_nuts_on_other_models(kind):
    """``fit_nuts`` is every star model's: a short seeded run on the tree
    ``StarModel`` (tests/star1: spectroscopy, 2MASS and WISE, no parallax) and
    on ``IsoTrackModel`` (a star with a 5 mas parallax) returns finite lnprob
    for every draw and draws inside the bounds; the joint model's distance
    posterior sits around the parallax's 200 pc."""
    import os

    from isochrones_torch import get_ichrone
    from isochrones_torch.starmodel import IsoTrackModel
    from isochrones_torch.treemodel import StarModel

    if kind == "tree":
        ic = get_ichrone("synthetic", device="cpu", n_feh=7, n_mass=30, n_eep=100, n_age=30)
        m = StarModel.from_ini(ic, os.path.join(os.path.dirname(os.path.abspath(__file__)), "star1"))
    else:
        dims = dict(n_feh=5, n_mass=20, n_eep=60, n_age=20)
        iso = get_ichrone("synthetic", device="cpu", **dims)
        track = get_ichrone("synthetic", tracks=True, device="cpu", **dims)
        Teff, logg, _, mags = iso.interp_mag([30.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
        m = IsoTrackModel(iso, track, Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), J=(float(mags[0]), 0.02),
                          H=(float(mags[1]), 0.02), K=(float(mags[2]), 0.02), parallax=(5.0, 0.05))
    samples = m.fit_nuts(n_chains=2, n_warmup=40, n_samples=40, max_depth=5, seed=0)
    assert len(samples["lnprob"]) == 80 and np.isfinite(samples["lnprob"]).all()
    los, his = m._bounds_arrays()
    for name, lo, hi in zip(m.param_names, los, his):
        assert (samples[name] >= lo).all() and (samples[name] <= hi).all(), name
    if kind == "isotrack":
        assert abs(np.median(samples["distance"]) - 200.0) < 20.0
