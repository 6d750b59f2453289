"""The port's convergence-driven MCMC harness (``isochrones_torch.fit``, the
emcee3-harness role) on the CPU, small synthetic grid:

- ``fit_mcmc_convergent`` checkpoints its chain after every chunk and writes
  its samples; a second call with the same walkers loads the checkpoint and
  continues that chain from its last walkers (the saved chain is a prefix of
  the resumed one, bitwise, and the first new step starts from the old last
  walkers);
- the ``McmcBackend`` round trip (chain, ln_prob and the parameter names,
  exact; no file: None; ``reset``);
- ``write_samples`` writes ``DataFrame.to_csv(index=False)``'s layout;
- prior-only sampling roams the prior, and ``fit_emcee3`` is the same run;
- the harness's arithmetic against the JAX package's ``fit_mcmc_convergent``
  on one fixed, seeded chain fed to both in place of the sampler (an AR(1)
  walk, autocorrelation time 19), with targets that stop the run after some
  chunks: the same chunk count (the neff stop test), the same burn-in (``min(nburn * tau, len / 2)``), the same draw,
  bitwise, and the same checkpointed chain, fresh and resumed;
- the whole harness, sampler included, on an analytic 3-d Gaussian: the
  samples' mean within 0.15 sigma and each variance within 20% of the
  target's (over the seeds 0-4 the largest errors read 0.062 sigma and 6.2%).
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from isochrones_torch import get_ichrone
from isochrones_torch.fit import Emcee3Model, Emcee3PriorModel, McmcBackend, fit_emcee3, fit_mcmc_convergent, \
    write_samples
from isochrones_torch.starmodel import SingleStarModel
from isochrones_torch.summary import Frame


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    iso = get_ichrone("synthetic", device="cpu", n_feh=7, n_mass=30, n_eep=100, n_age=30)
    Teff, logg, _, mags = iso.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
    return SingleStarModel(iso, Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), J=(float(mags[0]), 0.02),
                           parallax=(5.0, 0.05), name="harness-star")


def test_convergent_fit_and_resume(tmp_path, model):
    sample_dir, results_dir = str(tmp_path / "chains"), str(tmp_path / "results")
    kw = dict(nwalkers=32, targetn=2, iter_chunksize=40, sample_directory=sample_dir, resultsdir=results_dir)
    df = fit_mcmc_convergent(model, maxiter=2, nsamples=500, seed=0, **kw)
    assert isinstance(df, Frame) and model.samples is df
    assert len(df["lnprob"]) <= 500 and np.isfinite(df["lnprob"]).all()
    ckpt = os.path.join(sample_dir, "harness-star.npz")
    assert os.path.exists(ckpt) and os.path.exists(os.path.join(results_dir, "harness-star.csv"))
    backend = McmcBackend(ckpt)
    chain, ln = backend.load()
    assert chain.shape[1:] == (32, model.n_params) and ln.shape == chain.shape[:2]
    with np.load(ckpt) as f:
        assert json.loads(str(f["columns"])) == list(model.param_names)

    df2 = fit_mcmc_convergent(model, maxiter=1, nsamples=300, seed=1, targetn=1e6,
                              **{k: v for k, v in kw.items() if k != "targetn"})
    chain2, ln2 = backend.load()
    assert chain2.shape[0] == chain.shape[0] + 40
    np.testing.assert_array_equal(chain2[:len(chain)], chain)
    np.testing.assert_array_equal(ln2[:len(ln)], ln)
    # the continuation starts from the loaded last walkers: each walker's first
    # new position is its old last one or a proposal accepted from there
    step = np.abs(chain2[len(chain)] - chain[-1]).max(axis=1)
    assert (step == 0).any() and np.isfinite(chain2).all()
    assert len(df2["lnprob"]) <= 300


def test_backend_round_trip(tmp_path):
    b = McmcBackend(str(tmp_path / "sub" / "c.npz"))
    assert b.load() is None
    rng = np.random.default_rng(0)
    chain, ln = rng.normal(size=(5, 4, 3)), rng.normal(size=(5, 4))
    b.save(chain, ln, ["a", "b", "c"])
    got = b.load()
    np.testing.assert_array_equal(got[0], chain)
    np.testing.assert_array_equal(got[1], ln)
    with np.load(b.filename) as f:
        assert json.loads(str(f["columns"])) == ["a", "b", "c"]
    b.reset()
    assert b.load() is None
    assert McmcBackend(None).load() is None


def test_write_samples(tmp_path, model):
    df = Frame({"eep": np.array([1.5, 2.25]), "age": np.array([9.0, np.nan]), "lnprob": np.array([-1.0, -2.0])})
    path = write_samples(model, df, resultsdir=str(tmp_path))
    assert path == os.path.join(str(tmp_path), "harness-star.csv")
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows == [["eep", "age", "lnprob"], ["1.5", "9.0", "-1.0"], ["2.25", "", "-2.0"]]


def test_prior_only_and_alias(tmp_path, model):
    kw = dict(nwalkers=32, targetn=1, iter_chunksize=50, maxiter=1, nsamples=200, sample_directory=None,
              resultsdir=str(tmp_path), prior_only=True, seed=0)
    df = fit_mcmc_convergent(model, **kw)
    # the prior reaches far past the posterior (the distance prior to ~400 pc)
    assert np.std(df["distance"]) > 20
    df2 = fit_emcee3(model, **kw)
    np.testing.assert_array_equal(df2["distance"], df["distance"])
    p = [60.0, 9.0, 0.0, 200.0, 0.1]
    assert Emcee3Model(model)(p) == pytest.approx(model.lnpost(p))
    assert Emcee3PriorModel(model)(p) == pytest.approx(model.lnprior(p))


class _Gaussian:
    """The members of a star model that the harness uses, for a Gaussian
    target with mean ``MU`` and standard deviations ``SIG``."""

    MU = np.array([1.0, -2.0, 0.5])
    SIG = np.array([0.5, 2.0, 1.0])
    name = "gauss"
    param_names = ("a", "b", "c")
    n_params = 3
    device = torch.device("cpu")

    def _as_params(self, p):
        return torch.as_tensor(p, dtype=torch.float64)

    def lnpost_batch(self, p):
        return -0.5 * (((self._as_params(p) - torch.as_tensor(self.MU)) / torch.as_tensor(self.SIG)) ** 2).sum(-1)

    lnprior_batch = lnpost_batch

    def sample_from_prior(self, n, require_valid=True, values=True, rng=None):
        return self.MU + 3.0 * self.SIG * np.random.default_rng(rng).normal(size=(n, 3))

    def _set_samples(self, params, lnprob):
        df = Frame({k: params[:, i] for i, k in enumerate(self.param_names)})
        df["lnprob"] = lnprob
        self._samples = df
        return df


def _ar1_chunks(n_chunks, n_steps, nwalkers, seed, rho=0.9):
    """Seeded AR(1) chunks ``(chain (n_steps, nwalkers, 3), ln (n_steps,
    nwalkers))``, autocorrelation time (1 + rho) / (1 - rho) = 19."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nwalkers, 3))
    out = []
    for _ in range(n_chunks):
        chunk = np.empty((n_steps, nwalkers, 3))
        for i in range(n_steps):
            x = rho * x + np.sqrt(1 - rho ** 2) * rng.normal(size=x.shape)
            chunk[i] = x
        out.append((chunk, -0.5 * (chunk ** 2).sum(-1)))
    return out


class _Feed:
    """A stand-in for ``run_ensemble`` that hands out the fixed chunks in
    order, as numpy arrays or torch tensors, and counts its calls."""

    def __init__(self, chunks, as_torch):
        self.chunks, self.as_torch, self.calls = chunks, as_torch, 0

    def __call__(self, lnpost, coords, key, n_steps, moves="mixed"):
        chunk, ln = self.chunks[self.calls]
        assert chunk.shape[0] == n_steps
        self.calls += 1
        if self.as_torch:
            chunk, ln = torch.as_tensor(chunk), torch.as_tensor(ln)
        return chunk, ln, type("State", (), {"walkers": chunk[-1]})()


@pytest.mark.parametrize("targetn, maxiter, nburn", [(14, 10, 2), (1e6, 3, 2), (8, 6, 5)])
def test_convergent_arithmetic_matches_jax(tmp_path, monkeypatch, targetn, maxiter, nburn):
    import jax

    jax.config.update("jax_enable_x64", True)
    import isochrones_tpu.fit as jfit
    import isochrones_torch.fit as tfit

    nwalkers, n_steps = 16, 40
    chunks = _ar1_chunks(12, n_steps, nwalkers, seed=int(targetn) % 7 + maxiter)
    feeds = {}
    got = {}
    for name, mod, as_torch in (("jax", jfit, False), ("torch", tfit, True)):
        feeds[name] = _Feed(chunks, as_torch)
        monkeypatch.setattr(mod, "run_ensemble", feeds[name])
        model = _Gaussian()
        kw = dict(nwalkers=nwalkers, iter_chunksize=n_steps, targetn=targetn, maxiter=maxiter, nburn=nburn,
                  nsamples=300, seed=3, sample_directory=str(tmp_path / name / "chains"),
                  resultsdir=str(tmp_path / name / "results"))
        df = mod.fit_mcmc_convergent(model, **kw)
        first = feeds[name].calls
        # a second call resumes the checkpoint and runs on while neff <= targetn
        df2 = mod.fit_mcmc_convergent(model, **dict(kw, maxiter=2, seed=4))
        chain, ln = mod.McmcBackend(os.path.join(kw["sample_directory"],
                                                 "gauss." + ("h5" if name == "jax" else "npz"))).load()
        got[name] = (first, feeds[name].calls, [np.asarray(df[c]) for c in ("a", "b", "c", "lnprob")],
                     [np.asarray(df2[c]) for c in ("a", "b", "c", "lnprob")], chain, ln)
    j, t = got["jax"], got["torch"]
    assert t[0] == j[0] and t[1] == j[1]  # the same chunks run, fresh and resumed
    for a, b in zip(t[2] + t[3], j[2] + j[3]):
        np.testing.assert_array_equal(a, b)  # the same burn-in and draw
    np.testing.assert_array_equal(t[4], j[4])
    np.testing.assert_array_equal(t[5], j[5])
    if targetn == 1e6:  # never converges: the burn-in stops at half the chain
        assert t[1] == maxiter + 2 and len(t[2][0]) == min(300, nwalkers * maxiter * n_steps // 2)
    else:  # the stop test ends the run after more than one chunk, before maxiter
        assert 1 < t[0] < maxiter and t[1] == t[0]


def test_convergent_gaussian_target(tmp_path):
    model = _Gaussian()
    df = fit_mcmc_convergent(model, nwalkers=32, iter_chunksize=200, targetn=40, maxiter=20, nsamples=8000,
                             seed=0, sample_directory=None, resultsdir=str(tmp_path))
    x = np.stack([df[c] for c in model.param_names], axis=1)
    assert len(x) == 8000 and np.isfinite(df["lnprob"]).all()
    assert np.all(np.abs(x.mean(axis=0) - model.MU) < 0.15 * model.SIG)
    assert np.all(np.abs(x.var(axis=0) / model.SIG ** 2 - 1.0) < 0.2)
