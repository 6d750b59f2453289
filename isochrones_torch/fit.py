"""Convergence-driven MCMC harness with checkpoint and resume.

Counterpart of ``isochrones_tpu/fit.py`` (the reference's emcee3 harness,
``isochrones/fit.py:9-170``: a chain checkpoint that a run resumes, an
autocorrelation-based loop until ``targetn`` effective samples, burn-in
discard, thinned samples saved). The sampler is the on-device
affine-invariant ensemble (:func:`~isochrones_torch.samplers.ensemble.run_ensemble`):
each ``iter_chunksize`` chunk runs on the model's device; the convergence
diagnostics and the checkpoint run on the host between chunks. The machine
with the card has neither ``h5py`` nor ``pandas``: the checkpoint is an
``.npz`` file, as the port's results files are, and the samples' CSV is
written without pandas.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .logger import getLogger
from .samplers.ensemble import autocorr_time, run_ensemble
from .summary import Frame

__all__ = [
    "fit_mcmc_convergent",
    "fit_emcee3",
    "write_samples",
    "McmcBackend",
    "Emcee3Model",
    "Emcee3PriorModel",
]


class Emcee3Model:
    """A star model's posterior split into prior and likelihood callables
    (reference fit.py:9-20; the emcee3 Model protocol collapses to plain
    functions: the sampler takes the batched posterior directly)."""

    def __init__(self, mod):
        self.mod = mod

    def compute_log_prior(self, coords):
        return self.mod.lnprior(coords)

    def compute_log_likelihood(self, coords):
        return self.mod.lnlike(coords)

    def __call__(self, coords):
        return self.compute_log_prior(coords) + self.compute_log_likelihood(coords)


class Emcee3PriorModel(Emcee3Model):
    """The prior alone (reference fit.py:23-34)."""

    def compute_log_likelihood(self, coords):
        return 0.0


class McmcBackend:
    """The chain checkpoint (the emcee3 HDFBackend's role, reference
    fit.py:79-86), an ``.npz`` file holding ``chain``, ``ln_prob`` and the
    parameter names; written atomically."""

    def __init__(self, filename=None):
        self.filename = filename

    def load(self):
        """``(chain (n_iter, n_walkers, n_params), ln_prob (n_iter,
        n_walkers))`` numpy arrays, or None without a checkpoint."""
        if self.filename is None or not os.path.exists(self.filename):
            return None
        with np.load(self.filename, allow_pickle=False) as f:
            if "chain" not in f:
                return None
            return np.asarray(f["chain"]), np.asarray(f["ln_prob"])

    def save(self, chain, ln_prob, columns):
        if self.filename is None:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.filename)), exist_ok=True)
        tmp = f"{self.filename}.tmp.npz"
        np.savez(tmp, chain=np.asarray(chain), ln_prob=np.asarray(ln_prob), columns=json.dumps(list(columns)))
        os.replace(tmp, self.filename)

    def reset(self):
        if self.filename is not None and os.path.exists(self.filename):
            os.remove(self.filename)


def write_samples(mod, df, resultsdir="mcmc_results"):
    """Write the samples ``df`` (a :class:`~isochrones_torch.summary.Frame`
    or a dict of columns) to ``<resultsdir>/<mod.name>.csv``, without the
    index (reference fit.py:37-44, CSV in place of PyTables). Returns the
    file name."""
    os.makedirs(resultsdir, exist_ok=True)
    samplefile = os.path.join(resultsdir, f"{mod.name}.csv")
    Frame(df).to_csv(samplefile, index=False)
    return samplefile


def fit_mcmc_convergent(
    mod,
    nwalkers=500,
    verbose=False,
    nsamples=5000,
    targetn=4,
    iter_chunksize=200,
    overwrite=False,
    maxiter=10,
    sample_directory="mcmc_chains",
    nburn=2,
    resultsdir="mcmc_results",
    prior_only=False,
    seed=None,
    moves="mixed",
    **kwargs,
):
    """Run the ensemble sampler in chunks until ``targetn`` effective samples
    (reference fit_emcee3, fit.py:47-170). The chain is checkpointed to
    ``<sample_directory>/<mod.name>.npz`` after every chunk; a later call
    with the same number of walkers loads it and continues it from its last
    walkers (``overwrite`` starts afresh). Returns the samples (a
    :class:`~isochrones_torch.summary.Frame` with ``"lnprob"``), also written
    by :func:`write_samples` and kept as the model's samples.

    nburn : the number of autocorrelation times discarded as burn-in.
    moves : the proposal mixture; "mixed" (KDE/DE/snooker 0.4/0.4/0.2, the
        reference harness's mixedmoves=True) by default; small ensembles fall
        back to DE/snooker.
    """
    logger = getLogger()
    backend = McmcBackend(os.path.join(sample_directory, f"{mod.name}.npz") if sample_directory is not None else None)
    if overwrite:
        backend.reset()
    lnpost = mod.lnprior_batch if prior_only else mod.lnpost_batch

    prev = backend.load()
    chains, lns = [], []
    if prev is not None and prev[0].shape[1] == nwalkers:
        chains.append(prev[0])
        lns.append(prev[1])
        coords = mod._as_params(prev[0][-1])
    else:
        coords = mod._as_params(np.asarray(mod.sample_from_prior(nwalkers, require_valid=True, values=True, rng=seed),
                                           dtype=float))
    gen = torch.Generator(device=mod.device)
    gen.manual_seed(seed if seed is not None else 0)

    def calc_stats():
        full = np.concatenate(chains, axis=0)
        tau_max = float(np.nanmax(autocorr_time(full)))
        neff = full.shape[0] / max(tau_max, 1e-9) - nburn
        if verbose:
            logger.info("Maximum autocorrelation time: %s", tau_max)
            logger.info("N_eff: %s (%s)", neff * nwalkers, neff)
        return tau_max, neff

    done = False
    tau_max = 0.0
    if chains:
        tau_max, neff = calc_stats()
        done = neff > targetn

    for iteration in range(maxiter):
        if done:
            break
        if verbose:
            logger.info("Iteration %d...", iteration + 1)
        with torch.no_grad():
            chunk, ln_chunk, state = run_ensemble(lnpost, coords, gen, n_steps=iter_chunksize, moves=moves)
        coords = state.walkers
        chains.append(chunk.cpu().numpy())
        lns.append(ln_chunk.cpu().numpy())
        backend.save(np.concatenate(chains, axis=0), np.concatenate(lns, axis=0), mod.param_names)
        tau_max, neff = calc_stats()
        done = neff > targetn

    full = np.concatenate(chains, axis=0)
    full_ln = np.concatenate(lns, axis=0)
    if not done:
        logger.warning("fit_mcmc_convergent: not converged after maxiter=%d chunks (tau_max=%.0f, need neff > %s); "
                       "samples may be unreliable.", maxiter, tau_max, targetn)
    # never burn the whole chain: a non-converged tau_max can exceed its length
    burnin = min(int(nburn * tau_max), full.shape[0] // 2)
    samples = full[burnin:].reshape(-1, full.shape[-1])
    ln_flat = full_ln[burnin:].reshape(-1)
    ntot = min(nsamples, len(samples))
    if verbose:
        logger.info("Discarding %d steps for burn-in", burnin)
        logger.info("Randomly choosing %d samples", ntot)
    inds = np.random.default_rng(seed).choice(len(samples), size=ntot, replace=False)
    df = mod._set_samples(samples[inds], ln_flat[inds])
    write_samples(mod, df, resultsdir=resultsdir)
    return df


def fit_emcee3(mod, mixedmoves=True, pool=None, **kwargs):
    """The reference's name for :func:`fit_mcmc_convergent` (reference
    fit.py:47-170). ``mixedmoves`` picks the ``moves`` mixture; ``pool`` is
    accepted and ignored (the parallelism is the device's batch)."""
    kwargs.setdefault("moves", "mixed" if mixedmoves else "stretch")
    return fit_mcmc_convergent(mod, **kwargs)
