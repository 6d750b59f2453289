"""Star-model machinery shared by the models (counterpart of
``isochrones_tpu/starmodel.py``, ``BasicStarModel`` subset).

The port's models compose ``lnprior`` and ``lnlike`` into one batched
``lnpost_batch: (B, n_params) -> (B,)`` on the interpolator's device, and fit
it with the on-device ensemble sampler. The single/binary/triple likelihood
of the JAX ``BasicStarModel`` (and its fused lnpost) waits for a later port;
here a subclass supplies ``param_names``, ``bounds``,
``_build_lnlike_batch`` and ``_build_lnprior_batch``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["BasicStarModel"]


class BasicStarModel:
    """Posterior composition, host scalar API and ``fit_mcmc``."""

    @property
    def ic(self):
        return self._ic

    @property
    def device(self) -> torch.device:
        return self.ic.device

    @property
    def dtype(self) -> torch.dtype:
        return self.ic.dtype

    @property
    def n_params(self):
        return len(self.param_names)

    # ------------------------------------------------------------- bounds
    def bounds(self, prop):
        raise NotImplementedError

    def set_bounds(self, **kwargs):
        for k, v in kwargs.items():
            self._bounds[k] = tuple(v)
            if k in self._priors and hasattr(self._priors[k], "bounds"):
                self._priors[k].bounds = tuple(v)
        self._fn_cache.clear()

    def _bounds_arrays(self):
        los, his = zip(*(self.bounds(p) for p in self.param_names))
        return np.array(los, dtype=float), np.array(his, dtype=float)

    # ------------------------------------------------------- batched posterior
    def _build_lnlike_batch(self):
        raise NotImplementedError

    def _build_lnprior_batch(self):
        raise NotImplementedError

    def _get_fn(self, name):
        """The batched ``lnlike``/``lnprior``/``lnpost`` closures, built once
        per bounds setting."""
        cache: Dict[str, object] = self._fn_cache
        if name not in cache:
            lnlike = self._build_lnlike_batch()
            lnprior = self._build_lnprior_batch()

            def lnpost(pars):
                lnpr = lnprior(pars)
                ll = lnlike(pars)
                ll = torch.where(torch.isnan(ll), float("-inf"), ll)
                return torch.where(torch.isfinite(lnpr), lnpr + ll, float("-inf"))

            cache.update(lnlike=lnlike, lnprior=lnprior, lnpost=lnpost)
        return cache[name]

    def _as_params(self, p):
        return torch.as_tensor(p, dtype=self.dtype, device=self.device)

    def lnpost_batch(self, p):
        """(B, n_params) -> (B,) log-posterior tensor on the model's device."""
        return self._get_fn("lnpost")(self._as_params(p))

    def lnlike_batch(self, p):
        return self._get_fn("lnlike")(self._as_params(p))

    def lnprior_batch(self, p):
        return self._get_fn("lnprior")(self._as_params(p))

    def _eval_scalar(self, fn, p):
        return float(fn(self._as_params(p)[None, :])[0])

    def lnlike(self, p):
        return self._eval_scalar(self._get_fn("lnlike"), p)

    def lnprior(self, p):
        return self._eval_scalar(self._get_fn("lnprior"), p)

    def lnpost(self, p):
        return self._eval_scalar(self._get_fn("lnpost"), p)

    # ------------------------------------------------------------------ fitting
    def emcee_p0(self, nwalkers, rng=None):
        raise NotImplementedError

    def fit_mcmc(self, nwalkers=300, nburn=200, niter=100, thin=1, p0=None, seed=None, moves="stretch"):
        """On-device affine-invariant ensemble MCMC (reference
        starmodel.py:886-972). ``moves``: "stretch", "de", "snooker", "kde"
        or "mixed". Returns a dict of column name -> numpy array with the
        parameter columns and ``"lnprob"``; the final sampler state (with its
        acceptance counts) is kept as ``self.sampler_state``."""
        from .samplers.ensemble import run_ensemble

        if p0 is None:
            p0 = self.emcee_p0(nwalkers, rng=seed)
        p0 = self._as_params(p0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        lnpost = self._get_fn("lnpost")

        _, _, state = run_ensemble(lnpost, p0, gen, n_steps=nburn, moves=moves)
        chain, ln_chain, state = run_ensemble(lnpost, state.walkers, gen, n_steps=niter, thin=thin,
                                              moves=moves)
        flat = chain.reshape(-1, self.n_params).cpu().numpy()
        samples = {name: flat[:, i] for i, name in enumerate(self.param_names)}
        samples["lnprob"] = ln_chain.reshape(-1).cpu().numpy()
        self._samples = samples
        self.sampler_state = state
        return samples

    @property
    def samples(self):
        if self._samples is None:
            raise AttributeError("No samples yet; run .fit_mcmc()")
        return self._samples
