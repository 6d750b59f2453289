"""Star models (counterpart of ``isochrones_tpu/starmodel.py``):
``BasicStarModel`` and the flat single/binary/triple models.

``lnprior`` and ``lnlike`` compose into one batched ``lnpost_batch: (B,
n_params) -> (B,)`` on the interpolator's device. With the default priors
the posterior is the fused one: one interpolation per component over the
6-column packed table serves both the magnitudes and the EEP
change-of-variables prior (:func:`~isochrones_torch.ops.star.star_lnlike_fused`,
a hand-written CUDA kernel on the card); customized priors or subclasses take
the composed path. ``fit_multinest`` runs the on-device nested sampler,
``fit_mcmc`` the ensemble sampler; fitted samples are dicts of numpy columns.
``save_hdf``/``load_hdf`` keep the reference's names and content but write a
numpy ``.npz`` container (:mod:`isochrones_torch.utils`): the machine with
the card has neither ``h5py`` nor ``pandas``.

Reference quirks kept for parity: the ``+log(sigma)`` Gaussian constant, the
N=3 EEP-ordering test (``and`` where ``or`` was meant) and the ``delta_nu``
term that uses the value as its uncertainty.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .logger import getLogger
from .ops.interp import interp_nd
from .ops.likelihood import gauss_lnprob, star_lnlike
from .ops.star import StarLikelihood, star_lnlike_fused
from .priors import AgePrior, AVPrior, ChabrierPrior, DistancePrior, EEP_prior, FehPrior, eep_change_of_variables
from .summary import Frame
from .utils import addmags, npz_load, npz_save, store_prefix

__all__ = ["BasicStarModel", "SingleStarModel", "BinaryStarModel", "TripleStarModel", "IsoTrackModel", "N_options",
           "index_options"]

_EEP_NAMES = ("eep", "eep_0", "eep_1", "eep_2")


def _eep_lnprior(eep, orig_val, deriv, orig_prior, lo, hi):
    """The EEP change-of-variables prior (``EEP_prior.lnpdf``) from the
    interpolated original quantity and its d/dEEP derivative."""
    ln = eep_change_of_variables(orig_prior, orig_val, deriv)
    return torch.where((eep < lo) | (eep > hi), float("-inf"), ln)


class BasicStarModel:
    """Flat single/binary/triple star model (reference starmodel.py:59-1237).

    Observations are keyword ``name=(value, uncertainty)`` pairs: photometric
    bands of the interpolator's BC grid, spectroscopy (``Teff``, ``logg``,
    ``feh``), ``parallax`` [mas] and asteroseismic ``nu_max``/``delta_nu``.
    """

    use_emcee = False
    #: whether fit_multinest runs dynamic nested sampling by default: off for
    #: the cheap fused flat likelihood, on for models whose calls are costly
    _default_dynamic = False

    # allowable non-band observation keys (reference starmodel.py:95-116)
    _not_a_band = (
        "RA", "dec", "ra", "Dec", "maxAV", "parallax", "AV", "logg", "Teff",
        "feh", "density", "separation", "PA", "resolution", "relative", "N",
        "index", "id", "nu_max", "delta_nu",
    )

    def __init__(self, ic, eep_bounds=None, name="", directory=".", N=1, maxAV=None, max_distance=None,
                 halo_fraction=None, ra=None, dec=None, obs=None, use_emcee=False, **kwargs):
        self._ic = ic
        self._fn_cache: Dict[str, object] = {}
        self.eep_bounds = eep_bounds if eep_bounds is not None else tuple(ic.eep_bounds)
        self.name = str(name)
        self.use_emcee = use_emcee
        self.ra = ra
        self.dec = dec
        self.obs = None

        if N > 1 and ic.eep_replaces == "age":
            raise ValueError("Can only fit multiple stars with IsochroneInterpolator!")
        # shared-parameter indices per multiplicity (reference starmodel.py:1396-1419)
        if N == 1:
            if ic.eep_replaces == "age":
                self.mass_index = 0
                self.eep_index = 1
            else:
                self.age_index = 1
                self.eep_index = 0
            self.feh_index = 2
            self.distance_index = 3
            self.AV_index = 4
        elif N == 2:
            self.age_index, self.feh_index, self.distance_index, self.AV_index = 2, 3, 4, 5
        elif N == 3:
            self.age_index, self.feh_index, self.distance_index, self.AV_index = 3, 4, 5, 6
        self.N = N

        kwargs.pop("use_emcee", None)
        self.kwargs = {}
        for k, v in kwargs.items():
            try:
                val, unc = v
                if not (np.isnan(float(val)) or np.isnan(float(unc))):
                    self.kwargs[k] = (np.float64(val), np.float64(unc))
            except (TypeError, ValueError):
                getLogger().warning("kwarg %s=%s ignored!", k, v)

        self._bands = None
        self._spec_props = None
        self._props = None
        self._param_names = None

        # default prior stack (reference starmodel.py:1437-1445)
        self._priors = {
            "mass": ChabrierPrior(),
            "feh": FehPrior(),
            "age": AgePrior(),
            "distance": DistancePrior(),
            "AV": AVPrior(),
        }
        self._priors["eep"] = EEP_prior(self.ic, self._priors[self.ic.eep_replaces], bounds=eep_bounds)

        self._bounds = {
            "mass": None,
            "feh": None,
            "age": None,
            "distance": DistancePrior().bounds,
            "AV": AVPrior().bounds,
            "eep": self._priors["eep"].bounds,
        }
        for par in ["mass", "feh", "age"]:
            self.bounds(par)

        if maxAV is not None:
            self.set_bounds(AV=(0, maxAV))
        if max_distance is not None:
            self.set_bounds(distance=(0, max_distance))
        elif "parallax" in self.kwargs:
            # parallax-derived max distance (reference starmodel.py:1465-1477)
            value, unc = self.kwargs["parallax"]
            if value > 0:
                self.set_bounds(distance=(0, 1.0 / value * 2000))
            elif value < 0:
                self.set_bounds(distance=(0, 1.0 / abs(unc) * 2000))

        if halo_fraction is not None:
            self._priors["feh"] = FehPrior(halo_fraction=halo_fraction)
            self._priors["feh"].bounds = self._bounds["feh"]

        self._directory = str(directory)
        self._samples = None
        self._derived_samples = None
        self._evidence = None
        self._nested_result = None

    # ------------------------------------------------------------------ basics
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
    def directory(self):
        return self._directory

    @property
    def labelstring(self):
        return {1: "single", 2: "binary", 3: "triple"}[self.N]

    @property
    def mnest_basename(self):
        """Where a fit keeps its files (the checkpoint), as the reference's
        MultiNest basename (starmodel.py:736-746)."""
        s = f"{self.ic.name}-{self.labelstring}"
        if self.name:
            s = f"{self.name}-{s}"
        return os.path.join(self.directory, "chains", s + "-")

    @property
    def param_names(self) -> Tuple[str, ...]:
        if self._param_names is None:
            names = tuple(self.ic.param_names)
            if self.N > 1:
                names = tuple(f"eep_{j}" for j in range(self.N)) + tuple(self.ic.param_names[1:])
            self._param_names = names
        return self._param_names

    @property
    def n_params(self):
        return len(self.param_names)

    @property
    def bands(self):
        if self._bands is None:
            bc_cols = set(self.ic.bc.column_index)
            self._bands = [k for k in self.kwargs if k in bc_cols]
        return self._bands

    @property
    def props(self):
        if self._props is None:
            self._props = [k for k in self.kwargs if k in self._not_a_band]
        return self._props

    @property
    def spec_props(self):
        if self._spec_props is None:
            self._spec_props = [self.kwargs.get(k, (np.nan, np.nan)) for k in ["Teff", "logg", "feh"]]
        return self._spec_props

    # ------------------------------------------------------------- priors/bounds
    def bounds(self, prop):
        """Per-parameter bounds, lazily tightened to the grid limits
        (reference starmodel.py:1536-1556)."""
        if prop in _EEP_NAMES:
            prop = "eep"
        if self._bounds[prop] is not None:
            return self._bounds[prop]
        if prop in ("mass", "feh", "age"):
            lo, hi = self.ic.get_limits(prop)
            self._bounds[prop] = (lo, hi)
            self._priors[prop].bounds = (lo, hi)
        else:
            raise ValueError(f"Unknown property {prop}")
        return self._bounds[prop]

    def set_bounds(self, **kwargs):
        for k, v in kwargs.items():
            self._bounds[k] = tuple(v)
            if k in self._priors and hasattr(self._priors[k], "bounds"):
                try:
                    self._priors[k].bounds = tuple(v)
                except ValueError:
                    pass
        self._fn_cache.clear()

    def set_prior(self, **kwargs):
        for prop, prior in kwargs.items():
            self._priors[prop] = prior
            self._bounds[prop] = prior.bounds
        self._fn_cache.clear()

    def _bounds_arrays(self):
        los, his = zip(*(self.bounds(p) for p in self.param_names))
        return np.array(los, dtype=float), np.array(his, dtype=float)

    # ------------------------------------------------------- batched posterior
    def _static_obs(self):
        """Host observation arrays: spectroscopy (NaN = missing), band
        magnitudes and their BC columns."""
        spec_vals = np.array([v for v, _ in self.spec_props], dtype=float)
        spec_uncs = np.array([u for _, u in self.spec_props], dtype=float)
        mag_vals = np.array([self.kwargs[b][0] for b in self.bands], dtype=float)
        mag_uncs = np.array([self.kwargs[b][1] for b in self.bands], dtype=float)
        band_icols = tuple(self.ic.bc.column_index[b] for b in self.bands)
        return spec_vals, spec_uncs, mag_vals, mag_uncs, band_icols

    def _plax(self):
        """The observed (parallax, uncertainty) [mas] as floats, or None."""
        return tuple(float(x) for x in self.kwargs["parallax"]) if "parallax" in self.kwargs else None

    def _primary_pars(self, pars):
        """(..., n_params) -> (..., 5) primary-star user-order parameters."""
        if self.N == 1:
            return pars
        return torch.cat([pars[..., 0:1], pars[..., self.N:]], dim=-1)

    def _build_seismic_lnlike(self):
        """The ``nu_max``/``delta_nu`` terms of the primary on the full model
        table, or None without those observations."""
        if "nu_max" not in self.kwargs:
            return None
        model = self.ic.model
        icols = (model.column_index["nu_max"], model.column_index["delta_nu"])
        io = self.ic._param_index_order
        nu_max, nu_max_unc = (float(x) for x in self.kwargs["nu_max"])
        delta_nu = float(self.kwargs["delta_nu"][0]) if "delta_nu" in self.kwargs else None

        def seismic(pars):
            prim = self._primary_pars(pars)
            gp = torch.stack([prim[..., io[0]], prim[..., io[1]], prim[..., io[2]]], dim=-1)
            sv = interp_nd(model.values, model.knots, gp, icols=icols, axis_maps=model.axis_maps)
            ll = gauss_lnprob(nu_max, nu_max_unc, sv[..., 0])
            if delta_nu is not None:
                # the reference passes the value as the uncertainty
                ll = ll + gauss_lnprob(delta_nu, delta_nu, sv[..., 1])
            return ll

        return seismic

    def _build_lnlike_batch(self):
        ic = self.ic
        N = self.N
        spec_vals, spec_uncs, mag_vals, mag_uncs, band_icols = self._static_obs()
        mag_vals = torch.as_tensor(mag_vals, dtype=self.dtype, device=self.device)
        mag_uncs = torch.as_tensor(mag_uncs, dtype=self.dtype, device=self.device)
        io = tuple(ic._param_index_order)
        dist_idx = self.distance_index
        plax = self._plax()
        seismic = self._build_seismic_lnlike()

        def lnlike_batch(pars):
            ll = star_lnlike(pars, io, spec_vals, spec_uncs, mag_vals, mag_uncs, ic.model_packed,
                             ic._packed_icols, ic.bc, band_icols, n_stars=N)
            if plax is not None:
                ll = ll + gauss_lnprob(plax[0], plax[1], 1000.0 / pars[..., dist_idx])
            if seismic is not None:
                ll = ll + seismic(pars)
            return ll

        return lnlike_batch

    def _ordering_lnprior(self, pars):
        """0 or -inf: the EEP ordering of the components (reference
        starmodel.py:1617-1624, its N=3 condition verbatim)."""
        lnp = torch.zeros(pars.shape[:-1], dtype=pars.dtype, device=pars.device)
        if self.N == 2:
            lnp = torch.where(pars[..., 1] > pars[..., 0], float("-inf"), lnp)
        elif self.N == 3:
            bad = (~(pars[..., 0] > pars[..., 1])) & (pars[..., 1] > pars[..., 2])
            lnp = torch.where(bad, float("-inf"), lnp)
        return lnp

    def _build_lnprior_batch(self):
        priors = self._priors
        param_names = self.param_names
        eep_replaces = self.ic.eep_replaces
        feh_index = self.feh_index
        cond_index = self.mass_index if eep_replaces == "age" else self.age_index
        cond_name = "mass" if eep_replaces == "age" else "age"

        def lnprior_batch(pars):
            lnp = self._ordering_lnprior(pars)
            cond = {cond_name: pars[..., cond_index], "feh": pars[..., feh_index]}
            for i, par in enumerate(param_names):
                val = pars[..., i]
                if par in _EEP_NAMES:
                    lnp = lnp + priors["eep"].lnpdf(val, **cond)
                else:
                    lnp = lnp + priors[par].lnpdf(val)
            return lnp

        return lnprior_batch

    def _star_likelihood(self, ic=None, parallax=True, dist_idx=None):
        """What the fused likelihood needs besides the parameters: the 6-column
        pack and the BC grid of ``ic`` (the model's by default), the parameter
        layout, the observations and, with ``parallax``, the parallax term on
        the parameters' column ``dist_idx`` (the model's distance by default)."""
        ic = self.ic if ic is None else ic
        spec_vals, spec_uncs, mag_vals, mag_uncs, _ = self._static_obs()
        return StarLikelihood(
            n_stars=self.N, index_order=tuple(ic._param_index_order), pack6=ic.model_packed6, bc=ic.bc,
            band_icols=tuple(ic.bc.column_index[b] for b in self.bands), spec_vals=spec_vals, spec_uncs=spec_uncs,
            mag_vals=mag_vals, mag_uncs=mag_uncs, dist_idx=self.distance_index if dist_idx is None else dist_idx,
            parallax=self._plax() if parallax else None,
        )

    def _fused_eep_prior(self, cls, ic):
        """The EEP prior where the fused posterior can take it from the
        kernel's EEP-prior columns: ``cls``'s own ``_build_lnprior_batch`` and
        an ``EEP_prior`` on ``ic``; else None."""
        if type(self)._build_lnprior_batch is not cls._build_lnprior_batch:
            return None
        eep_prior = self._priors.get("eep")
        if not isinstance(eep_prior, EEP_prior) or eep_prior.ic is not ic:
            return None
        return eep_prior

    @staticmethod
    def _posterior(lnp, ll):
        """lnprior + lnlike as the reference composes them (starmodel.py:372-375):
        a NaN likelihood is -inf, and so is the posterior where the prior is
        not finite."""
        ll = torch.where(torch.isnan(ll), float("-inf"), ll)
        return torch.where(torch.isfinite(lnp), lnp + ll, float("-inf"))

    def _build_lnpost_fused(self):
        """Fused lnprior + lnlike sharing one interpolation per component over
        the 6-column packed table (reference starmodel.py:383-512); None (the
        composed path) for customized priors or subclasses."""
        ic = self.ic
        if type(self)._build_lnlike_batch is not BasicStarModel._build_lnlike_batch:
            return None
        if getattr(ic, "model_packed6", None) is None:
            return None
        eep_prior = self._fused_eep_prior(BasicStarModel, ic)
        if eep_prior is None:
            return None

        lk = self._star_likelihood()
        seismic = self._build_seismic_lnlike()
        priors = self._priors
        param_names = self.param_names
        eep_lo, eep_hi = eep_prior.bounds
        orig_prior = eep_prior.orig_prior

        def lnpost(pars):
            ll, orig_val, deriv = star_lnlike_fused(pars, lk)
            if seismic is not None:
                ll = ll + seismic(pars)
            # prior: ordering, shared parameters, the EEP change of variables
            lnp = self._ordering_lnprior(pars)
            eep_j = 0
            for i, par in enumerate(param_names):
                val = pars[..., i]
                if par in _EEP_NAMES:
                    lnp = lnp + _eep_lnprior(val, orig_val[..., eep_j], deriv[..., eep_j], orig_prior, eep_lo, eep_hi)
                    eep_j += 1
                else:
                    lnp = lnp + priors[par].lnpdf(val)
            return self._posterior(lnp, ll)

        return lnpost

    def _get_fn(self, name):
        """The batched ``lnlike``/``lnprior``/``lnpost`` closures, built once
        per bounds and prior setting; ``lnpost`` is the fused one where the
        model allows it."""
        cache = self._fn_cache
        if name not in cache:
            lnlike = self._build_lnlike_batch()
            lnprior = self._build_lnprior_batch()
            fused = self._build_lnpost_fused()

            def lnpost(pars):
                return self._posterior(lnprior(pars), lnlike(pars))

            cache.update(lnlike=lnlike, lnprior=lnprior, lnpost=fused if fused is not None else lnpost)
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

    def lnpost(self, p, **kwargs):
        """The log-posterior at one point or a batch; ``kwargs`` are ignored,
        as in the reference."""
        return self._eval_scalar(self._get_fn("lnpost"), p)

    # ------------------------------------------------------------ transforms
    def prior_transform_batch(self, u):
        """Unit cube -> uniform box over the parameter bounds (reference
        mnest_prior, starmodel.py:1637-1640)."""
        key = ("box", u.dtype, u.device)
        if key not in self._fn_cache:
            los, his = self._bounds_arrays()
            self._fn_cache[key] = tuple(torch.as_tensor(x, dtype=u.dtype, device=u.device) for x in (los, his - los))
        lo, span = self._fn_cache[key]
        return lo + span * u

    # ----------------------------------------------------------------- sampling
    def sample_from_prior(self, n, values=False, require_valid=True, rng=None):
        """Prior predictive draws (reference starmodel.py:1716-1748): a dict of
        numpy columns, or the (n, n_params) array with ``values=True``. Each
        ``eep_i`` is drawn from the conditional EEP prior and the EEPs are
        sorted descending; with ``require_valid`` rows of -inf lnpost are
        redrawn."""
        if n == 0:
            arr = np.zeros((0, self.n_params))
        else:
            rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
            cols = {p: self._priors[p].sample(n, rng=rng) for p in self.param_names if not p.startswith("eep")}
            cond_kw = {"feh": cols["feh"]}
            if self.ic.eep_replaces == "age":
                cond_kw["mass"] = cols["mass"]
            else:
                cond_kw["age"] = cols["age"]
            n_eep = sum(1 for p in self.param_names if p.startswith("eep"))
            eep_draws = np.stack([self._priors["eep"].sample(n, rng=rng, **cond_kw) for _ in range(n_eep)], axis=-1)
            eep_draws = -np.sort(-eep_draws, axis=-1)  # descending
            if n_eep == 1:
                cols["eep"] = eep_draws[:, 0]
            else:
                for j in range(n_eep):
                    cols[f"eep_{j}"] = eep_draws[:, j]
            arr = np.stack([cols[p] for p in self.param_names], axis=-1)
            if require_valid:
                bad = ~np.isfinite(self.lnpost_batch(arr).cpu().numpy())
                if bad.any():
                    arr[bad] = self.sample_from_prior(int(bad.sum()), values=True, require_valid=True, rng=rng)
        if values:
            return arr
        return {p: arr[:, i] for i, p in enumerate(self.param_names)}

    def emcee_p0(self, nwalkers, rng=None):
        """reference starmodel.py:838-884"""
        return self.sample_from_prior(nwalkers, values=True, require_valid=True, rng=rng)

    def maxlike(self, p0, **kwargs):
        """MAP point by scipy's Nelder-Mead on -lnpost (reference
        starmodel.py:821-833)."""
        from scipy.optimize import minimize

        res = minimize(lambda p: -self.lnpost(p), np.asarray(p0, dtype=float), method="Nelder-Mead", **kwargs)
        return res.x

    # ------------------------------------------------ reference-compat API
    def mnest_prior(self, cube, ndim=None, nparams=None):
        """In-place single-point unit-cube transform (reference
        starmodel.py:1637-1640)."""
        los, his = self._bounds_arrays()
        for i in range(len(self.param_names)):
            cube[i] = (his[i] - los[i]) * cube[i] + los[i]
        return cube

    def mnest_loglike(self, cube, ndim=None, nparams=None):
        return self.lnpost(np.asarray(cube[: self.n_params]))

    def prior_transform(self, cube):
        """Single-point unit-cube transform as numpy (reference
        starmodel.py:615-628; the batched form is :meth:`prior_transform_batch`)."""
        return self.prior_transform_batch(self._as_params(np.atleast_1d(np.asarray(cube, dtype=float)))).cpu().numpy()

    def prior(self, prop, val, **kwargs):
        """The prior pdf of ``prop`` at ``val`` (reference starmodel.py:634)."""
        return self._priors[prop](val, **kwargs)

    def lnpost_polychord(self, theta):
        """PolyChord's convention: ``(lnpost, derived parameters)``
        (reference starmodel.py:703-706; no derived parameters)."""
        return float(self.lnpost(theta)), []

    @property
    def mnest_analyzer(self):
        """The nested fit's :class:`~isochrones_torch.samplers.nested.NestedResult`
        (the reference returns a ``pymultinest.Analyzer``, starmodel.py:805-811)."""
        if self._nested_result is None:
            raise ValueError("Must run fit_multinest first.")
        return self._nested_result

    @property
    def sampler(self):
        """The last ensemble state of ``fit_mcmc`` (reference starmodel.py:974-981)."""
        state = getattr(self, "sampler_state", None)
        if state is None:
            raise AttributeError("MCMC must be run to access sampler")
        return state

    def fit_mcmc_old(self, **kwargs):
        """Deprecated alias of :meth:`fit_mcmc` (reference starmodel.py:889-973)."""
        getLogger().warning("fit_mcmc_old is deprecated; use fit_mcmc.")
        return self.fit_mcmc(**kwargs)

    # ------------------------------------------------------------------ fitting
    def _config_data_repr(self):
        """Stable text of the observed data this model is conditioned on;
        subclasses whose data lives outside ``self.kwargs`` (the tree model's
        observation tree) override it so :meth:`_fit_config_hash` covers it."""
        return repr(sorted((k, float(v), float(u)) for k, (v, u) in self.kwargs.items()))

    def _fit_config_hash(self, seed=None):
        """Stable hash of the fitted problem: observed data, parameter list,
        per-parameter bounds and the sampler seed. It goes into the nested
        sampler's checkpoint configuration, so a resume after an edited
        star.ini or another seed refuses instead of replaying the old fit."""
        parts = [
            self._config_data_repr(),
            repr(list(self.param_names)),
            repr([tuple(float(b) for b in self.bounds(p)) for p in self.param_names]),
            repr(None if seed is None else int(seed)),
        ]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    def fit(self, **kwargs):
        """reference dispatch starmodel.py:667-671."""
        if self.use_emcee:
            return self.fit_mcmc(**kwargs)
        return self.fit_multinest(**kwargs)

    def fit_multinest(self, n_live_points=1000, basename=None, verbose=False, refit=False, overwrite=False,
                      max_iter=None, seed=None, **kwargs):
        """On-device nested sampling (replaces pymultinest.run, reference
        starmodel.py:717-802). Keywords go to
        :func:`~isochrones_torch.samplers.nested.run_nested`; on a CUDA card
        ``n_batch`` defaults to 64 and ``n_chains`` to 16, as the JAX package
        sets them on its accelerator. ``dynamic`` defaults to the model's
        ``_default_dynamic`` (off for the flat models, on for the tree model).

        ``checkpoint=True`` persists the sampler state after every chunk
        under ``<basename or mnest_basename>checkpoint.pkl``;
        ``checkpoint=<path>`` uses that path. ``resume=True`` restores from it
        (and implies checkpointing): the completed fit is bitwise the fit that
        never stopped. ``refit``/``overwrite`` delete the checkpoint first,
        and the checkpoint carries a hash of the data, bounds and seed, so a
        stale one is refused (``CheckpointConfigError``), never replayed.
        ``n_runs > 1`` runs independent runs in lockstep (the result's
        ``logz_runs``; not with ``dynamic``); ``mesh`` is not ported yet and
        raises ``NotImplementedError``. Sets ``samples`` (a dict of numpy
        columns with ``"lnprob"``) and ``evidence``; returns the
        ``NestedResult``."""
        from .samplers.nested import run_nested

        ckpt = kwargs.pop("checkpoint", None)
        if kwargs.get("resume") and ckpt is None:
            ckpt = True
        if ckpt is True:
            base = basename if basename is not None else self.mnest_basename
            os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
            ckpt = f"{base}checkpoint.pkl"
        if ckpt is not None:
            if (refit or overwrite) and os.path.exists(ckpt):
                os.remove(ckpt)
            kwargs["checkpoint"] = ckpt
            kwargs.setdefault("config_tag", self._fit_config_hash(seed))

        if self.device.type == "cuda":
            kwargs.setdefault("n_batch", 64)
            kwargs.setdefault("n_chains", 16)
        if self._default_dynamic and "dynamic" not in kwargs and kwargs.get("n_runs", 1) == 1:
            kwargs["dynamic"] = True
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        result = run_nested(self._get_fn("lnpost"), self.prior_transform_batch, self.n_params, gen,
                            n_live=n_live_points, max_iter=max_iter, rng=seed, dtype=self.dtype, **kwargs)
        self._nested_result = result
        self._evidence = (result.logz, result.logzerr)
        if result.truncated:
            getLogger().warning(
                "fit_multinest: run was ESS-truncated (ess=%.0f): posterior quantiles in .samples are "
                "unreliable; refit with a larger max_iter or n_live_points.", result.ess,
            )
        self._set_samples(result.posterior, result.logl_posterior)
        return result

    def _set_samples(self, params, lnprob):
        """Keep ``(n, n_params)`` posterior draws and their lnprob as the
        model's samples (a :class:`~isochrones_torch.summary.Frame`)."""
        samples = Frame({name: params[:, i] for i, name in enumerate(self.param_names)})
        samples["lnprob"] = lnprob
        self._samples = samples
        self._derived_samples = None
        return samples

    def fit_nuts(self, n_chains=8, n_warmup=500, n_samples=500, max_depth=8, target_accept=0.8, seed=None, mesh=None,
                 eps_jitter=1.0):
        """No-U-Turn sampling of the posterior (reference starmodel.py:759-806)
        through :func:`~isochrones_torch.samplers.nuts.run_nuts`: the logit
        reparametrization of the box bounds, a dense whitened metric from a
        500-step ensemble warm start over a prior cloud, ``n_chains`` chains.
        The gradient is autograd's through the fused posterior; on the card
        the likelihood's part comes from the backward kernels (A' for the flat
        models, C' for the tree model). ``target_accept`` stays at Stan's 0.8:
        on gridded posteriors the accept statistic plateaus near 0.85 whatever
        the step size (the grid's -inf cliffs reject a fixed share of
        trajectories), and a target above the plateau drives the step size to
        the dtype's floor. ``mesh`` is not ported yet and raises
        ``NotImplementedError``. Returns the samples (a
        :class:`~isochrones_torch.summary.Frame` with ``"lnprob"``); the
        :class:`~isochrones_torch.samplers.nuts.NutsResult` is kept as
        ``self._nuts_result``."""
        from .samplers.nuts import run_nuts

        if mesh is not None:
            raise NotImplementedError(f"fit_nuts(mesh={mesh!r}) is not ported yet (ROADMAP queue 1, parallelism)")
        n_cloud = max(64, 8 * self.n_params, 2 * n_chains)
        p0 = self.sample_from_prior(n_cloud, values=True, require_valid=True, rng=seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        los, his = self._bounds_arrays()
        res = run_nuts(self._get_fn("lnpost"), self._as_params(np.asarray(p0, dtype=float)), gen,
                       n_warmup=n_warmup, n_samples=n_samples, max_depth=max_depth, target_accept=target_accept,
                       ensemble_init=500, n_chains=n_chains, bounds=np.stack([los, his], axis=-1),
                       eps_jitter=eps_jitter)
        self._nuts_result = res
        return self._set_samples(res.samples.reshape(-1, self.n_params), res.lnp.reshape(-1))

    def fit_polychord(self, basename=None, verbose=False, n_live_points=1000, max_iter=None, seed=None, **kwargs):
        """PolyChord-style nested sampling (reference starmodel.py:808-850;
        the reference shells out to the Fortran PolyChord): the slice-sampling
        replacement of :func:`~isochrones_torch.samplers.polychord.run_polychord`
        in the nested sampler's loop, an independent cross-check of
        :meth:`fit_multinest`'s evidence and posterior. Keywords go to
        :func:`~isochrones_torch.samplers.nested.run_nested`. Sets
        ``samples`` and ``evidence``; returns the ``NestedResult``."""
        from .samplers.polychord import run_polychord

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        result = run_polychord(self._get_fn("lnpost"), self.prior_transform_batch, self.n_params, gen,
                               n_live=n_live_points, max_iter=max_iter, rng=seed, dtype=self.dtype, **kwargs)
        self._nested_result = result
        self._evidence = (result.logz, result.logzerr)
        self._set_samples(result.posterior, result.logl_posterior)
        return result

    def fit_mcmc(self, nwalkers=300, nburn=200, niter=100, thin=1, p0=None, seed=None, mesh=None,
                 moves="stretch", **kwargs):
        """On-device affine-invariant ensemble MCMC (reference
        starmodel.py:886-972). ``moves``: "stretch", "de", "snooker", "kde"
        or "mixed". ``mesh`` (sharding the walkers across devices) is not
        ported yet and raises ``NotImplementedError``, as in ``fit_multinest``.
        Other keywords (those of the nested fit, which ``starfit``
        hands to either engine) are ignored, as in the reference. Returns a dict of column name -> numpy array with the
        parameter columns and ``"lnprob"``; the final sampler state (with its
        acceptance counts) is kept as ``self.sampler_state``."""
        from .samplers.ensemble import run_ensemble

        if mesh is not None:
            raise NotImplementedError(f"fit_mcmc(mesh={mesh!r}) is not ported yet (ROADMAP queue 1, parallelism)")

        if p0 is None:
            p0 = self.emcee_p0(nwalkers, rng=seed)
        p0 = self._as_params(p0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        lnpost = self._get_fn("lnpost")

        _, _, state = run_ensemble(lnpost, p0, gen, n_steps=nburn, moves=moves)
        chain, ln_chain, state = run_ensemble(lnpost, state.walkers, gen, n_steps=niter, thin=thin,
                                              moves=moves)
        self.sampler_state = state
        return self._set_samples(chain.reshape(-1, self.n_params).cpu().numpy(), ln_chain.reshape(-1).cpu().numpy())

    @property
    def evidence(self):
        """(logZ, logZerr) of the nested-sampling fit (reference
        starmodel.py:804-819)."""
        return self._evidence

    @property
    def samples(self):
        if self._samples is None:
            raise AttributeError("No samples yet; run .fit()")
        return self._samples

    @property
    def derived_samples(self):
        if self._derived_samples is None:
            self._make_samples()
        return self._derived_samples

    def _make_samples(self):
        """Posterior post-processing through the interpolator (reference
        starmodel.py:1653-1714): every model column and band magnitude per
        component (suffix ``_j`` for N > 1, plus the flux-summed ``{band}_mag``),
        then parallax, distance and AV."""
        s = self.samples
        if self.N == 1:
            derived = self.ic(*[s[c] for c in self.param_names])
        else:
            derived = dict(s)
            shared = list(self.ic.param_names[1:])
            for j in range(self.N):
                comp = self.ic(*[s[c] for c in [f"eep_{j}"] + shared])
                derived.update({f"{c}_{j}": v for c, v in comp.items() if c not in ("age", "eep")})
            for b in self.bands:
                derived[f"{b}_mag"] = addmags(*[derived[f"{b}_mag_{j}"] for j in range(self.N)])
        derived["parallax"] = 1000.0 / s["distance"]
        derived["distance"] = s["distance"]
        derived["AV"] = s["AV"]
        self._derived_samples = derived

    def map_pars(self):
        """The sample of highest posterior, as the parameter vector."""
        i_max = int(np.argmax(self.samples["lnprob"]))
        return np.array([self.samples[c][i_max] for c in self.samples if c != "lnprob"])

    def random_samples(self, n, rng=None):
        """Random subsample of the posterior (reference starmodel.py:1050-1065)."""
        rng = np.random.default_rng(rng)
        inds = rng.integers(len(self.samples["lnprob"]), size=int(n))
        return {c: v[inds] for c, v in self.samples.items()}

    @property
    def physical_quantities(self):
        """reference starmodel.py:1756-1794"""
        if self.N == 1:
            return ["mass", "radius", "age", "Teff", "logg", "feh", "distance", "AV"]
        per = [f"{q}_{j}" for q in ("mass", "radius") for j in range(self.N)]
        per += [f"{q}_{j}" for q in ("Teff", "logg") for j in range(self.N)]
        return per + ["age", "feh", "distance", "AV"]

    @property
    def observed_quantities(self):
        """reference starmodel.py:1796-1803"""
        cols = [f"{b}_mag" for b in self.bands]
        if self.N == 1:
            return cols + self.props
        return cols + [p if p in self.derived_samples else f"{p}_0" for p in self.props]

    @property
    def posterior_predictive(self):
        """Mean chi^2 / N over the observed quantities (reference
        starmodel.py:1827-1836)."""
        derived = self.derived_samples
        chisq = 0
        for b in self.bands:
            val, unc = self.kwargs[b]
            chisq += (val - derived[f"{b}_mag"]) ** 2 / unc ** 2
        for p in self.props:
            val, unc = self.kwargs[p]
            col = p if p in derived else f"{p}_0"
            chisq += (val - derived[col]) ** 2 / unc ** 2
        return float(np.mean(chisq)) / (len(self.bands) + len(self.props))

    # ------------------------------------------------------------------- plots
    def corner(self, params, query=None, **kwargs):
        """Corner plot over posterior or derived columns (reference
        starmodel.py:1075-1101); ``query`` selects rows
        (:meth:`~isochrones_torch.summary.Frame.query`)."""
        from .plotting import corner as _corner

        derived = Frame(self.derived_samples)
        df = derived if all(p in derived for p in params) else Frame(self.samples)
        if query is not None:
            df = df.query(query)
        fig = _corner({p: df[p] for p in params}, labels=list(params), **kwargs)
        fig.suptitle(self.name, fontsize=22)
        return fig

    def triangle(self, *args, **kwargs):
        """reference starmodel.py:1072"""
        return self.corner(*args, **kwargs)

    def triangle_physical(self, *args, **kwargs):
        """reference starmodel.py:1103"""
        return self.corner_physical(*args, **kwargs)

    def triangle_plots(self, *args, **kwargs):
        """reference starmodel.py:1112"""
        return self.corner_plots(*args, **kwargs)

    def mag_plot(self, *args, **kwargs):
        """reference starmodel.py:1128-1129 (a stub there too)."""
        pass

    def corner_params(self, **kwargs):
        from .plotting import corner as _corner

        fig = _corner(self.samples, labels=list(self.samples), **kwargs)
        fig.suptitle(self.name, fontsize=22)
        return fig

    def corner_derived(self, cols, **kwargs):
        from .plotting import corner as _corner

        fig = _corner({c: self.derived_samples[c] for c in cols}, labels=cols, **kwargs)
        fig.suptitle(self.name, fontsize=22)
        return fig

    def corner_physical(self, **kwargs):
        return self.corner_derived(self.physical_quantities, **kwargs)

    def corner_plots(self, basename, **kwargs):
        """Save the physical and observed corner PNGs
        (``<basename>_physical.png``, ``<basename>_observed.png``). Returns
        the two figures."""
        import matplotlib.pyplot as plt

        fig1 = self.corner_physical(**kwargs)
        fig1.savefig(f"{basename}_physical.png")
        fig2 = self.corner_observed(**kwargs)
        fig2.savefig(f"{basename}_observed.png")
        plt.close(fig1)
        plt.close(fig2)
        return fig1, fig2

    def corner_observed(self, **kwargs):
        cols = self.observed_quantities
        truths = [self.kwargs[b][0] for b in self.bands] + [self.kwargs[p][0] for p in self.props]
        derived = Frame({c: self.derived_samples[c] for c in cols})
        lo, hi = derived.nanmin(), derived.nanmax()
        ranges = [(min(t - 0.01, lo[c]), max(t + 0.01, hi[c])) for t, c in zip(truths, cols)]
        return self.corner_derived(cols, truths=truths, ranges=ranges, **kwargs)

    # ------------------------------------------------------------- persistence
    def write_ini(self, root="."):
        """reference starmodel.py:1486-1499"""
        path = os.path.join(root, self.name)
        os.makedirs(path, exist_ok=True)
        lines = []
        if self.ra is not None and self.dec is not None:
            lines.append(f"ra = {self.ra}")
            lines.append(f"dec = {self.dec}")
        for k, (v, u) in self.kwargs.items():
            lines.append(f"{k} = {v}, {u}")
        with open(os.path.join(path, "star.ini"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def _store_entries(self, prefix, attrs):
        """The container entries of this model: samples and derived samples
        as value matrix + JSON column list, ``attrs`` as JSON strings."""
        entries = {}
        if self._samples is not None:
            for key, table in (("samples", self._samples), ("derived_samples", self.derived_samples)):
                cols = list(table)
                entries[f"{prefix}{key}/values"] = np.stack([np.asarray(table[c], dtype=float) for c in cols], axis=1)
                entries[f"{prefix}{key}/columns"] = np.array(json.dumps(cols))
        for k, v in attrs.items():
            entries[f"{prefix}attrs/{k}"] = np.array(json.dumps(v))
        return entries

    @staticmethod
    def _stored_tables(entries, prefix):
        """(samples, derived_samples) dicts of columns, or (None, None)."""
        out = []
        for key in ("samples", "derived_samples"):
            if f"{prefix}{key}/values" not in entries:
                return None, None
            vals = entries[f"{prefix}{key}/values"]
            cols = json.loads(str(entries[f"{prefix}{key}/columns"]))
            out.append({c: vals[:, i] for i, c in enumerate(cols)})
        return tuple(out)

    def save_hdf(self, filename, path="", overwrite=False, append=False):
        """Persist the model (reference starmodel.py:1843-1901, which writes
        HDF5) into the ``.npz`` container ``filename`` under the key prefix
        ``path``: samples and derived samples as value matrix + column list,
        and ``ic_type``, ``ic_bands``, ``use_emcee``, ``kwargs``, ``bounds``,
        ``eep_bounds``, ``name``, ``N``, ``directory``, ``evidence`` as
        attributes. Existing samples under ``path`` raise unless
        ``overwrite`` (the file is replaced) or ``append`` (the entry is)."""
        prefix = store_prefix(path)
        entries = {}
        if os.path.exists(filename):
            entries = npz_load(filename)
            if f"{prefix}samples/values" in entries:
                if overwrite:
                    entries = {}
                elif not append:
                    raise IOError(f"{path} in {filename} exists. Set overwrite or append.")
        mine = tuple(f"{prefix}{g}/" for g in ("samples", "derived_samples", "attrs"))
        entries = {k: v for k, v in entries.items() if not k.startswith(mine)}
        attrs = dict(
            ic_type=type(self.ic).__name__, ic_bands=list(self.ic.bands), use_emcee=bool(self.use_emcee),
            kwargs={k: [float(v), float(u)] for k, (v, u) in self.kwargs.items()},
            bounds={k: list(v) if v is not None else None for k, v in self._bounds.items()},
            eep_bounds=list(self.eep_bounds), name=self.name, N=self.N, directory=self.directory,
        )
        if self._evidence is not None:
            attrs["evidence"] = list(self._evidence)
        entries.update(self._store_entries(prefix, attrs))
        npz_save(filename, entries)

    @classmethod
    def load_hdf(cls, filename, path="", name=None, ic=None, device="cuda", dtype=None):
        """Restore a saved model (reference starmodel.py:1903-1959) from the
        ``.npz`` container. ``ic`` may be passed; otherwise the stored kind
        of interpolator (isochrones or evolution tracks) is rebuilt with the
        stored bands, from the MIST grids or else the synthetic ones, on
        ``device`` (the card unless the caller names another) in ``dtype``."""
        if not os.path.exists(filename):
            raise IOError(f"{filename} does not exist.")
        prefix = store_prefix(path)
        entries = npz_load(filename)
        attrs = {k[len(prefix) + 6:]: json.loads(str(v)) for k, v in entries.items()
                 if k.startswith(f"{prefix}attrs/")}
        samples, derived = cls._stored_tables(entries, prefix)
        if ic is None:
            ic = _stored_ichrone(attrs, device, dtype)
        kwargs = {k: tuple(v) for k, v in attrs["kwargs"].items()}
        mod = cls(ic, name=name if name is not None else attrs["name"], directory=attrs["directory"],
                  eep_bounds=tuple(attrs["eep_bounds"]), N=int(attrs["N"]), use_emcee=bool(attrs["use_emcee"]),
                  **kwargs)
        mod._samples = samples
        mod._derived_samples = derived
        # through set_bounds, so the priors' bounds stay in step with the
        # prior-transform box (a non-default maxAV survives the reload)
        bounds = attrs["bounds"]
        mod.set_bounds(**{k: tuple(v) for k, v in bounds.items() if v is not None})
        for k, v in bounds.items():
            if v is None:
                mod._bounds[k] = None
        if attrs.get("evidence") is not None:
            mod._evidence = tuple(attrs["evidence"])
        return mod

    def write_results(self, corner_kwargs=None, directory=None):
        """The results file and three corner PNGs (reference
        starmodel.py:1961-1989): ``<base>starmodel.npz`` and
        ``<base>{params,observed,physical}.png`` in ``directory`` (the
        model's own by default), ``<base>`` being
        ``<name>-<grid>-<labelstring>-``."""
        if self._samples is None:
            raise RuntimeError("Run .fit() before .write_results()!")
        directory = directory or self.directory
        corner_kwargs = corner_kwargs or {}
        base = f"{self.name + '-' if self.name else ''}{self.ic.name}-{self.labelstring}-"
        self.save_hdf(os.path.join(directory, base + "starmodel.npz"), overwrite=True)
        import matplotlib.pyplot as plt

        for tag, fn in (("params", self.corner_params), ("observed", self.corner_observed),
                        ("physical", self.corner_physical)):
            fig = fn(**corner_kwargs)
            fig.savefig(os.path.join(directory, f"{base}{tag}.png"))
            plt.close(fig)


def _stored_ichrone(attrs, device, dtype):
    """The interpolator of a stored model, with the stored bands and of the
    stored kind (isochrones or evolution tracks): the MIST grids, or the
    synthetic ones where the MIST grids cannot be built, as the reference
    does (starmodel.py:1189-1196)."""
    from .isochrone import get_ichrone

    kw = dict(bands=attrs["ic_bands"], tracks=attrs.get("ic_type") == "EvolutionTrackInterpolator", device=device)
    if dtype is not None:
        kw["dtype"] = dtype
    try:
        return get_ichrone("mist", **kw)
    except Exception:
        return get_ichrone("synthetic", **kw)


class SingleStarModel(BasicStarModel):
    def __init__(self, *args, **kwargs):
        kwargs["N"] = 1
        super().__init__(*args, **kwargs)


class BinaryStarModel(BasicStarModel):
    def __init__(self, *args, **kwargs):
        kwargs["N"] = 2
        super().__init__(*args, **kwargs)


class TripleStarModel(BasicStarModel):
    def __init__(self, *args, **kwargs):
        kwargs["N"] = 3
        super().__init__(*args, **kwargs)


def _columns(pars, idx):
    """(..., 6) -> (..., 5): the columns ``idx`` of ``pars``, in that order."""
    return torch.stack([pars[..., i] for i in idx], dim=-1)


class IsoTrackModel(BasicStarModel):
    """Joint isochrone + track model over (eep, mass, age, feh, distance, AV)
    (reference starmodel.py:2010-2104): the star likelihood on both grids,
    the isochrones at (eep, age, feh) and the tracks at (mass, eep, feh),
    with the parallax term once and the EEP prior taken on the track grid.

    ``lnpost_batch`` is fused: two calls of
    :func:`~isochrones_torch.ops.star.star_lnlike_fused` (two launches of
    the star kernel on the card), the second of which also returns the age
    and d age / d EEP that the EEP prior needs; with another prior (a
    subclass's ``_build_lnprior_batch``, another EEP prior) the same two
    calls give the likelihood and that prior is added. ``lnlike_batch`` and
    ``lnprior_batch`` are the composed forms, as in the reference.
    ``derived_samples`` calls the track interpolator with all six columns
    and raises ``TypeError``, as the reference does.
    """

    _iso_track_param_names = ("eep", "mass", "age", "feh", "distance", "AV")
    #: the columns of the parameters that each grid's likelihood takes
    _ISO_COLUMNS = (0, 2, 3, 4, 5)  # (eep, age, feh, distance, AV)
    _TRACK_COLUMNS = (1, 0, 3, 4, 5)  # (mass, eep, feh, distance, AV)

    def __init__(self, iso, track, **kwargs):
        # set before the base class runs: it reads ``ic`` (the track)
        self._iso_ic = iso
        self._track_ic = track
        super().__init__(iso, **kwargs)
        self.set_prior(eep=EEP_prior(self.track, self._priors["age"], bounds=self.eep_bounds))

    @property
    def ic(self):
        return self._track_ic

    @property
    def iso(self):
        return self._iso_ic

    @property
    def track(self):
        return self._track_ic

    @property
    def param_names(self):
        return self._iso_track_param_names

    def _build_lnlike_batch(self):
        iso, track = self.iso, self.track
        spec_vals, spec_uncs, mag_vals, mag_uncs, _ = self._static_obs()
        mag_vals = torch.as_tensor(mag_vals, dtype=self.dtype, device=self.device)
        mag_uncs = torch.as_tensor(mag_uncs, dtype=self.dtype, device=self.device)
        grids = [(ic, cols, tuple(ic._param_index_order), tuple(ic.bc.column_index[b] for b in self.bands))
                 for ic, cols in ((iso, self._ISO_COLUMNS), (track, self._TRACK_COLUMNS))]
        plax = self._plax()

        def lnlike_batch(pars):
            ll = 0.0
            for ic, cols, io, band_icols in grids:
                ll = ll + star_lnlike(_columns(pars, cols), io, spec_vals, spec_uncs, mag_vals, mag_uncs,
                                      ic.model_packed, ic._packed_icols, ic.bc, band_icols, n_stars=1)
            if plax is not None:
                ll = ll + gauss_lnprob(plax[0], plax[1], 1000.0 / pars[..., 4])
            return ll

        return lnlike_batch

    def _build_lnprior_batch(self):
        priors = self._priors
        param_names = self.param_names

        def lnprior_batch(pars):
            lnp = torch.zeros(pars.shape[:-1], dtype=pars.dtype, device=pars.device)
            for i, par in enumerate(param_names):
                if par == "eep":
                    lnp = lnp + priors["eep"].lnpdf(pars[..., i], mass=pars[..., 1], feh=pars[..., 3])
                else:
                    lnp = lnp + priors[par].lnpdf(pars[..., i])
            return lnp

        return lnprior_batch

    def _star_likelihoods(self):
        """The two launches' likelihoods: the iso's without the parallax, the
        track's with it, each with the distance's place among the five
        columns that it takes."""
        d = self.param_names.index("distance")
        return (self._star_likelihood(self.iso, parallax=False, dist_idx=self._ISO_COLUMNS.index(d)),
                self._star_likelihood(self.track, dist_idx=self._TRACK_COLUMNS.index(d)))

    def _build_lnpost_fused(self):
        """Both grids' fused likelihoods, and the prior around them: the EEP
        prior from the track launch's age and d age / d EEP where it is the
        class's own ``EEP_prior`` on the track, else the model's
        ``lnprior_batch``. None (the composed path) only for a subclass's own
        likelihood, or on the CPU for a grid without its 6-column pack; on
        the card such a grid raises."""
        if type(self)._build_lnlike_batch is not IsoTrackModel._build_lnlike_batch:
            return None
        if self.iso.model_packed6 is None or self.track.model_packed6 is None:
            if self.device.type == "cuda":
                raise ValueError("IsoTrackModel on the card needs both grids' EEP-prior columns (initial_mass and "
                                 "dm_deep, or age and dt_deep) beside Teff, logg, feh and Mbol")
            return None

        lk_iso, lk_track = self._star_likelihoods()
        eep_prior = self._fused_eep_prior(IsoTrackModel, self.track)
        lnprior = self._build_lnprior_batch() if eep_prior is None else None
        priors = self._priors
        param_names = self.param_names

        def lnpost(pars):
            ll_iso, _, _ = star_lnlike_fused(_columns(pars, self._ISO_COLUMNS), lk_iso)
            ll_track, age, dage = star_lnlike_fused(_columns(pars, self._TRACK_COLUMNS), lk_track)
            ll = ll_iso + ll_track
            if lnprior is not None:
                return self._posterior(lnprior(pars), ll)
            lnp = torch.zeros_like(ll)
            for i, par in enumerate(param_names):
                val = pars[..., i]
                if par == "eep":  # EEP_prior(track, age prior).lnpdf at (mass, eep, feh)
                    lnp = lnp + _eep_lnprior(val, age[..., 0], dage[..., 0], eep_prior.orig_prior, *eep_prior.bounds)
                else:
                    lnp = lnp + priors[par].lnpdf(val)
            return self._posterior(lnp, ll)

        return lnpost

    def bounds(self, prop):
        if prop == "eep":
            return self._bounds["eep"]
        if self._bounds[prop] is not None:
            return self._bounds[prop]
        if prop in ("mass", "feh", "age"):
            # mass is a track-grid axis; the age and [Fe/H] box comes from the
            # isochrone grid (on the track grid age is a data column)
            lo, hi = (self.track if prop == "mass" else self.iso).get_limits(prop)
            self._bounds[prop] = (lo, hi)
            self._priors[prop].bounds = (lo, hi)
            return self._bounds[prop]
        raise ValueError(f"Unknown property {prop}")


def N_options(N_stars, max_multiples=1, max_stars=2):
    """Enumerate multiplicity configurations (reference starmodel.py:2110-2116)."""
    return [
        N
        for N in itertools.product(np.arange(max_stars) + 1, repeat=N_stars)
        if (np.array(N) > 1).sum() <= max_multiples
    ]


def index_options(N_stars):
    """Enumerate system-index configurations (reference starmodel.py:2119-2127)."""
    if N_stars == 1:
        return [0]
    options = []
    for ind in itertools.product(range(N_stars), repeat=N_stars):
        diffs = np.array(ind[1:]) - np.array(ind[:-1])
        if ind[0] == 0 and diffs.max() <= 1:
            options.append(ind)
    return options
