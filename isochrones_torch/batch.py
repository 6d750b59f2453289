"""Whole-catalog fitting: every star of a catalog in one batched posterior
(counterpart of ``isochrones_tpu/batch.py``).

The reference scales fleets of single-star fits with SLURM job arrays
(``batch-starfit``), one serial fit a star. Here a catalog's observations are
stacked along a star axis and every star's fit advances in lockstep: the
posterior maps parameters ``(S, B, 5)`` to ``(S, B)`` in one call of the
catalog posterior (:func:`~isochrones_torch.ops.catalog.catalog_lnpost`, one
hand-written CUDA kernel launch on the card, likelihood and default priors
together). :meth:`BatchStarFitter.fit_mcmc` runs one stretch-move ensemble
per star (:func:`~isochrones_torch.samplers.ensemble.run_ensemble_batch`);
:meth:`BatchStarFitter.fit_multinest` one nested-sampling run per star
(:func:`~isochrones_torch.samplers.nested.run_nested_vmapped`), which also
gives every star's evidence. The model is the single-star model on an
isochrone grid, parameters ``(eep, age, feh, distance, AV)``; the bands, the
prior families and the parameterization are shared, the observations and the
parallax-derived distance bound (reference starmodel.py:1465-1477) are per
star. Both fits take a device mesh (``mesh=``) that splits the star axis:
each shard's posterior holds its own stars' observations, so the parameters
and the data are split together.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from .catalog import StarCatalog
from .logger import getLogger
from .ops.catalog import PRIOR_TERMS, CatalogLikelihood, catalog_lnpost, pack_catalog_priors, unit_box
from .priors import AgePrior, AVPrior, ChabrierPrior, EEP_prior, FehPrior
from .tracing import span, spanned

__all__ = ["BatchStarFitter", "fit_catalog"]

SPEC_PROPS = ("Teff", "logg", "feh")
_NEG_INF = float("-inf")


class BatchStarFitter:
    """Fit every star of a catalog at once (single-star models, isochrone
    parameterization: (eep, age, feh, distance, AV)).

    ic : an isochrone interpolator, or a grid name that
        :func:`~isochrones_torch.isochrone.get_ichrone` builds with the
        catalog's bands on ``device`` (the card unless the caller names
        another) in ``dtype``. The fit runs on the interpolator's device and
        in its dtype.
    catalog : a :class:`~isochrones_torch.catalog.StarCatalog` or a mapping of
        columns it accepts.
    """

    param_names = ("eep", "age", "feh", "distance", "AV")

    def __init__(
        self,
        ic,
        catalog,
        bands: Optional[Sequence[str]] = None,
        halo_fraction: float = None,
        maxAV: float = 1.0,
        max_distance: float = 10000.0,
        eep_bounds=None,
        device="cuda",
        dtype=None,
    ):
        from .models import ModelGridInterpolator

        if not isinstance(catalog, StarCatalog):
            catalog = StarCatalog(catalog)
        if not isinstance(ic, ModelGridInterpolator):
            from .isochrone import get_ichrone

            kw = {} if dtype is None else {"dtype": dtype}
            ic = get_ichrone(ic, list(bands) if bands is not None else list(catalog.bands), device=device, **kw)
        if ic.eep_replaces != "mass":
            raise ValueError("BatchStarFitter requires an isochrone-parameterized interpolator")
        self.ic = ic
        self.catalog = catalog
        self.bands = list(bands) if bands is not None else list(catalog.bands)
        S = len(catalog)
        self.n_stars = S

        cols = catalog.data
        self.mag_vals = np.stack([np.asarray(cols[f"{b}_mag"], dtype=float) for b in self.bands], axis=-1)
        self.mag_uncs = np.stack([np.asarray(cols[f"{b}_mag_unc"], dtype=float) for b in self.bands], axis=-1)
        self.spec_vals = np.full((S, 3), np.nan)
        self.spec_uncs = np.full((S, 3), np.nan)
        for j, p in enumerate(SPEC_PROPS):
            if p in catalog.props:
                self.spec_vals[:, j], self.spec_uncs[:, j] = catalog.get_measurement(p)
        if "parallax" in catalog.props:
            self.plax_vals, self.plax_uncs = (np.array(x, dtype=float) for x in catalog.get_measurement("parallax"))
        else:
            self.plax_vals = None
            self.plax_uncs = None

        # per-star distance upper bound (reference starmodel.py:1465-1477)
        if self.plax_vals is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                self.max_distance = np.where(self.plax_vals > 0, 2000.0 / np.maximum(self.plax_vals, 1e-3),
                                             max_distance)
        else:
            self.max_distance = np.full(S, float(max_distance))

        # shared priors (the defaults of BasicStarModel, reference
        # starmodel.py:1437-1445); on an isochrone grid the EEP prior converts
        # from the mass prior
        self.priors = {
            "mass": ChabrierPrior(),
            "age": AgePrior(),
            "feh": FehPrior(**({"halo_fraction": halo_fraction} if halo_fraction is not None else {})),
            "AV": AVPrior(bounds=(0, maxAV)),
        }
        self.priors["mass"].bounds = ic.get_limits("mass")
        self.priors["age"].bounds = ic.get_limits("age")
        self.priors["feh"].bounds = ic.get_limits("feh")
        self.eep_bounds = tuple(eep_bounds) if eep_bounds is not None else tuple(ic.eep_bounds)
        self.priors["eep"] = EEP_prior(ic, self.priors["mass"], bounds=self.eep_bounds)

        self._likelihood = None
        self._prior_pack = None
        self._shards = None
        self._samples = None
        self._lnprob = None
        self._evidence = None

    @property
    def device(self) -> torch.device:
        return self.ic.device

    @property
    def dtype(self) -> torch.dtype:
        return self.ic.dtype

    # ------------------------------------------------------------- posterior
    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @property
    def star_data(self):
        """Per-star observations with a leading star axis, tensors on the
        fitter's device: ``spec_vals``/``spec_uncs`` (S, 3), ``mag_vals``/
        ``mag_uncs`` (S, n_bands), ``plax``/``plax_unc`` (S,) or None, and the
        distance bound ``d_hi`` (S,)."""
        has_plax = self.plax_vals is not None
        return dict(
            spec_vals=self._tensor(self.spec_vals), spec_uncs=self._tensor(self.spec_uncs),
            mag_vals=self._tensor(self.mag_vals), mag_uncs=self._tensor(self.mag_uncs),
            plax=self._tensor(self.plax_vals) if has_plax else None,
            plax_unc=self._tensor(self.plax_uncs) if has_plax else None,
            d_hi=self._tensor(self.max_distance),
        )

    def _catalog_likelihood(self) -> CatalogLikelihood:
        """The :class:`~isochrones_torch.ops.catalog.CatalogLikelihood` of the
        catalog, built once (the kernel keeps its packed form per instance)."""
        if self._likelihood is None:
            ic = self.ic
            data = self.star_data
            self._likelihood = CatalogLikelihood(
                index_order=tuple(ic._param_index_order), pack6=ic.model_packed6, bc=ic.bc,
                band_icols=tuple(ic.bc.column_index[b] for b in self.bands),
                spec_vals=data["spec_vals"], spec_uncs=data["spec_uncs"], mag_vals=data["mag_vals"],
                mag_uncs=data["mag_uncs"], plax=data["plax"], plax_unc=data["plax_unc"],
            )
        return self._likelihood

    def _catalog_priors(self):
        """The posterior's packed prior constants
        (:func:`~isochrones_torch.ops.catalog.pack_catalog_priors`), packed
        again only when a prior object, its bounds or the EEP bounds change."""
        key = tuple((self.priors[k], self.priors[k].bounds) for k in PRIOR_TERMS) + (self.eep_bounds,)
        if self._prior_pack is None or self._prior_pack[0] != key:
            pack = pack_catalog_priors(self.priors, self.eep_bounds, self._bounds_arrays()[0],
                                       self._tensor(self.max_distance))
            self._prior_pack = (key, pack)
        return self._prior_pack[1]

    def lnpost_batch(self, pars):
        """(S, B, 5) parameters -> (S, B) log-posterior tensor on the
        fitter's device: the catalog likelihood, the shared priors, the
        per-star distance bound (a power law of index 2 from 0: ln p = ln 3 -
        3 ln hi + 2 ln d) and the EEP change of variables p(eep) =
        p_mass(m(eep)) |dm/dEEP| on the likelihood's two EEP-prior columns;
        on the card one kernel launch."""
        return self._lnpost(self._tensor(pars))

    @spanned("catalog.lnpost")
    def _lnpost(self, x, his=None):
        """The posterior at parameters ``x``, or at unit-cube points ``x`` with
        the box tops ``his`` (S, 5). A prior object outside the packed
        families (``pack_catalog_priors``) adds its own ``lnpdf`` after the
        launch."""
        pri = self._catalog_priors()
        out, orig = catalog_lnpost(x, self._catalog_likelihood(), pri, his)
        if all(pri.on):
            return out
        pars = x if his is None else unit_box(x, pri, his)
        extra = torch.zeros_like(out)
        for k, on, col in zip(PRIOR_TERMS, pri.on, (1, 2, 4, None)):
            if not on:
                extra = extra + self.priors[k].lnpdf(orig if col is None else pars[..., col])
        return torch.where(torch.isfinite(extra), out + extra, _NEG_INF)

    #: per-star attributes a shard of the star axis slices
    _STAR_ARRAYS = ("mag_vals", "mag_uncs", "spec_vals", "spec_uncs", "plax_vals", "plax_uncs", "max_distance")

    def _shard(self, lo, hi, ic):
        """The fitter of stars ``lo:hi`` on ``ic`` (the fitter's interpolator
        or its copy on another device): the same priors, the stars'
        observations and distance bounds."""
        sub = copy.copy(self)
        sub.ic, sub.n_stars = ic, hi - lo
        for name in self._STAR_ARRAYS:
            arr = getattr(self, name)
            setattr(sub, name, None if arr is None else arr[lo:hi])
        sub._likelihood = sub._prior_pack = sub._shards = None
        return sub

    def _mesh_shards(self, mesh):
        """The fitters of the star axis split over ``mesh``, one a shard (its
        stars' observations, on its device), built at every call (once a fit)
        from the fitter's priors and bounds as they are then, and kept in
        ``_shards``."""
        from .parallel import check_mesh, replicas, shard_sizes

        mesh = check_mesh(mesh, self.device)
        ics = replicas(self.ic, mesh)
        bounds = np.cumsum([0] + shard_sizes(self.n_stars, mesh))
        self._shards = [self._shard(int(bounds[k]), int(bounds[k + 1]), ics[d]) for k, d in enumerate(mesh.devices)]
        return self._shards

    def _mesh_lnpost(self, mesh):
        """The posterior ``(x (S, B, 5), his (S, 5) or None) -> (S, B)`` with
        its star axis split over ``mesh`` (the counterpart of the JAX
        package's star-sharded ``_build_lnpost_data``): shard k evaluates
        its stars' parameters against its stars' observations, on its
        device (:meth:`_mesh_shards`)."""
        from .parallel import mesh_wrap_fn

        return mesh_wrap_fn([sub._lnpost for sub in self._mesh_shards(mesh)], mesh)

    # ------------------------------------------------------- nested sampling
    def _bounds_arrays(self):
        """Per-star parameter boxes: (los (5,), his (S, 5))."""
        los = np.array([
            self.eep_bounds[0], self.priors["age"].bounds[0], self.priors["feh"].bounds[0], 0.0,
            self.priors["AV"].bounds[0],
        ])
        his_shared = np.array([
            self.eep_bounds[1], self.priors["age"].bounds[1], self.priors["feh"].bounds[1], 0.0,
            self.priors["AV"].bounds[1],
        ])
        his = np.broadcast_to(his_shared, (self.n_stars, 5)).copy()
        his[:, 3] = self.max_distance
        return los, his

    def _lnpost_host(self, pars):
        lnp = self.lnpost_batch(pars).cpu().numpy()
        return np.where(np.isnan(lnp), -np.inf, lnp)

    def fit_multinest(
        self,
        n_live_points=500,
        max_iter=None,
        n_batch=8,
        n_chains=8,
        n_repeat=24,
        n_equal=2000,
        dlogz=0.01,
        min_ess=100.0,
        seed=None,
        mesh=None,
        dynamic=False,
        posterior_frac=0.025,
        max_dynamic_rounds=8,
        checkpoint=None,
        resume=False,
    ):
        """One nested-sampling run per star, the whole catalog in lockstep
        (:func:`~isochrones_torch.samplers.nested.run_nested_vmapped`): each
        walk step is one posterior call over every star's points. Returns a
        dict of per-star ``logz``, ``logzerr``, ``ess``, ``converged``, with
        ``n_dead`` and ``dynamic_rounds``; sets ``samples`` to (S, n_equal, 5)
        equal-weight draws (NaN rows for a star without posterior support)
        and ``evidence``.

        checkpoint/resume : the whole catalog's sampler state is written to
        ``checkpoint`` after every chunk; ``resume=True`` restores it, and the
        completed fit is bitwise the one that never stopped (the initial live
        points are drawn again, then replaced by the restored state).
        mesh : an :class:`~isochrones_torch.parallel.Mesh` whose first device
            is the fitter's: each walk call's star axis is split over its
            shards (the SLURM-array role over devices, reference
            scripts/batch_starfit); the samplers' state stays on the first
            device, so the fit is the unsharded one.
        """
        from .samplers.nested import run_nested_vmapped

        S, n_live = self.n_stars, int(n_live_points)
        rng = np.random.default_rng(seed)
        los, his = self._bounds_arrays()

        def box(u):
            return los[None, None] + (his[:, None] - los[None, None]) * u

        # initial live points: -inf starts are resampled in full batches
        with span("catalog.start"):
            u0 = rng.random((S, n_live, 5))
            lnl = self._lnpost_host(box(u0))
            for _ in range(200):
                bad = ~np.isfinite(lnl)
                if not bad.any():
                    break
                u_new = rng.random((S, n_live, 5))
                l_new = self._lnpost_host(box(u_new))
                take = bad & np.isfinite(l_new)
                u0 = np.where(take[..., None], u_new, u0)
                lnl = np.where(take, l_new, lnl)
        if not np.isfinite(lnl).all():
            getLogger().warning("fit_multinest: %d live points still invalid after init resampling",
                                int((~np.isfinite(lnl)).sum()))

        def lnlike_u(his_t, u):  # (S, B, 5) unit cube -> (S, B), every star at once, the box map in the kernel
            return self._lnpost(u, his_t)

        if mesh is not None:  # one a shard of the star axis, which the sampler splits over the mesh
            lnlike_u = [lambda his_t, u, lnpost=sub._lnpost: lnpost(u, his_t) for sub in self._mesh_shards(mesh)]
        out = run_nested_vmapped(
            lnlike_u, self._tensor(his), self._tensor(u0), self._tensor(lnl), n_live=n_live, n_batch=n_batch,
            n_chains=n_chains, n_repeat=n_repeat, n_equal=n_equal, dlogz=dlogz, min_ess=min_ess, max_iter=max_iter,
            seed=seed, rng=rng, mesh=mesh, label="star", dynamic=dynamic, posterior_frac=posterior_frac,
            max_dynamic_rounds=max_dynamic_rounds, checkpoint=checkpoint, resume=resume,
        )
        # unit cube -> per-star boxes (NaN rows of stars without support stay NaN)
        self._samples = box(out["samples_u"])
        self._lnprob = out["lnl"]
        self._evidence = (out["logz"], out["logzerr"])
        return dict(logz=out["logz"], logzerr=out["logzerr"], ess=out["ess"], n_dead=out["n_dead"],
                    converged=out["converged"], dynamic_rounds=out["dynamic_rounds"])

    @property
    def evidence(self):
        """(logz, logzerr) per-star arrays from fit_multinest."""
        if self._evidence is None:
            raise AttributeError("No evidence yet; run .fit_multinest()")
        return self._evidence

    # --------------------------------------------------------------- sampling
    def sample_p0(self, n_walkers, rng=None, max_rounds=50):
        """(S, W, 5) prior draws (numpy), rejection-refined to finite lnpost."""
        rng = np.random.default_rng(rng)
        S, W = self.n_stars, n_walkers

        def draw():
            age = self.priors["age"].sample(S * W, rng=rng)
            feh = self.priors["feh"].sample(S * W, rng=rng)
            AV = self.priors["AV"].sample(S * W, rng=rng)
            u = rng.random(S * W)
            d = (u ** (1.0 / 3.0)) * np.repeat(self.max_distance, W)  # the inverse CDF of d^2
            eep = self.priors["eep"].sample(S * W, rng=rng, age=age, feh=feh)  # conditioned on (age, feh)
            return np.stack([eep, age, feh, d, AV], axis=-1).reshape(S, W, 5)

        p0 = draw()
        bad = ~np.isfinite(self._lnpost_host(p0))
        rounds = 0
        while bad.any() and rounds < max_rounds:
            p0 = np.where(bad[..., None], draw(), p0)
            bad = ~np.isfinite(self._lnpost_host(p0))
            rounds += 1
        if bad.any():
            getLogger().warning("%d walkers still invalid after %d rounds", bad.sum(), rounds)
        return p0

    def fit_mcmc(self, nwalkers=128, nburn=500, niter=100, thin=1, seed=None, mesh=None):
        """One stretch-move ensemble per star, all in lockstep
        (:func:`~isochrones_torch.samplers.ensemble.run_ensemble_batch`).
        Returns samples of shape (n_stars, kept_steps * n_walkers, 5).
        ``mesh`` (an :class:`~isochrones_torch.parallel.Mesh`) splits the
        star axis of every posterior call, as in :meth:`fit_multinest`."""
        from .samplers.ensemble import run_ensemble_batch

        lnpost = self.lnpost_batch
        if mesh is not None:
            sharded = self._mesh_lnpost(mesh)

            def lnpost(pars):
                return sharded(pars, None)

        p0 = self._tensor(self.sample_p0(nwalkers, rng=seed))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else 0)
        _, _, state = run_ensemble_batch(lnpost, p0, gen, n_steps=nburn)
        chain, ln_chain, state = run_ensemble_batch(lnpost, state.walkers, gen, n_steps=niter, thin=thin)
        # (T, S, W, P) -> (S, T * W, P)
        T = chain.shape[0]
        self._samples = chain.permute(1, 0, 2, 3).reshape(self.n_stars, T * chain.shape[2], 5).cpu().numpy()
        self._lnprob = ln_chain.permute(1, 0, 2).reshape(self.n_stars, -1).cpu().numpy()
        self.sampler_state = state
        return self._samples

    @property
    def samples(self):
        if self._samples is None:
            raise AttributeError("No samples yet; run .fit_mcmc() or .fit_multinest()")
        return self._samples

    def summary(self, qs=(0.16, 0.5, 0.84)):
        """Per-star quantiles of the fitted parameters (the starfit-summarize
        product), as a :class:`~isochrones_torch.summary.Frame`."""
        from .summary import Frame

        out = Frame(index=self.catalog.index)
        for i, p in enumerate(self.param_names):
            for q, arr in zip(qs, np.quantile(self.samples[:, :, i], qs, axis=1)):
                out[f"{p}_{q * 100:02.0f}"] = arr
        return out


def fit_catalog(ic, catalog, method="mcmc", nwalkers=128, nburn=500, niter=100, n_live_points=500, seed=None,
                **kwargs):
    """Fit every star of ``catalog`` at once; returns ``(BatchStarFitter,
    per-star quantile summary)``.

    method : "mcmc" (lockstep ensembles) or "nested" (lockstep nested
        sampling, which also gives each star's evidence in
        ``fitter.evidence``).
    derived : add the quantiles of the derived physical quantities (mass,
        radius, Teff, ...) from one interpolator call over every draw
        (:func:`~isochrones_torch.summary.summarize_batch`). Default True.
    dynamic : (nested only) dynamic nested sampling for the whole catalog.
    Other keywords go to :class:`BatchStarFitter` (``device``, ``dtype`` when
    ``ic`` is a grid name). ``mesh`` splits the star axis of either fit.
    """
    from .summary import summarize_batch

    derived = kwargs.pop("derived", True)
    mesh = kwargs.pop("mesh", None)
    dynamic = kwargs.pop("dynamic", False)
    fitter = BatchStarFitter(ic, catalog, **kwargs)
    if method == "nested":
        fitter.fit_multinest(n_live_points=n_live_points, seed=seed, mesh=mesh, dynamic=dynamic)
    else:
        fitter.fit_mcmc(nwalkers=nwalkers, nburn=nburn, niter=niter, seed=seed, mesh=mesh)
    return fitter, summarize_batch(fitter, qs=(0.16, 0.5, 0.84), derived=derived)
