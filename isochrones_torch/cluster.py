"""Star-cluster hierarchical model (counterpart of
``isochrones_tpu/cluster.py``, ``StarClusterModel``).

The 7-parameter cluster likelihood (age, feh, distance, AV, alpha, gamma,
fB) marginalizes each member star over its (primary EEP, secondary EEP)
plane on a fixed EEP ladder. The walker batch is a leading dimension written
out: one ``lnpost_batch`` call interpolates the ladder for every walker and
hands all walkers to :func:`~isochrones_torch.ops.cluster.cluster_lnmarginal`,
which on the card is one launch of the hand-written CUDA kernel.

Not ported yet: ``SimulatedCluster``/``simulate_cluster`` (need EEP
inversion), the nested-sampling ``fit``/``clusterfit``, and the multi-device
star sharding.
"""

from __future__ import annotations

import numpy as np
import torch

from .catalog import StarCatalog
from .logger import getLogger
from .ops.cluster import cluster_lnmarginal
from .ops.interp import interp_nd
from .ops.mags import interp_mag as _interp_mag_kernel
from .priors import FehPrior, FlatLogPrior, FlatPrior, GaussianPrior, PowerLawPrior
from .starmodel import BasicStarModel

__all__ = ["StarClusterModel"]


class StarClusterModel(BasicStarModel):
    """Hierarchical 7-parameter cluster model (reference cluster.py:182-411).

    Each member star is marginalized over its (primary EEP, secondary EEP)
    plane with a binary-fraction photometric mixture, a power-law(alpha)
    primary-mass prior (with the |dm/dEEP| Jacobian), and a power-law(gamma)
    mass-ratio prior. The model runs on the interpolator's device and dtype.
    """

    _cluster_param_names = ("age", "feh", "distance", "AV", "alpha", "gamma", "fB")

    def __init__(
        self,
        ic,
        stars,
        name="",
        halo_fraction=0.5,
        max_AV=1.0,
        max_distance=50000,
        eep_bounds=None,
        mass_bounds=None,
        minq=0.1,
        q_jacobian=False,
        eep_step=1.0,
        **kwargs,
    ):
        self._fn_cache = {}
        self._ic = ic
        #: False = exact reference-parity marginalization; True adds the
        #: |dq/deep2| change-of-variables factor (see ops/cluster.py)
        self.q_jacobian = bool(q_jacobian)
        #: EEP-ladder spacing of the (eep1, eep2) marginalization
        self.eep_step = float(eep_step)
        if not isinstance(stars, StarCatalog):
            stars = StarCatalog(stars, **kwargs)
        self.stars = stars

        self._priors = {
            "age": FlatLogPrior(bounds=(6, 10.15)),
            "feh": FehPrior(halo_fraction=halo_fraction),
            "AV": FlatPrior(bounds=(0, max_AV)),
            "distance": PowerLawPrior(alpha=2.0, bounds=(0, max_distance)),
            "alpha": FlatPrior(bounds=(-4, -1)),
            "gamma": GaussianPrior(0.3, 0.1),
            "fB": FlatPrior(bounds=(0.0, 0.6)),
        }
        self._bounds = {}
        self._eep_bounds = eep_bounds
        self._mass_bounds = mass_bounds
        self.minq = minq
        self.name = str(name)
        self._samples = None

    @property
    def param_names(self):
        return self._cluster_param_names

    @property
    def bands(self):
        return self.stars.bands

    @property
    def props(self):
        return self.stars.props

    def bounds(self, prop):
        """reference cluster.py:241-259; ``set_bounds`` overrides win."""
        override = self._bounds.get(prop)
        if override is not None:
            return override
        if prop == "eep":
            return self._eep_bounds if self._eep_bounds is not None else (self.ic.mineep, self.ic.maxeep)
        if prop == "mass":
            return self._mass_bounds if self._mass_bounds is not None else (self.ic.minmass, self.ic.maxmass)
        b = getattr(self._priors[prop], "bounds", None)
        if b is not None and np.isfinite(b).all():
            return b
        if prop == "age":
            return (self.ic.minage, self.ic.maxage)
        if prop == "feh":
            return (self.ic.minfeh, self.ic.maxfeh)
        if prop in ("gamma", "fB"):
            return (0, 1)
        return b

    @property
    def _n_ladder(self):
        """Marginalization-ladder length (count-based, never past maxeep)."""
        mineep, maxeep = self.bounds("eep")
        return int(np.floor((float(maxeep) - float(mineep)) / self.eep_step + 1e-9)) + 1

    # ----------------------------------------------------------- batched fns
    def _build_lnprior_batch(self):
        priors = self._priors
        names = self.param_names

        def lnprior_batch(p):
            lnp = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
            for i, par in enumerate(names):
                lnp = lnp + priors[par].lnpdf(p[..., i])
            return lnp

        return lnprior_batch

    def _build_block_lnmarg(self):
        """Per-star marginal ln-likelihoods for a walker batch, as a function
        of the parameters (W, 7) and the observation stacks."""
        ic = self.ic
        dt, dev = ic.dtype, ic.device
        mineep, _ = self.bounds("eep")
        n_eep = self._n_ladder
        eeps = float(mineep) + self.eep_step * torch.arange(n_eep, dtype=dt, device=dev)
        io = tuple(ic._param_index_order)
        model = ic.model
        ci = model.column_index
        mass_icols = (ci["initial_mass"], ci["dm_deep"])
        band_icols = tuple(ic.bc.column_index[b] for b in self.bands)
        mass_lo, mass_hi = self.bounds("mass")
        minq = self.minq
        prop_meta = [(p == "parallax", None if p == "parallax" else ci[p]) for p, _ in self.stars.iter_props()]
        q_jacobian = self.q_jacobian

        def block_lnmarg(p, mv, mu, pv, pu):
            """p : (W, 7) -> (W, S). The ladder evaluations are shared by
            the stars; the walker batch leads every tensor."""
            age, feh, distance, AV, alpha, gamma, fB = p.unbind(dim=-1)
            W = p.shape[0]
            shape = (W, n_eep)
            user = [eeps.expand(shape), age[:, None].expand(shape), feh[:, None].expand(shape)]
            grid_pts = torch.stack([user[io[0]], user[io[1]], user[io[2]]], dim=-1)  # (W, E, 3)
            mvals = interp_nd(model.values, model.knots, grid_pts, icols=mass_icols, axis_maps=model.axis_maps)
            masses = mvals[..., 0]
            ln_dm = torch.log(torch.abs(mvals[..., 1]))

            pts5 = torch.stack(
                [eeps.expand(shape)] + [x[:, None].expand(shape) for x in (age, feh, distance, AV)], dim=-1
            )
            _, _, _, model_mags = _interp_mag_kernel(
                pts5, io, ic.model_packed, ic._packed_icols, ic.bc, band_icols
            )  # (W, E, B)

            # per-star property lnlike (W, S, E) (reference cluster.py:316-325)
            lnlike_prop = torch.zeros((W, mv.shape[0], n_eep), dtype=p.dtype, device=p.device)
            for j, (is_plax, icol) in enumerate(prop_meta):
                if is_plax:
                    model_v = (1000.0 / distance)[:, None].expand(shape)
                else:
                    model_v = interp_nd(model.values, model.knots, grid_pts, icols=(icol,),
                                        axis_maps=model.axis_maps)[..., 0]
                z = (pv[None, :, j : j + 1] - model_v[:, None, :]) / pu[None, :, j : j + 1]
                lnlike_prop = lnlike_prop - 0.5 * z * z

            finite = torch.isfinite(masses) & torch.isfinite(ln_dm) & torch.isfinite(model_mags).all(dim=-1)
            # primary rows live inside the mass-prior box; secondary rows
            # are constrained only through q >= minq
            valid = finite & (masses >= mass_lo) & (masses <= mass_hi)
            lnlike_prop = torch.nan_to_num(lnlike_prop, nan=float("-inf"))
            ln_dm_safe = torch.where(finite, ln_dm, torch.zeros_like(ln_dm))
            masses_safe = torch.where(finite, masses, torch.ones_like(masses))
            mags_safe = torch.where(finite[..., None], model_mags, torch.zeros_like(model_mags))

            return cluster_lnmarginal(
                lnlike_prop, mags_safe, masses_safe, ln_dm_safe, eeps, mv, mu,
                alpha, gamma, fB, mass_lo, mass_hi, minq,
                valid=valid, q_jacobian=q_jacobian, valid_k=finite,
            )

        return block_lnmarg

    def _build_lnlike_batch(self):
        block_lnmarg = self._build_block_lnmarg()
        dt, dev = self.dtype, self.device
        mag_vals, mag_uncs, prop_vals, prop_uncs = self.stars.observation_stacks()
        if np.isnan(mag_vals).any():
            getLogger().warning(
                "StarClusterModel: %d stars have NaN photometry; the cluster "
                "likelihood will be -inf everywhere. Drop those rows.",
                int(np.isnan(mag_vals).any(axis=1).sum()),
            )
        obs = tuple(torch.as_tensor(x, dtype=dt, device=dev) for x in (mag_vals, mag_uncs, prop_vals, prop_uncs))
        self._star_lnmarg_fn = lambda p: block_lnmarg(p, *obs)

        def lnlike_batch(p):
            """(..., 7) -> (...): the sum of the member marginals, -inf if
            any member has no support."""
            flat = p.reshape(-1, p.shape[-1])
            lnmarg = block_lnmarg(flat, *obs)
            good = torch.isfinite(lnmarg)
            total = torch.where(good, lnmarg, torch.zeros_like(lnmarg)).sum(dim=-1)
            total = torch.where(good.all(dim=-1), total, float("-inf"))
            return total.reshape(p.shape[:-1])

        return lnlike_batch

    def star_lnmarginals(self, p):
        """Per-star marginal ln-likelihoods at one parameter vector ``p`` —
        the support diagnostic: a non-finite entry is a member with no
        (eep1, eep2) support, which makes the whole lnlike -inf. Returns a
        numpy array in catalog order."""
        self._get_fn("lnlike")  # builds _star_lnmarg_fn
        return self._star_lnmarg_fn(self._as_params(p)[None, :])[0].cpu().numpy()

    def emcee_p0(self, n_walkers, rng=None):
        """Uniform draws inside the prior box, redrawn where lnpost is -inf."""
        rng = np.random.default_rng(rng)
        los, his = self._bounds_arrays()
        p0 = los + (his - los) * rng.random((n_walkers, len(los)))
        bad = ~np.isfinite(self.lnpost_batch(p0).cpu().numpy())
        tries = 0
        while bad.any() and tries < 100:
            p0[bad] = los + (his - los) * rng.random((int(bad.sum()), len(los)))
            bad = ~np.isfinite(self.lnpost_batch(p0).cpu().numpy())
            tries += 1
        return p0
