"""Star-cluster hierarchical models (counterpart of
``isochrones_tpu/cluster.py``: ``StarClusterModel``, ``SimulatedCluster``,
``simulate_cluster`` and the ``clusterfit`` entry point).

The 7-parameter cluster likelihood (age, feh, distance, AV, alpha, gamma,
fB) marginalizes each member star over its (primary EEP, secondary EEP)
plane on a fixed EEP ladder. The walker batch is a leading dimension written
out: one ``lnpost_batch`` call interpolates the ladder for every walker and
hands all walkers to :func:`~isochrones_torch.ops.cluster.cluster_lnmarginal`,
which on the card is one launch of the hand-written CUDA kernel; a batch
whose tensors would pass a byte budget is cut into pieces of walkers.
``fit()`` is the nested fit (dynamic by default: a cluster marginal is costly
per call), ``fit_mcmc`` the ensemble one. Catalogues are dicts of numpy
columns (:class:`~isochrones_torch.catalog.StarCatalog`); ``clusterfit`` reads
a pandas HDF table or a CSV file (:func:`~isochrones_torch.catalog.read_table`).

With ``StarClusterModel(mesh=)`` the star axis is split over the mesh's
shards: every shard takes all the walkers and its own members' stacks, runs
the ladder and the cluster marginal on its device, and returns the sum of its
finite marginals and its count of non-finite ones; both are summed over the
shards on the mesh's first device (the JAX package's ``psum``).
"""

from __future__ import annotations

import numpy as np
import torch

from .catalog import StarCatalog, read_table
from .logger import getLogger
from .ops.cluster import cluster_lnmarginal
from .ops.interp import interp_nd
from .ops.mags import interp_mag as _interp_mag_kernel
from .priors import FehPrior, FlatLogPrior, FlatPrior, GaussianPrior, PowerLawPrior
from .starmodel import BasicStarModel
from .utils import addmags

__all__ = ["StarClusterModel", "SimulatedCluster", "simulate_cluster", "clusterfit"]

#: bytes of walker-batched tensors one likelihood call may hold; a longer
#: batch is cut into pieces of walkers
_WALKER_BYTES_BUDGET = 1 << 32


def _finite_sum(lnmarg):
    """``(W, S)`` member marginals -> the sum of the finite ones and the count
    of the others, each ``(W,)``: a cluster's (or a star shard's) part of the
    likelihood, which is -inf where the count is positive."""
    good = torch.isfinite(lnmarg)
    return torch.where(good, lnmarg, torch.zeros_like(lnmarg)).sum(dim=-1), (~good).sum(dim=-1)


def _walker_bytes(n_stars, n_ladder, n_bands, itemsize):
    """Estimate of the bytes one walker's tensors take in a likelihood call
    on an E-point ladder: the (S, E) property likelihood with its
    temporaries and the kernel wrapper's row term (~8 such planes), the 8
    corner rows, weights and int64 indices of the model interpolations (2 +
    4 + 2 columns), the 16 of the BC interpolation (B columns), and a few
    (E, B) magnitude planes."""
    floats = 8 * n_stars + 8 * (2 + 4 + 2) + 16 * (n_bands + 1) + 4 * n_bands
    return max(n_ladder * (itemsize * floats + 8 * (8 + 8 + 16)), 1)


class StarClusterModel(BasicStarModel):
    """Hierarchical 7-parameter cluster model (reference cluster.py:182-411).

    Each member star is marginalized over its (primary EEP, secondary EEP)
    plane with a binary-fraction photometric mixture, a power-law(alpha)
    primary-mass prior (with the |dm/dEEP| Jacobian), and a power-law(gamma)
    mass-ratio prior. The model runs on the interpolator's device and dtype;
    ``mesh`` (an :class:`~isochrones_torch.parallel.Mesh` whose first device
    is the interpolator's) splits the star axis of every likelihood call.
    """

    _cluster_param_names = ("age", "feh", "distance", "AV", "alpha", "gamma", "fB")
    #: a cluster marginal is costly per call, so the nested fit is dynamic by
    #: default (override with ``fit(dynamic=False)``)
    _default_dynamic = True

    def _config_data_repr(self):
        """The cluster's data is its catalogue, not ``self.kwargs``: a stable
        text of the catalogue's columns and rows and of the marginalization
        geometry, so a resume against other member data or another ladder is
        refused instead of replaying the old checkpoint."""
        data = self.stars.data
        return "|".join(
            [",".join(data)] + [repr(np.asarray(v).tolist()) for v in data.values()]
            + [repr((self._eep_bounds, self._mass_bounds, self.minq, self.eep_step, self.q_jacobian))]
        )

    def __init__(
        self,
        ic,
        stars,
        name="",
        halo_fraction=0.5,
        max_AV=1.0,
        max_distance=50000,
        use_emcee=False,
        eep_bounds=None,
        mass_bounds=None,
        minq=0.1,
        directory=".",
        mesh=None,
        q_jacobian=False,
        eep_step=1.0,
        **kwargs,
    ):
        if mesh is not None:
            from .parallel import check_mesh

            check_mesh(mesh, ic.device)
        self._fn_cache = {}
        self._ic = ic
        self.mesh = mesh
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
        self.use_emcee = use_emcee
        self._eep_bounds = eep_bounds
        self._mass_bounds = mass_bounds
        self.minq = minq
        self.name = str(name)
        self.N = None
        self.kwargs = {}
        self._samples = None
        self._derived_samples = None
        self._evidence = None
        self._nested_result = None
        self._directory = str(directory)

    @property
    def param_names(self):
        return self._cluster_param_names

    @property
    def n_params(self):
        return len(self.param_names)

    @property
    def bands(self):
        return self.stars.bands

    @property
    def props(self):
        return self.stars.props

    @property
    def labelstring(self):
        return "cluster" + (f"_{self.name}" if self.name else "")

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
            # neighbouring ladder points fall in neighbouring cells: on the
            # card, kernel B reads column-planar copies of the ladder's columns
            mvals = interp_nd(model.values, model.knots, grid_pts, icols=mass_icols, axis_maps=model.axis_maps,
                              planar=True)
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
                                        axis_maps=model.axis_maps, planar=True)[..., 0]
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

    def _build_lnlike_dataset(self):
        """Cluster ln-likelihood as a function of the observations:
        ``lnlike(p (..., 7), mag_vals (S, B), mag_uncs (S, B), prop_vals
        (S, P), prop_uncs (S, P)) -> (...)``: the sum of the member marginals,
        -inf if any member has no support."""
        block_lnmarg = self._build_block_lnmarg()

        def lnlike_dataset(p, mv, mu, pv, pu):
            total, n_bad = _finite_sum(block_lnmarg(p.reshape(-1, p.shape[-1]), mv, mu, pv, pu))
            return torch.where(n_bad > 0, float("-inf"), total).reshape(p.shape[:-1])

        return lnlike_dataset

    def _build_sharded_lnlike(self, obs, mesh):
        """The likelihood with its star axis split over ``mesh``: ``(lnlike_flat
        (W, 7) -> (W,), star_lnmarg (W, 7) -> (W, S) in catalog order, the
        most stars a shard holds)``. Each shard runs ``block_lnmarg`` on its
        device (a copy of the model's tables per distinct device; the model
        itself on its own) over all the walkers and its members; the shards'
        partial sums and counts of non-finite marginals add up on the first
        device. A mesh of the model's one device is the unsharded model."""
        from .parallel import mesh_constrain_leading, replicas

        reps = replicas(self, mesh)
        fns = {d: m._build_block_lnmarg() for d, m in reps.items()}
        stacks = mesh_constrain_leading(obs, mesh)
        shards = [(fns[d], d, st) for d, st in zip(mesh.devices, stacks) if st[0].shape[0] > 0]
        first = mesh.devices[0]

        def lnlike_flat(flat):
            # every shard's launches go out before any result is read
            parts = [_finite_sum(fn(flat.to(d), *st)) for fn, d, st in shards]
            total, n_bad = (x.to(first) for x in parts[0])
            for part, bad in parts[1:]:
                total = total + part.to(first)
                n_bad = n_bad + bad.to(first)
            return torch.where(n_bad > 0, float("-inf"), total)

        def star_lnmarg(p):
            return torch.cat([fn(p.to(d), *st).to(first) for fn, d, st in shards], dim=1)

        return lnlike_flat, star_lnmarg, max(st[0].shape[0] for _, _, st in shards)

    def _build_lnlike_batch(self):
        from .parallel import Mesh

        dt, dev = self.dtype, self.device
        mag_vals, mag_uncs, prop_vals, prop_uncs = self.stars.observation_stacks()
        if np.isnan(mag_vals).any():
            getLogger().warning(
                "StarClusterModel: %d stars have NaN photometry; the cluster "
                "likelihood will be -inf everywhere. Drop those rows.",
                int(np.isnan(mag_vals).any(axis=1).sum()),
            )
        obs = tuple(torch.as_tensor(x, dtype=dt, device=dev) for x in (mag_vals, mag_uncs, prop_vals, prop_uncs))
        mesh = self.mesh if self.mesh is not None else Mesh([dev], ("stars",))
        lnlike_flat, self._star_lnmarg_fn, n_stars = self._build_sharded_lnlike(obs, mesh)

        # walkers per call: the nested fit hands over n_batch * n_chains walk
        # points at once and n_live at its start; a shard holds its stars' planes
        per_walker = _walker_bytes(n_stars, self._n_ladder, mag_vals.shape[1], torch.empty((), dtype=dt).element_size())
        max_parallel = max(1, _WALKER_BYTES_BUDGET // per_walker)

        def lnlike_batch(p):
            """(..., 7) -> (...), in pieces of at most ``max_parallel`` walkers."""
            flat = p.reshape(-1, p.shape[-1])
            if flat.shape[0] <= max_parallel:
                out = lnlike_flat(flat)
            else:
                out = torch.cat([lnlike_flat(flat[i : i + max_parallel]) for i in range(0, flat.shape[0], max_parallel)])
            return out.reshape(p.shape[:-1])

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

    def sample_from_prior(self, n, values=False, require_valid=True, rng=None):
        """Uniform draws inside the prior box with a finite posterior, as a
        dict of numpy columns, or the (n, 7) array with ``values=True``."""
        arr = self.emcee_p0(n, rng=rng)
        return arr if values else {p: arr[:, i] for i, p in enumerate(self.param_names)}

    def _make_samples(self):
        """Cluster samples are the raw chain (reference cluster.py:389-411)."""
        self._derived_samples = dict(self.samples)


class SimulatedCluster(StarCatalog):
    """Synthetic cluster photometry catalogue (reference cluster.py:71-179).

    Star generation is batched: one ``get_eep`` and one ``interp_mag`` call
    per component. The host draws come from one ``numpy.random.Generator``
    (seeded by ``rng``) in a fixed order: binary flags, primary masses, mass
    ratios, distances, then the photometric noise band by band. ``ic`` is
    built with :func:`~isochrones_torch.isochrone.get_ichrone` on ``device``
    (the card unless the caller passes ``device="cpu"``) when not given."""

    def __init__(
        self,
        N,
        age,
        feh,
        distance,
        AV,
        alpha,
        gamma,
        fB,
        bands="JHK",
        mass_range=(0.3, 2.5),
        distance_scatter=5,
        models="synthetic",
        phot_unc=0.01,
        ic=None,
        rng=None,
        device="cuda",
        **ic_kwargs,
    ):
        self.N = N
        self.age = age
        self.feh = feh
        self.distance = distance
        self.AV = AV
        self.alpha = alpha
        self.gamma = gamma
        self.fB = fB
        self.pars = [age, feh, distance, AV, alpha, gamma, fB]
        self.bands = tuple(bands)
        self.mass_range = mass_range
        self.distance_scatter = distance_scatter
        self.phot_unc = phot_unc
        self._rng = np.random.default_rng(rng)

        if ic is None:
            from .isochrone import get_ichrone

            ic = get_ichrone(models, device=device, **ic_kwargs)
        self.ic = ic

        super().__init__(self._generate(), bands=tuple(bands), props=["parallax"])

    def evolve(self, age):
        """Same stars at a different age (reference cluster.py:112-119)."""
        d = self.data
        data = self._simulate_stars(age, d["is_binary"], d["mass_pri"], d["mass_sec"], d["distance"])
        return StarCatalog(data, bands=self.bands, props=["parallax"])

    def _generate(self):
        N = self.N
        age, feh, distance, AV, alpha, gamma, fB = self.pars
        r = self._rng
        is_binary = r.random(N) < fB
        pri = PowerLawPrior(alpha, self.mass_range).sample(N, rng=r)
        qs = PowerLawPrior(gamma, (0.2, 1)).sample(N, rng=r)
        sec = pri * qs * is_binary
        sec[(sec < 0.1) & (sec > 0)] = 0.1
        distances = distance + r.standard_normal(N) * self.distance_scatter
        stars = self._simulate_stars(age, is_binary, pri, sec, distances)

        # redraw dead stars (a mass evolved past its track's end at this age
        # has NaN photometry, and one NaN row poisons the whole likelihood)
        band_cols = [f"{b}_mag" for b in self.bands]
        for _ in range(100):
            bad = np.isnan(np.stack([stars[c] for c in band_cols], axis=-1)).any(axis=-1)
            if not bad.any():
                break
            nb = int(bad.sum())
            is_binary[bad] = r.random(nb) < fB
            pri[bad] = PowerLawPrior(alpha, self.mass_range).sample(nb, rng=r)
            q_new = PowerLawPrior(gamma, (0.2, 1)).sample(nb, rng=r)
            sec[bad] = pri[bad] * q_new * is_binary[bad]
            sec[(sec < 0.1) & (sec > 0)] = 0.1
            distances[bad] = distance + r.standard_normal(nb) * self.distance_scatter
            stars = self._simulate_stars(age, is_binary, pri, sec, distances)
        else:
            getLogger().warning("SimulatedCluster: NaN photometry rows remain after redraws")
        return stars

    def _simulate_stars(self, age, is_binary, pri_masses, sec_masses, distances):
        N = len(pri_masses)
        _, feh, distance, AV, alpha, gamma, fB = self.pars
        r = self._rng
        track = self.ic.track if self.ic.eep_replaces == "mass" else self.ic

        pri_eeps = track.get_eep(pri_masses, age, feh)
        sec_eeps = np.where(sec_masses > 0, track.get_eep(np.maximum(sec_masses, 1e-3), age, feh), np.nan)

        iso = self.ic if self.ic.eep_replaces == "mass" else self.ic.iso
        bands = list(self.bands)
        _, _, _, pri_mags = iso.interp_mag(
            [pri_eeps, np.full(N, age), np.full(N, feh), distances, np.full(N, AV)], bands
        )
        sec_safe = np.where(np.isfinite(sec_eeps), sec_eeps, pri_eeps)
        _, _, _, sec_mags = iso.interp_mag(
            [sec_safe, np.full(N, age), np.full(N, feh), distances, np.full(N, AV)], bands
        )
        sec_mags = np.where(np.isfinite(sec_eeps)[:, None], sec_mags, np.inf)

        stars = {f"{b}_mag": addmags(pri_mags[:, i], sec_mags[:, i]) for i, b in enumerate(bands)}
        stars["is_binary"] = np.array(is_binary)
        stars["distance"] = np.array(distances)
        stars["mass_pri"] = np.array(pri_masses)
        stars["mass_sec"] = np.array(sec_masses)
        stars["eep_pri"] = pri_eeps
        stars["eep_sec"] = sec_eeps
        unc = self.phot_unc
        for b in bands:
            stars[f"{b}_mag"] = stars[f"{b}_mag"] + r.standard_normal(N) * unc
            stars[f"{b}_mag_unc"] = np.full(N, float(unc))
        stars["parallax"] = 1000.0 / np.asarray(distances)
        stars["parallax_unc"] = np.full(N, 0.2)
        return stars


def simulate_cluster(
    N, age, feh, distance, AV, alpha, gamma, fB,
    bands="JHK", mass_range=(0.8, 2.5), distance_scatter=5, iso=None, rng=None, **ic_kwargs,
):
    """Functional synthetic-cluster generator (reference cluster.py:414-477)."""
    sim = SimulatedCluster(
        N, age, feh, distance, AV, alpha, gamma, fB, bands=bands,
        mass_range=mass_range, distance_scatter=distance_scatter,
        ic=iso, rng=rng, **ic_kwargs,
    )
    data = dict(sim.data)
    for name, value in (("age", age), ("feh", feh), ("AV", AV)):
        data[name] = np.full(len(sim), float(value))
    return StarCatalog(data, bands=tuple(bands), props=["parallax"])


def clusterfit(
    starfile,
    bands=None,
    props=None,
    models="mist",
    max_distance=10000,
    mineep=200,
    maxeep=800,
    maxAV=0.1,
    minq=0.2,
    overwrite=False,
    nlive=1000,
    name="",
    halo_fraction=0.5,
    comm=None,
    rank=0,
    max_iter=None,
    eep_step=1.0,
    q_jacobian=False,
    dynamic=None,
    min_ess=None,
    device="cuda",
    dtype=torch.float64,
    seed=None,
):
    """Cluster-fit entry point (reference cluster.py:20-68): a table of member
    photometry -> :class:`StarClusterModel` -> nested fit; returns the fitted
    model. The table is a pandas HDF table (``.h5``, ``.hdf``, ``.hdf5``;
    ``DataFrame.to_hdf`` in the ``fixed`` or ``table`` format) or a CSV file
    (:func:`~isochrones_torch.catalog.read_table`). The grids are built and
    the fit runs on ``device`` (the card unless the caller passes
    ``device="cpu"``) in ``dtype``; ``seed`` seeds the nested fit (None: a
    fresh seed each call, as in the reference). The reference broadcasts the
    model over MPI; here ``comm`` and ``rank`` are accepted and ignored."""
    if comm is not None:
        getLogger().info("MPI comm ignored: the sampler runs on one device.")

    cat = StarCatalog(read_table(starfile), bands=bands, props=props)
    getLogger().info("bands = %s", cat.bands)

    from .isochrone import get_ichrone

    ic = get_ichrone(models, bands=cat.bands, device=device, dtype=dtype)
    model = StarClusterModel(
        ic, cat, eep_bounds=(mineep, maxeep), max_distance=max_distance,
        minq=minq, halo_fraction=halo_fraction, max_AV=maxAV, name=name,
        eep_step=eep_step, q_jacobian=q_jacobian,
    )
    # loud support check: one unsupported star makes every walker -inf and
    # the sampler silently returns prior draws
    los, his = model._bounds_arrays()
    probe = los + (his - los) * np.random.default_rng(0).random((8, len(los)))
    if not np.isfinite(model.lnpost_batch(probe).cpu().numpy()).any():
        marg = model.star_lnmarginals(probe[0])
        bad = np.flatnonzero(~np.isfinite(marg)).tolist()
        getLogger().warning(
            "cluster lnlike is -inf at all probe points; stars with no "
            "(eep, q) support (NaN photometry, or no ladder cell inside "
            "the mass box): rows %s. Drop those rows or fix the bounds.", bad,
        )
    fit_kw = dict(overwrite=overwrite, n_live_points=nlive, max_iter=max_iter)
    if dynamic is not None:
        # None defers to the model's default (dynamic); --static forces it off
        fit_kw["dynamic"] = dynamic
    if min_ess is not None:
        fit_kw["min_ess"] = min_ess
    if seed is not None:
        fit_kw["seed"] = seed
    model.fit(**fit_kw)
    if model.evidence is not None:
        getLogger().info("clusterfit %s: logz = %.4f +- %.4f", model.labelstring, *model.evidence)
    return model
