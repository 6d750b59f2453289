"""Tree-based ``StarModel`` for resolved/blended multi-star systems
(counterpart of ``isochrones_tpu/treemodel.py``).

The general model over an :class:`~isochrones_torch.observation.ObservationTree`,
plus ``StarModelGroup``. It inherits the inference plumbing (fit / fit_mcmc /
fit_multinest / samples) from :class:`~isochrones_torch.starmodel.BasicStarModel`;
its likelihood is the compiled-plan tree likelihood
(:func:`isochrones_torch.ops.tree.tree_lnlike_fused`): the hand-written CUDA
kernel on the card, its plain version on the CPU. The posterior is fused as
the flat model's is: one call gives the likelihood and, per star, the EEP
prior's two interpolated columns, so the prior interpolates nothing itself.
Samples and tables are dicts of numpy columns and lists of row dicts where
the JAX package has DataFrames.
"""

from __future__ import annotations

import json
import os
import re
from copy import deepcopy
from typing import Dict

import numpy as np
import torch

from .logger import getLogger
from .observation import (
    Observation, ObservationTree, Source, make_tree_lnlike, make_tree_lnlike_fused, read_rows_csv,
)
from .priors import AgePrior, AVPrior, ChabrierPrior, DistancePrior, EEP_prior, FehPrior, QPrior, eep_change_of_variables
from .starmodel import BasicStarModel, N_options, _stored_ichrone, index_options
from .utils import addmags, npz_load, npz_save, store_prefix

__all__ = ["StarModel", "StarModelGroup", "ini_photometry_rows"]


def ini_photometry_rows(c, scalars_out=None):
    """Parsed star.ini mapping -> photometry rows for
    :meth:`ObservationTree.from_df` (the section conventions of reference
    starmodel.py:248-436: one section per instrument; ``resolution`` implies
    companions with relative photometry unless ``relative`` is explicit;
    companion tags ``K_1``/``separation_1``/...). Non-section scalars are
    copied into ``scalars_out`` when given."""
    from .iniparse import IniSection, parse_value

    rows = []
    for k, v in c.items():
        if not isinstance(v, IniSection):
            if scalars_out is not None:
                scalars_out[k] = parse_value(v)
            continue
        instrument = k
        sec = v
        if "resolution" in sec:
            resolution = float(parse_value(sec["resolution"]))
            relative = True
        else:
            resolution = 4.0
            relative = False
        if "relative" in sec:
            relative = str(sec["relative"]) == "True"

        tags = []
        sec_bands = []
        for label in sec:
            m = re.search(r"separation(_\w+)?", label)
            if m:
                if m.group(1) is not None and m.group(1) not in tags:
                    tags.append(m.group(1))
            elif re.search(r"PA", label) or re.search(r"id", label) or label in ("resolution", "relative"):
                continue
            else:
                m = re.search(r"([a-zA-Z0-9]+)(_\w+)?", label)
                if m and m.group(1) not in sec_bands:
                    sec_bands.append(m.group(1))
        if sec_bands and (not tags or sec_bands[0] in sec):
            tags.append("")

        for b in sec_bands:
            for tag in tags:
                key = f"{b}{tag}"
                if key not in sec:
                    continue
                mag, e_mag = parse_value(sec[key])
                if np.isnan(mag) or np.isnan(e_mag):
                    continue
                sep_key = f"separation{tag}"
                rows.append(
                    dict(
                        name=instrument, band=b, resolution=resolution, relative=relative,
                        separation=float(parse_value(sec[sep_key])) if sep_key in sec else 0.0,
                        pa=float(parse_value(sec[f"PA{tag}"])) if f"PA{tag}" in sec else 0.0,
                        mag=float(mag), e_mag=float(e_mag),
                    )
                )
            if relative:
                rows.append(
                    dict(name=instrument, band=b, resolution=resolution, relative=relative,
                         separation=0.0, pa=0.0, mag=0.0, e_mag=0.01)
                )
    return rows


class StarModel(BasicStarModel):
    """General (tree-based) star model (reference starmodel.py:63-1317).

    Use for resolved systems / blended photometry; for flat single/binary/
    triple fits prefer :class:`BasicStarModel`.
    """

    #: a tree likelihood call costs several times the fused flat model's:
    #: dynamic nested sampling by default (override with fit(dynamic=False))
    _default_dynamic = True

    def _config_data_repr(self):
        """Tree models keep their data in the observation tree, not in
        ``self.kwargs``: hash the photometry table plus the spectroscopy,
        parallax and limit attachments, so a resume against an edited
        star.ini refuses instead of replaying the stale checkpoint."""
        rows = self.obs.to_df()
        cols = list(rows[0]) if rows else []
        table = [",".join(cols)] + [",".join(repr(r[c]) for c in cols) for r in rows]
        parts = ["\n".join(table)]
        for attr in ("spectroscopy", "parallax", "limits"):
            parts.append(repr(sorted(getattr(self.obs, attr, {}).items())))
        return "|".join(parts)

    def __init__(
        self,
        ic,
        obs=None,
        N=1,
        index=0,
        name="",
        use_emcee=False,
        RA=None,
        dec=None,
        coords=None,
        eep_bounds=None,
        directory=".",
        **kwargs,
    ):
        self._fn_cache: Dict[str, object] = {}
        self.name = str(name) if name else (obs.name if obs is not None and getattr(obs, "name", None) else "")
        self.coords = coords
        self.ra = RA
        self.dec = dec
        self._ic = ic
        self.use_emcee = use_emcee
        self.eep_bounds = tuple(eep_bounds) if eep_bounds is not None else tuple(ic.eep_bounds)
        self.N = None  # the tree determines the multiplicity

        if obs is None:
            self._build_obs(**kwargs)
            self.obs.define_models(ic, N=N, index=index)
            self._add_properties(**kwargs)
        elif isinstance(obs, str):
            self.obs = ObservationTree.from_df(read_rows_csv(obs))
            self.obs.define_models(ic, N=N, index=index)
            self._add_properties(**kwargs)
        else:
            self.obs = obs
            if len(self.obs.get_model_nodes()) == 0:
                self.obs.define_models(ic, N=N, index=index)
                self._add_properties(**kwargs)

        # prior stack (reference starmodel.py:166-178)
        self._priors = {
            "mass": ChabrierPrior(),
            "feh": FehPrior(),
            "q": QPrior(),
            "age": AgePrior(),
            "distance": DistancePrior(),
            "AV": AVPrior(),
        }
        self._priors["eep"] = EEP_prior(self.ic, self._priors[self.ic.eep_replaces], bounds=eep_bounds)
        self._bounds = {
            k: p.bounds if k not in ["mass", "feh", "age"] else None for k, p in self._priors.items()
        }
        if "maxAV" in kwargs:
            self.set_bounds(AV=(0, kwargs["maxAV"]))
        if "max_distance" in kwargs:
            self.set_bounds(distance=(0, kwargs["max_distance"]))

        self._bands = None
        self._props = None
        self._directory = str(directory)
        self._samples = None
        self._derived_samples = None
        self._evidence = None
        self._nested_result = None
        self.kwargs = {}

    # ------------------------------------------------------------- properties
    @property
    def bands(self):
        if self._bands is None:
            try:
                self._bands = list({n.band for n in self.obs.get_obs_nodes() if n.band is not None})
            except AttributeError:
                self._bands = []
        return self._bands

    @property
    def props(self):
        if self._props is None:
            props = {k for v in self.obs.spectroscopy.values() for k in v}
            self._props = list(props - {"Teff", "logg", "feh"})
        return self._props

    @property
    def param_names(self):
        return tuple(self.obs.param_description)

    @property
    def param_description(self):
        return self.obs.param_description

    @property
    def n_params(self):
        return sum(4 + n for n in self.obs.Nstars.values())

    @property
    def labelstring(self):
        s = "--".join(
            ["-".join([n.label for n in l.children]) for l in self.obs.get_obs_leaves()]
        )
        if s == "0_0":
            return "single"
        if s == "0_0-0_1":
            return "binary"
        if s == "0_0-0_1-0_2":
            return "triple"
        return s

    @property
    def mags(self):
        return {n.band: n.value[0] for n in self.obs.get_obs_nodes() if not n.relative}

    # ------------------------------------------------------------ constructors
    @classmethod
    def _parse_band(cls, kw):
        """Photometric band from an ini keyword (reference starmodel.py:219-227)."""
        m = re.search(r"([a-zA-Z0-9]+)(_\w+)?", kw)
        if m:
            if m.group(1) in cls._not_a_band:
                return None
            return m.group(1)

    @classmethod
    def get_bands(cls, inifile):
        """All bands named in an ini file (reference starmodel.py:229-245)."""
        from .iniparse import IniSection, parse_ini

        bands = []
        c = parse_ini(inifile)
        for kw, v in c.items():
            if isinstance(v, IniSection):
                for kw2 in v:
                    b = cls._parse_band(kw2)
                    if b is not None:
                        bands.append(b)
            else:
                b = cls._parse_band(kw)
                if b is not None:
                    bands.append(b)
        return list(set(bands))

    @classmethod
    def from_ini(cls, ic, folder=".", ini_file="star.ini", device="cuda", dtype=None, **kwargs):
        """Build a model from a ``star.ini`` spec (reference
        starmodel.py:248-436; same section conventions: a section per
        instrument; ``resolution`` implies companions with relative
        photometry unless ``relative`` is set; companion tags ``K_1``,
        ``separation_1``, ...). ``ic`` is an interpolator, or a grid name
        that :func:`~isochrones_torch.isochrone.get_ichrone` builds with the
        ini's bands on ``device`` (the card unless the caller names another)
        in ``dtype``."""
        from .iniparse import parse_ini
        from .models import ModelGridInterpolator

        if not os.path.isabs(ini_file):
            ini_file = os.path.join(folder, ini_file)
        bands = cls.get_bands(ini_file)

        if not isinstance(ic, ModelGridInterpolator):
            from .isochrone import get_ichrone

            kw = {} if dtype is None else {"dtype": dtype}
            ic = get_ichrone(ic, bands, device=device, **kw)

        c = parse_ini(ini_file)
        obs = None
        rows = ini_photometry_rows(c, scalars_out=kwargs)
        if rows:
            obs = ObservationTree.from_df(rows)
        if "obsfile" in c:
            obs = c["obsfile"]

        name = kwargs.pop("name", os.path.basename(os.path.abspath(folder)))
        new = cls(ic, obs=obs, **kwargs, name=name)
        new._directory = os.path.abspath(folder)
        return new

    def _build_obs(self, **kwargs):
        """kwargs photometry -> single-source ObservationTree
        (reference starmodel.py:481-504)."""
        tree = ObservationTree()
        for k, v in kwargs.items():
            if k in self.ic.bc.column_index:
                if np.size(v) != 2:
                    getLogger().warning("%s=%s ignored (no uncertainty).", k, v)
                    v = [v, np.nan]
                o = Observation("", k, 99)
                o.add_source(Source(v[0], v[1]))
                o._set_reference()
                tree.add_observation(o)
        self.obs = tree

    def _add_properties(self, **kwargs):
        """Attach non-photometric observations (reference starmodel.py:506-524)."""
        for k, v in kwargs.items():
            if k in self.ic.bc.column_index:
                continue
            elif k == "parallax":
                self.obs.add_parallax(v)
            elif k == "AV":
                self.obs.add_AV(v)
            elif k in ("Teff", "logg", "feh", "density"):
                self.obs.add_spectroscopy(**{k: v})
            elif re.search(r"_", k):
                m = re.search(r"^(\w+)_(\w+)$", k)
                prop, tag = m.group(1), m.group(2)
                if prop in ("Teff", "logg", "feh", "density"):
                    self.obs.add_spectroscopy(label=f"0_{tag}", **{prop: v})

    def print_ascii(self):
        return self.obs.print_ascii()

    def convert_pars_to_eep(self, pars):
        """Mass-based parameter vectors -> EEP (reference starmodel.py:443-453)."""
        pardict = self.obs.p2pardict(pars)
        new = dict(pardict)
        for s, p in pardict.items():
            new[s] = list(p)
            new[s][0] = self.ic.get_eep(*p[0:3], accurate=True)
        return self.obs.pardict2p(new)

    # ---------------------------------------------------------------- bounds
    def bounds(self, prop):
        if prop.startswith("eep"):
            prop = "eep"
        if prop.startswith(("age_", "feh_", "distance_", "AV_")):
            prop = prop.split("_")[0]
        if self._bounds.get(prop) is not None:
            return self._bounds[prop]
        if prop in ("mass", "feh", "age"):
            lo, hi = self.ic.get_limits(prop)
            self._bounds[prop] = (lo, hi)
            self._priors[prop].bounds = (lo, hi)
            return self._bounds[prop]
        raise ValueError(f"Unknown property {prop}")

    # ---------------------------------------------------------- batched fns
    def _build_lnlike_batch(self):
        return make_tree_lnlike(self.obs.plan(self.ic))

    def _shared_lnprior(self, p):
        """``(lnp, blocks)``: the bounds masks and priors of every system's
        shared parameters and the descending-EEP constraint (reference
        starmodel.py:557-613 without its EEP terms), and per system
        ``(first column, number of stars, age, feh)`` for those terms."""
        priors = self._priors
        neg_inf = float("-inf")
        lnp = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
        blocks = []
        i = 0
        for s in self.obs.systems:
            n = self.obs.Nstars[s]
            shared = {
                "age": p[..., i + n],
                "feh": p[..., i + n + 1],
                "distance": p[..., i + n + 2],
                "AV": p[..., i + n + 3],
            }
            for prop, val in shared.items():
                lo, hi = self.bounds(prop)
                lnp = torch.where((val < lo) | (val > hi), neg_inf, lnp)
                lnp = lnp + priors[prop].lnpdf(val)
            if n > 1:
                eeps = p[..., i : i + n]
                descending = (eeps[..., 1:] <= eeps[..., :-1]).all(dim=-1)
                lnp = torch.where(descending, lnp, neg_inf)
            blocks.append((i, n, shared["age"], shared["feh"]))
            i += n + 4
        return lnp, blocks

    def _build_lnprior_batch(self):
        """Per-system priors + descending-EEP constraint
        (reference starmodel.py:557-613)."""
        if self.ic.eep_replaces != "mass":
            raise NotImplementedError("Prior not implemented for evolution track grids")
        eep_prior = self._priors["eep"]

        def lnprior_batch(p):
            lnp, blocks = self._shared_lnprior(p)
            for i, n, age, feh in blocks:
                for j in range(n):
                    lnp = lnp + eep_prior.lnpdf(p[..., i + j], age=age, feh=feh)
            return lnp

        return lnprior_batch

    def _build_lnpost_fused(self):
        """Fused lnprior + lnlike sharing one interpolation per star over the
        6-column packed table, as the flat model's
        (:meth:`BasicStarModel._build_lnpost_fused`): the tree likelihood's
        call returns the EEP prior's quantity and derivative per star. None
        (the composed path) for customized priors or subclasses."""
        ic = self.ic
        if type(self)._build_lnlike_batch is not StarModel._build_lnlike_batch:
            return None
        if type(self)._build_lnprior_batch is not StarModel._build_lnprior_batch:
            return None
        if ic.eep_replaces != "mass" or getattr(ic, "model_packed6", None) is None:
            return None
        eep_prior = self._priors.get("eep")
        if type(eep_prior) is not EEP_prior or eep_prior.ic is not ic:
            return None

        fused = make_tree_lnlike_fused(self.obs.plan(ic))
        eep_cols = fused.likelihood.star_param_idx[:, 0].long()  # each star's EEP column, in the stars' order
        eep_lo, eep_hi = eep_prior.bounds
        orig_prior = eep_prior.orig_prior
        neg_inf = float("-inf")

        def lnpost(p):
            ll, orig_val, deriv = fused(p)
            lnp, _ = self._shared_lnprior(p)
            # the EEP change of variables of every star at once (priors.py, EEP_prior.lnpdf)
            eeps = p[..., eep_cols]
            term = eep_change_of_variables(orig_prior, orig_val, deriv)
            term = torch.where((eeps < eep_lo) | (eeps > eep_hi), neg_inf, term)
            lnp = lnp + term.sum(dim=-1)
            return self._posterior(lnp, ll)

        lnpost.likelihood = fused.likelihood
        return lnpost

    def prior_transform_batch(self, u):
        """Unit cube -> params, per-system blocks with EEPs sorted descending
        (reference mnest_prior, starmodel.py:677-693). The box transform is
        the inherited one; only the EEP ordering is layered on top."""
        out = super().prior_transform_batch(u)
        i = 0
        for s in self.obs.systems:
            n = self.obs.Nstars[s]
            if n > 1:
                eeps = torch.sort(out[..., i : i + n], dim=-1, descending=True).values
                out = torch.cat([out[..., :i], eeps, out[..., i + n :]], dim=-1)
            i += n + 4
        return out

    # -------------------------------------------------------------- sampling
    def sample_from_prior(self, n, values=False, require_valid=True, rng=None):
        """Per-system prior draws (reference emcee_p0, starmodel.py:838-884):
        a dict of numpy columns, or the (n, n_params) array with
        ``values=True``."""
        if n == 0:
            arr = np.zeros((0, self.n_params))
            return arr if values else {p: arr[:, i] for i, p in enumerate(self.param_names)}
        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
        cols = {}
        for s in self.obs.systems:
            nstars = self.obs.Nstars[s]
            age = self._priors["age"].sample(n, rng=rng)
            feh = self._priors["feh"].sample(n, rng=rng)
            d = self._priors["distance"].sample(n, rng=rng)
            AV = self._priors["AV"].sample(n, rng=rng)
            eeps = np.stack(
                [self._priors["eep"].sample(n, rng=rng, age=age, feh=feh) for _ in range(nstars)],
                axis=-1,
            )
            eeps = -np.sort(-eeps, axis=-1)
            for j in range(nstars):
                cols[f"eep_{s}_{j}"] = eeps[:, j]
            cols[f"age_{s}"] = age
            cols[f"feh_{s}"] = feh
            cols[f"distance_{s}"] = d
            cols[f"AV_{s}"] = AV
        arr = np.stack([np.asarray(cols[p], dtype=float) for p in self.param_names], axis=-1)

        if require_valid:
            bad = ~np.isfinite(self.lnpost_batch(arr).cpu().numpy())
            if bad.any():
                arr[bad] = self.sample_from_prior(int(bad.sum()), values=True, require_valid=True, rng=rng)
        if values:
            return arr
        return {p: arr[:, i] for i, p in enumerate(self.param_names)}

    # -------------------------------------------------------- derived samples
    def _make_samples(self):
        """Per-system derived posterior quantities (reference
        starmodel.py:984-1032)."""
        s_ = self.samples
        chain = np.stack([s_[c] for c in self.param_names], axis=1)
        out = {}
        i = 0
        for s in self.obs.systems:
            n = self.obs.Nstars[s]
            age = chain[:, i + n]
            feh = chain[:, i + n + 1]
            dist = chain[:, i + n + 2]
            AV = chain[:, i + n + 3]
            for j in range(n):
                d = self.ic(chain[:, i + j], age, feh, distance=dist, AV=AV)
                for c, v in d.items():
                    out[f"{c}_{s}_{j}"] = v
            out[f"age_{s}"] = age
            out[f"feh_{s}"] = feh
            out[f"distance_{s}"] = dist
            out[f"AV_{s}"] = AV
            i += 4 + n

        for b in self.ic.bands:
            tot = np.inf
            for s in self.obs.systems:
                for j in range(self.obs.Nstars[s]):
                    tot = addmags(tot, out[f"{b}_mag_{s}_{j}"])
            out[f"{b}_mag"] = tot

        out["lnprob"] = s_["lnprob"]
        self._derived_samples = out

    # ------------------------------------------------------------- persistence
    def save_hdf(self, filename, path="", overwrite=False, append=False):
        """Model + tree persistence (reference starmodel.py:1205-1262, which
        writes HDF5) into the ``.npz`` container ``filename`` under the key
        prefix ``path``: the tree (``obs/...``), samples and derived samples,
        and ``ic_type``, ``ic_bands``, ``use_emcee``, ``name``,
        ``directory`` as attributes, as the reference does, plus ``bounds``
        and ``evidence``, which the reference's tree file drops (a reloaded
        tree model there forgets a non-default ``maxAV`` and its evidence)."""
        if os.path.exists(filename) and overwrite:
            os.remove(filename)
        self.obs.save_hdf(filename, path, append=True)
        prefix = store_prefix(path)
        mine = tuple(f"{prefix}{g}/" for g in ("samples", "derived_samples", "attrs"))
        entries = {k: v for k, v in npz_load(filename).items() if not k.startswith(mine)}
        attrs = dict(ic_type=type(self.ic).__name__, ic_bands=list(self.ic.bands), use_emcee=bool(self.use_emcee),
                     name=self.name, directory=self._directory or ".",
                     bounds={k: list(v) if v is not None else None for k, v in self._bounds.items()})
        if self._evidence is not None:
            attrs["evidence"] = list(self._evidence)
        entries.update(self._store_entries(prefix, attrs))
        npz_save(filename, entries)

    @classmethod
    def load_hdf(cls, filename, path="", name=None, ic=None, device="cuda", dtype=None):
        """reference starmodel.py:1264-1317, from the ``.npz`` container.
        Without ``ic`` the synthetic grids are rebuilt with the stored bands
        on ``device`` (the card unless the caller names another)."""
        if not os.path.exists(filename):
            raise IOError(f"{filename} does not exist.")
        prefix = store_prefix(path)
        entries = npz_load(filename)
        attrs = {k[len(prefix) + 6:]: json.loads(str(v)) for k, v in entries.items()
                 if k.startswith(f"{prefix}attrs/")}
        samples, derived = cls._stored_tables(entries, prefix)
        if ic is None:
            ic = _stored_ichrone(attrs, device, dtype)
        obs = ObservationTree.load_hdf(filename, path, ic=ic)
        mod = cls(ic, obs=obs, use_emcee=bool(attrs["use_emcee"]),
                  name=name if name is not None else attrs["name"], directory=attrs["directory"])
        mod._samples = samples
        mod._derived_samples = derived
        bounds = attrs.get("bounds", {})
        mod.set_bounds(**{k: tuple(v) for k, v in bounds.items() if v is not None})
        if attrs.get("evidence") is not None:
            mod._evidence = tuple(attrs["evidence"])
        return mod


class StarModelGroup:
    """Model-selection helper: variants of a base StarModel over multiplicity
    and association configurations (reference starmodel.py:1320-1358)."""

    def __init__(self, base_model, max_multiples=1, max_stars=2):
        self.base_model = deepcopy(base_model)
        self.base_model.obs.clear_models()
        self.max_multiples = max_multiples
        self.max_stars = max_stars
        self.models = []
        for N, index in self.model_options:
            mod = deepcopy(self.base_model)
            mod.obs.define_models(self.ic, N=N, index=index)
            self.models.append(mod)

    @property
    def ic(self):
        return self.base_model.ic

    @property
    def N_stars(self):
        return len(self.base_model.obs.leaves)

    @property
    def N_options(self):
        return N_options(self.N_stars, max_multiples=self.max_multiples, max_stars=self.max_stars)

    @property
    def index_options(self):
        return index_options(self.N_stars)

    @property
    def model_options(self):
        return [(N, index) for N in self.N_options for index in self.index_options]
