"""User-facing interpolators (counterpart of
``isochrones_tpu/models/interpolator.py``): one stellar model grid joined
with one bolometric-correction grid, on one device in one dtype.

The isochrone and the evolution-track interpolator with the packed tables
(``model_packed``, and ``model_packed6`` for the fused star likelihood), the
parameter layout, grid limits, ``interp_value``/``interp_mag`` (batched on
tensors, and host wrappers on numpy), the per-property accessors and the
``mag[band]`` accessor, ``__call__``, EEP inversion (``get_eep``, fast on
track grids and accurate on both, ``max_eep``) and the forward model
(``generate``, ``generate_device``, ``generate_binary``, ``isochrone``,
``model_value``, ``model_mag``). On the card the EEP inversions (fast and
accurate) and the forward model run in one hand-written kernel
(:mod:`isochrones_torch.ops.generate_cuda`), one launch a call; a table comes
back as a :class:`~isochrones_torch.summary.Frame`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.generate import ForwardModel, NewtonGrid, eep_newton, generate_forward, get_eep_accurate, get_eep_fast
from ..ops.interp import GridData, interp_nd
from ..ops.mags import interp_mag as _interp_mag_kernel
from ..summary import Frame
from ..utils import addmags

__all__ = ["ModelGridInterpolator", "EvolutionTrackInterpolator", "IsochroneInterpolator"]

#: rows of one host-facing EEP inversion or forward-model call; a longer
#: request is cut into pieces of this many rows, which bounds the device
#: memory of one call
HOST_CHUNK = 1 << 20


def _host_rows(arrays, shape=None):
    """Host arrays broadcast together (to ``shape`` when given), each as a
    flat float64 column."""
    arrs = [np.asarray(x, dtype=float) for x in arrays]
    shape = np.broadcast_shapes(*(a.shape for a in arrs)) if shape is None else shape
    return [np.array(np.broadcast_to(a, shape).reshape(-1)) for a in arrs], shape


class ModelGridInterpolator:
    """Base interpolator. Parameters come in *user order*
    (``param_names``); ``_param_index_order`` maps them to grid-axis order."""

    param_names: Tuple[str, ...] = ("p0", "p1", "p2", "distance", "AV")
    eep_replaces: Optional[str] = None
    _param_index_order: Tuple[int, ...] = (1, 2, 0, 3, 4)
    name = "model"
    #: the grid classes behind the tables (reference models.py:255-257), set
    #: by the MIST factory; None for tables built otherwise
    grid_type = None
    bc_type = None

    def __init__(self, model: GridData, bc: GridData, bands: Optional[Sequence[str]] = None, eep_support=None):
        if model.values.device != bc.values.device or model.values.dtype != bc.values.dtype:
            raise ValueError("model and BC grids must share one device and dtype")
        self.model = model
        self.bc = bc
        self.bands = list(bands) if bands is not None else list(bc.columns)
        # (feh_knots, mass_knots, age_arrays (+inf padded), lengths) tensors
        # on the model's device, for the fast EEP inversion
        self.eep_support = eep_support

        ci = model.column_index
        self._model_icols = (ci["Teff"], ci["logg"], ci["feh"], ci["Mbol"])
        self._band_icols = tuple(bc.column_index[b] for b in self.bands)
        self._limits_cache = {}

        # the 4 hot columns packed contiguously: each corner gather of
        # interp_mag reads one short row (subset on the device)
        cols = torch.as_tensor(self._model_icols, device=model.values.device)
        self.model_packed = GridData(
            values=model.values.index_select(-1, cols).contiguous(), knots=model.knots,
            columns=("Teff", "logg", "feh", "Mbol"),
            host_values=None if model.host_values is None
            else np.ascontiguousarray(model.host_values[..., list(self._model_icols)]),
            axis_maps=model.axis_maps,
        )
        self._packed_icols = (0, 1, 2, 3)

        # the 6-column pack of the fused star likelihood (reference
        # models/interpolator.py:252-283): the hot columns plus the EEP prior's
        # change-of-variables columns, so one corner gather serves both;
        # unpaired, subset on the device
        self.model_packed6 = None
        if self.eep_replaces == "age" and "age" in ci and "dt_deep" in ci:
            prior_names = ("age", "dt_deep")
        elif self.eep_replaces == "mass" and "initial_mass" in ci and "dm_deep" in ci:
            prior_names = ("initial_mass", "dm_deep")
        else:
            prior_names = None
        if prior_names is not None:
            cols6 = torch.as_tensor(self._model_icols + tuple(ci[c] for c in prior_names), device=model.values.device)
            self.model_packed6 = GridData(
                values=model.values.index_select(-1, cols6).contiguous(), knots=model.knots,
                columns=("Teff", "logg", "feh", "Mbol") + prior_names, axis_maps=model.axis_maps,
            )

    @property
    def device(self) -> torch.device:
        return self.model.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.values.dtype

    # ------------------------------------------------------------------ limits
    def _axis_names(self):
        raise NotImplementedError

    def get_limits(self, prop):
        """Axis or column value range (reference grid.py:58, models.py:276-305)."""
        if prop in self._limits_cache:
            return self._limits_cache[prop]
        axis_names = self._axis_names()
        if prop in axis_names:
            k = self.model.knots[axis_names.index(prop)].cpu().numpy()
            lim = (float(k[0]), float(k[-1]))
        else:
            host = self.model.host_values
            if host is None:
                host = self.model.values.cpu().numpy()
            col = host[..., self.model.column_index[prop]]
            lim = (float(np.nanmin(col)), float(np.nanmax(col)))
        self._limits_cache[prop] = lim
        return lim

    @property
    def eep_bounds(self):
        return self.get_limits("eep")

    @property
    def minfeh(self):
        return self.get_limits("feh")[0]

    @property
    def maxfeh(self):
        return self.get_limits("feh")[1]

    @property
    def mineep(self):
        return self.get_limits("eep")[0]

    @property
    def maxeep(self):
        return self.get_limits("eep")[1]

    @property
    def minage(self):
        return self.get_limits("age")[0]

    @property
    def maxage(self):
        return self.get_limits("age")[1]

    @property
    def minmass(self):
        return self.get_limits("mass")[0]

    @property
    def maxmass(self):
        return self.get_limits("mass")[1]

    @property
    def fehs(self):
        return self.model.knots[self._axis_names().index("feh")].cpu().numpy()

    @property
    def ages(self):
        """Age knots (isochrone grids only; reference models.py:313-319)."""
        if self.eep_replaces != "mass":
            raise AttributeError("Age is not a dimension of model grid type {}!".format(self.name))
        return self.model.knots[self._axis_names().index("age")].cpu().numpy()

    @property
    def masses(self):
        """Mass knots (track grids only; reference models.py:321-327)."""
        if self.eep_replaces != "age":
            raise AttributeError("Mass is not a dimension of this model grid!")
        return self.model.knots[self._axis_names().index("mass")].cpu().numpy()

    @property
    def model_grid(self):
        """The stellar-model grid, the device's :class:`GridData` (reference
        models.py:337-341)."""
        return self.model

    @property
    def bc_grid(self):
        """The bolometric-correction grid (reference models.py:343-347)."""
        return self.bc

    @property
    def prop_map(self):
        """Canonical property name -> grid column name for the standard
        properties of this grid, axes included (reference models.py:43-54);
        the columns carry the canonical names, so it is the identity."""
        have = set(self._axis_names()) | set(self.model.columns)
        std = ("eep", "age", "feh", "mass", "initial_mass", "logTeff", "logg", "logL")
        return {p: p for p in std if p in have}

    @property
    def column_map(self):
        """Inverse of :attr:`prop_map` (reference models.py:56-58)."""
        return {v: k for k, v in self.prop_map.items()}

    # ------------------------------------------------------------ properties
    def _as_points(self, pars, n):
        """Broadcast the first ``n`` host parameters into a (rows, n) tensor."""
        arrs = np.broadcast_arrays(*[np.asarray(p, dtype=float) for p in pars[:n]])
        pts = torch.as_tensor(np.stack([a.reshape(-1) for a in arrs], axis=-1), device=self.device, dtype=self.dtype)
        return pts, arrs[0].shape

    def interp_value_batch(self, points: torch.Tensor, props=None) -> torch.Tensor:
        """(..., >=3) user-order tensor -> (..., n_props) model columns."""
        io = self._param_index_order
        grid_pts = torch.stack([points[..., io[0]], points[..., io[1]], points[..., io[2]]], dim=-1)
        return interp_nd(self.model.values, self.model.knots, grid_pts, icols=self.model.icols(props),
                         axis_maps=self.model.axis_maps)

    def interp_value(self, pars, props=None):
        """Host wrapper (reference models.py:390-400): numpy in, numpy out,
        ``(n_props,)`` for scalar parameters."""
        pts, shape = self._as_points(pars, 3)
        out = self.interp_value_batch(pts, props).cpu().numpy()
        if not shape:
            return out[0]
        return out.reshape(shape + (out.shape[-1],))

    def _prop(self, prop, *pars):
        out = self.interp_value(list(pars), [prop])
        return out.squeeze(-1) if out.ndim else float(np.asarray(out).squeeze())

    def mass(self, *pars):
        return self._prop("mass", *pars)

    def initial_mass(self, *pars):
        return self._prop("initial_mass", *pars)

    def radius(self, *pars):
        return self._prop("radius", *pars)

    def Teff(self, *pars):
        return self._prop("Teff", *pars)

    def logg(self, *pars):
        return self._prop("logg", *pars)

    def feh(self, *pars):
        return self._prop("feh", *pars)

    def density(self, *pars):
        return self._prop("density", *pars)

    def nu_max(self, *pars):
        return self._prop("nu_max", *pars)

    def delta_nu(self, *pars):
        return self._prop("delta_nu", *pars)

    def __call__(self, p1, p2, p3, distance=10.0, AV=0.0):
        """Every model column and band magnitude at the given parameters
        (reference models.py:471-482), as a dict of numpy columns."""
        pts, _ = self._as_points([p1, p2, p3, distance, AV], 5)
        cols = list(self.model.columns)
        props = self.interp_value_batch(pts, cols).cpu().numpy()
        mags = self.interp_mag_batch(pts)[3].cpu().numpy()
        out = {c: props[:, i] for i, c in enumerate(cols)}
        out.update({f"{b}_mag": mags[:, i] for i, b in enumerate(self.bands)})
        return out

    # ------------------------------------------------------------ magnitudes
    def interp_mag_batch(self, points: torch.Tensor, bands=None):
        """(..., 5) user-order tensor -> (Teff, logg, feh, mags)."""
        band_icols = self._band_icols if bands is None else tuple(self.bc.column_index[b] for b in bands)
        return _interp_mag_kernel(points, self._param_index_order, self.model_packed,
                                  self._packed_icols, self.bc, band_icols)

    def interp_mag(self, pars, bands=None):
        """Host wrapper (reference models.py:402-445): broadcast numpy
        parameters, return numpy ``(Teff, logg, feh, mags)``."""
        pts, shape = self._as_points(pars, 5)
        Teff, logg, feh, mags = (x.cpu().numpy() for x in self.interp_mag_batch(pts, bands))
        if not shape:
            return float(Teff[0]), float(logg[0]), float(feh[0]), mags[0]
        return Teff.reshape(shape), logg.reshape(shape), feh.reshape(shape), mags.reshape(shape + (-1,))

    @property
    def mag(self):
        """``ic.mag[band](*pars)``: one band's magnitude at host parameters, a
        float for scalars (reference observation.py:578, cluster.py:148-152)."""
        ic = self

        class _MagAccessor:
            def __getitem__(self, band):
                def mag_fn(*pars):
                    out = np.asarray(ic.interp_mag(list(pars), [band])[3])[..., 0]
                    return float(out) if out.ndim == 0 or out.size == 1 else out

                return mag_fn

            def keys(self):
                return list(ic.bands)

        return _MagAccessor()

    def initialize(self, pars=None):
        """One magnitude evaluation as a sanity check: finite Teff, logg,
        feh and magnitudes (reference models.py:349-358)."""
        if pars is None:
            pars = [1.04, 150.0, -0.35, 1000.0, 0.2] if self.eep_replaces == "age" else [150.0, 9.7, -0.35, 1000.0, 0.2]
        Teff, logg, feh, mags = self.interp_mag(pars, self.bands)
        assert np.isfinite([Teff, logg, feh]).all(), (Teff, logg, feh)
        assert np.isfinite(mags).all(), mags

    # ------------------------------------------------------------------ EEP
    def max_eep(self, mass, feh):
        """Length of the track at the knots at or below (mass, feh); the
        grid's top EEP without EEP support arrays."""
        if self.eep_support is None:
            return self.maxeep
        feh_knots, mass_knots, _, lengths = (x.cpu().numpy() for x in self.eep_support)
        # side="right" - 1 is the knot itself on an exact match and the lower
        # knot inside a cell
        i_f = int(np.clip(np.searchsorted(feh_knots, feh, side="right") - 1, 0, len(feh_knots) - 1))
        i_m = int(np.clip(np.searchsorted(mass_knots, mass, side="right") - 1, 0, len(mass_knots) - 1))
        return float(lengths[i_f * len(mass_knots) + i_m])

    def get_eep_batch(self, mass, age, feh, accurate=False, resid_tol=0.02):
        """Batched EEP inversion on tensors of the model's device (reference
        models.py:501-542): the fast integer-resolution search on track grids,
        refined by Newton steps with ``accurate``; on isochrone grids only the
        accurate one, seeded at EEP 300. NaN where the refined residual
        exceeds ``resid_tol``. One kernel launch on the card."""
        mass, age, feh = torch.broadcast_tensors(
            *(torch.as_tensor(x, dtype=self.dtype, device=self.device) for x in (mass, age, feh)))
        if self.eep_replaces == "age":
            if self.eep_support is None:
                raise ValueError("No EEP support arrays on this grid")
            if not accurate:
                return get_eep_fast(self._forward_model, mass, age, feh)
            return get_eep_accurate(self._forward_model, mass, age, feh, resid_tol)
        if self.eep_replaces == "mass":
            if not accurate:
                raise NotImplementedError(
                    "Fast EEP inversion not implemented for isochrone grids (as in reference)")
            return eep_newton(self._newton_grid, self._eep_seed.expand_as(mass), mass, age, feh, resid_tol)
        raise NotImplementedError(
            f"EEP inversion needs eep_replaces in ('age', 'mass'); this "
            f"interpolator has eep_replaces={self.eep_replaces!r}")

    def get_eep(self, mass, age, feh, accurate=False, resid_tol=0.02, **kwargs):
        """Host wrapper of :meth:`get_eep_batch`: broadcast numpy in, numpy
        out (a float for scalars), in pieces of ``HOST_CHUNK`` rows."""
        arrs = np.broadcast_arrays(*[np.asarray(x, dtype=float) for x in (mass, age, feh)])
        shape = arrs[0].shape
        cols = [torch.as_tensor(np.ascontiguousarray(a.reshape(-1)), dtype=self.dtype, device=self.device)
                for a in arrs]
        n = cols[0].shape[0]
        out = torch.cat([
            self.get_eep_batch(*(c[i : i + HOST_CHUNK] for c in cols), accurate=accurate, resid_tol=resid_tol)
            for i in range(0, max(n, 1), HOST_CHUNK)
        ]).cpu().numpy()
        if not shape:
            return float(out[0])
        return out.reshape(shape)

    def get_eep_accurate(self, mass, age, feh, **kwargs):
        return self.get_eep(mass, age, feh, accurate=True, **kwargs)

    def mass_age_resid(self, *args, **kwargs):
        raise NotImplementedError

    # ------------------------------------------------------------- generation
    @property
    def _forward_model(self) -> ForwardModel:
        """The tables of the forward model and the fast EEP inversion, built
        once."""
        fm = getattr(self, "_fm", None)
        if fm is None:
            fm = self._fm = ForwardModel(
                model=self.model, model_packed=self.model_packed, bc=self.bc, eep_support=self.eep_support,
                index_order=self._param_index_order, model_icols=self._model_icols,
                eep0=float(self.model.knots[-1][0]), i_age=self.model.column_index.get("age", -1))
        return fm

    @property
    def _newton_grid(self) -> NewtonGrid:
        """An isochrone grid's accurate inversion: the Newton step on its
        initial-mass column, built once."""
        ng = getattr(self, "_ng", None)
        if ng is None:
            ng = self._ng = NewtonGrid(self.model, self.model.column_index["initial_mass"])
        return ng

    @property
    def _eep_seed(self) -> torch.Tensor:
        """The isochrone grid's Newton seed, EEP 300 as in the reference, a
        scalar tensor made once, so that a call launches no kernel to fill
        it."""
        seed = getattr(self, "_seed300", None)
        if seed is None:
            seed = self._seed300 = torch.full((), 300.0, dtype=self.dtype, device=self.device)
        return seed

    def _forward(self, mass, age, feh, distance, AV, prop_names, bands, eeps=None, all_As=False, accurate=False):
        """The forward model on device tensors: ``(eeps, values, mags, mags
        at AV = 0 or None)``; the inversion needs the EEP support arrays."""
        if eeps is None and self.eep_support is None:
            raise ValueError("No EEP support arrays on this grid")
        return generate_forward(self._forward_model, mass, age, feh, distance, AV, self.model.icols(prop_names),
                                tuple(self.bc.column_index[b] for b in bands), eeps=eeps, all_As=all_As,
                                accurate=accurate)

    def _forward_host(self, cols, prop_names, bands, eeps=None, all_As=False, accurate=False):
        """:meth:`_forward` of flat float64 host columns (mass, age, feh,
        distance, AV), one call per ``HOST_CHUNK`` rows: numpy ``(values,
        mags, mags at AV = 0 or None)``."""
        cols = list(cols) + ([] if eeps is None else [eeps])
        pieces = []
        for i in range(0, max(cols[0].shape[0], 1), HOST_CHUNK):
            t = [torch.as_tensor(c[i: i + HOST_CHUNK], dtype=self.dtype, device=self.device) for c in cols]
            out = self._forward(*t[:5], prop_names, bands, eeps=t[5] if eeps is not None else None,
                                all_As=all_As, accurate=accurate)
            pieces.append([None if x is None else x.cpu().numpy() for x in out[1:]])
        return tuple(None if p[0] is None else np.concatenate(p) for p in zip(*pieces))

    def generate(self, mass, age, feh, props="all", bands=None, eeps=None, return_df=True, return_dict=False,
                 distance=10.0, AV=0.0, all_As=False, accurate=False, **kwargs):
        """Forward model (reference models.py:580-631): host (mass, age, feh)
        broadcast with ``distance`` and ``AV`` -> a :class:`Frame` of the
        model columns ``props``, the ``{band}_mag`` magnitudes, ``distance``,
        ``AV``, ``initial_feh``, ``requested_age`` and with ``all_As`` the
        extinctions ``A_{band}``; a dict of columns with ``return_dict``.
        ``eeps`` given skip the inversion; ``accurate`` refines it by Newton
        steps. One device call (a kernel launch on the card) per
        ``HOST_CHUNK`` rows; an isochrone grid delegates to its track."""
        if self.eep_replaces == "mass":
            return self.track.generate(mass, age, feh, props=props, bands=bands, eeps=eeps, return_df=return_df,
                                       return_dict=return_dict, distance=distance, AV=AV, all_As=all_As,
                                       accurate=accurate, **kwargs)
        bands = self.bands if bands is None else list(bands)
        (mass_, age_, feh_, dist_, av_), shape = _host_rows([mass, age, feh, distance, AV])
        eeps_ = None if eeps is None else _host_rows([eeps], shape)[0][0]
        prop_names = list(self.model.columns) if props == "all" else list(props)
        values, mags, mags0 = self._forward_host([mass_, age_, feh_, dist_, av_], prop_names, bands, eeps=eeps_,
                                                 all_As=all_As, accurate=accurate)

        df = Frame({c: values[:, i] for i, c in enumerate(prop_names)})
        df.update({f"{b}_mag": mags[:, i] for i, b in enumerate(bands)})
        df.update(distance=dist_, AV=av_, initial_feh=feh_, requested_age=age_)
        if all_As:
            for i, b in enumerate(bands):
                df[f"A_{b}"] = df[f"{b}_mag"] - mags0[:, i]
        return dict(df) if return_dict else df

    def generate_device(self, mass, age, feh, props="all", bands=None, distance=10.0, AV=0.0, accurate=False):
        """The forward model on the interpolator's device: tensors ``(eeps
        (N,), values (N, P), mags (N, n_bands))`` with no read-back to the
        host and no synchronize (reference models.py:580-631; the JAX
        package's ``generate_device``). Inputs (tensors or host values) are
        broadcast to one flat batch; one kernel launch on the card."""
        if self.eep_replaces == "mass":
            return self.track.generate_device(mass, age, feh, props=props, bands=bands, distance=distance, AV=AV,
                                              accurate=accurate)
        if self.eep_support is None:
            raise NotImplementedError("generate_device needs the track grid's EEP support arrays")
        bands = self.bands if bands is None else list(bands)
        arrs = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=self.dtype, device=self.device)
                                         for x in (mass, age, feh, distance, AV)))
        flat = [a.reshape(-1) for a in arrs]
        prop_names = list(self.model.columns) if props == "all" else list(props)
        return self._forward(*flat, prop_names, bands, accurate=accurate)[:3]

    def generate_binary(self, mass_A, mass_B, age, feh, **kwargs):
        """Primary and secondary in one stacked 2N-row :meth:`generate` call
        (reference models.py:633-661): the columns ``{c}_0`` and ``{c}_1``,
        then the total ``{band}_mag`` (a NaN secondary adds no flux) and with
        ``all_As`` the total extinction ``A_{band}``."""
        bands = kwargs.get("bands", None) or self.bands
        mass_A, mass_B = np.broadcast_arrays(np.asarray(mass_A, dtype=float), np.asarray(mass_B, dtype=float))
        n = mass_A.size
        shape = mass_A.shape
        age_b, feh_b = (np.broadcast_to(np.asarray(x, dtype=float), shape) for x in (age, feh))
        dist_b = np.broadcast_to(np.asarray(kwargs.pop("distance", 10.0), dtype=float), shape)
        av_b = np.broadcast_to(np.asarray(kwargs.pop("AV", 0.0), dtype=float), shape)
        both = self.generate(np.concatenate([mass_A.ravel(), mass_B.ravel()]), np.tile(age_b.ravel(), 2),
                             np.tile(feh_b.ravel(), 2), distance=np.tile(dist_b.ravel(), 2),
                             AV=np.tile(av_b.ravel(), 2), **kwargs)
        values_A, values_B = both.iloc[:n], both.iloc[n:]
        values = Frame({**values_A.rename({c: f"{c}_0" for c in values_A}),
                        **values_B.rename({c: f"{c}_1" for c in values_B})})
        for b in bands:
            m0 = values_A[f"{b}_mag"]
            m1 = np.nan_to_num(values_B[f"{b}_mag"], nan=np.inf)
            values[f"{b}_mag"] = addmags(m0, m1)
            if kwargs.get("all_As", False):
                A0 = values[f"A_{b}_0"]
                A1 = np.nan_to_num(values[f"A_{b}_1"], nan=0.0)
                values[f"A_{b}"] = values[f"{b}_mag"] - addmags(m0 - A0, m1 - A1)
        return values

    def isochrone(self, age, feh=0.0, eep_range=None, distance=10.0, AV=0.0, dropna=True):
        """Every column and magnitude at the integer EEPs of ``eep_range``
        (the grid's EEP limits by default) for one age and [Fe/H], a
        :class:`Frame`; rows with a NaN dropped unless ``dropna`` is False
        (reference models.py:484-493)."""
        if eep_range is None:
            eep_range = self.get_limits("eep")
        df = Frame(self(np.arange(*eep_range), age, feh, distance=distance, AV=AV))
        return df.dropna() if dropna else df

    def _model_host(self, pars, prop_names, bands, accurate):
        """The forward model of broadcast host parameters (mass, age, feh,
        distance, AV) as ``get_eep`` then ``interp_value`` / ``interp_mag``
        shape it: ``(values, mags)``, each ``shape + (n,)``, or ``(n,)`` for
        scalars."""
        cols, shape = _host_rows(pars)
        values, mags, _ = self._forward_host(cols, prop_names, bands, accurate=accurate)
        if not shape:
            return values[0], mags[0]
        return values.reshape(shape + (-1,)), mags.reshape(shape + (-1,))

    def model_value(self, mass, age, feh, props, approx=False):
        """Model columns at (mass, age, feh) through the EEP inversion
        (reference models.py:447-455): one forward-model call (a kernel
        launch on the card); an isochrone grid delegates to its track, as
        :meth:`model_mag` does."""
        if self.eep_replaces == "mass":
            return self.track.model_value(mass, age, feh, props, approx=approx)
        if isinstance(props, str):
            props = [props]
        values = self._model_host([mass, age, feh, 10.0, 0.0], list(props), [], accurate=not approx)[0]
        return float(np.squeeze(values)) if np.size(values) == 1 else values

    def model_mag(self, mass, age, feh, distance=10.0, AV=0.0, bands=None, approx=False):
        """Magnitudes at (mass, age, feh) through the EEP inversion (reference
        models.py:458-469): one forward-model call (a kernel launch on the
        card)."""
        if self.eep_replaces == "mass":
            return self.track.model_mag(mass, age, feh, distance=distance, AV=AV, bands=bands, approx=approx)
        bands = bands or self.bands
        mags = self._model_host([mass, age, feh, distance, AV], [], list(bands), accurate=not approx)[1]
        return float(np.squeeze(mags)) if np.size(mags) == 1 else mags


class EvolutionTrackInterpolator(ModelGridInterpolator):
    """Params (mass, eep, feh, distance, AV); grid axes (feh, mass, eep)
    (reference models.py:664-688)."""

    param_names = ("mass", "eep", "feh", "distance", "AV")
    eep_replaces = "age"
    _param_index_order = (2, 0, 1, 3, 4)
    name = "track"

    def __init__(self, *args, iso=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._iso = iso

    def _axis_names(self):
        return ["feh", "mass", "eep"]

    @property
    def iso(self):
        return self._iso

    def mass_age_resid(self, eep, mass, age, feh):
        age_interp = self.interp_value([mass, eep, feh], ["age"])
        return float(np.squeeze((age - age_interp) ** 2))


class IsochroneInterpolator(ModelGridInterpolator):
    """Params (eep, age, feh, distance, AV); grid axes (age, feh, eep)
    (reference models.py:691-718)."""

    param_names = ("eep", "age", "feh", "distance", "AV")
    eep_replaces = "mass"
    _param_index_order = (1, 2, 0, 3, 4)
    name = "iso"

    def __init__(self, *args, track=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._track = track

    def _axis_names(self):
        return ["age", "feh", "eep"]

    @property
    def track(self):
        if self._track is None:
            raise ValueError(
                "This IsochroneInterpolator has no linked track interpolator "
                "(construct it with track=..., or use get_ichrone, which "
                "wires both); mass-parameterized entry points (generate, "
                "model_value, model_mag) delegate to it."
            )
        return self._track

    def mass_age_resid(self, eep, mass, age, feh):
        mass_interp = self.interp_value([eep, age, feh], ["initial_mass"])
        return float(np.squeeze((mass - mass_interp) ** 2))
