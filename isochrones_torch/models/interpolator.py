"""User-facing interpolators (counterpart of
``isochrones_tpu/models/interpolator.py``): one stellar model grid joined
with one bolometric-correction grid, on one device in one dtype.

Ported subset: the isochrone interpolator and what the cluster model reads
from it (``model``, ``bc``, ``model_packed``, the parameter layout, grid
limits) plus ``interp_mag``. The evolution-track interpolator, EEP
inversion and forward generation wait for a later port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.interp import GridData
from ..ops.mags import interp_mag as _interp_mag_kernel

__all__ = ["ModelGridInterpolator", "IsochroneInterpolator"]


class ModelGridInterpolator:
    """Base interpolator. Parameters come in *user order*
    (``param_names``); ``_param_index_order`` maps them to grid-axis order."""

    param_names: Tuple[str, ...] = ("p0", "p1", "p2", "distance", "AV")
    eep_replaces: Optional[str] = None
    _param_index_order: Tuple[int, ...] = (1, 2, 0, 3, 4)
    name = "model"

    def __init__(self, model: GridData, bc: GridData, bands: Optional[Sequence[str]] = None):
        if model.values.device != bc.values.device or model.values.dtype != bc.values.dtype:
            raise ValueError("model and BC grids must share one device and dtype")
        self.model = model
        self.bc = bc
        self.bands = list(bands) if bands is not None else list(bc.columns)

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

    # ------------------------------------------------------------ magnitudes
    def interp_mag_batch(self, points: torch.Tensor, bands=None):
        """(..., 5) user-order tensor -> (Teff, logg, feh, mags)."""
        band_icols = self._band_icols if bands is None else tuple(self.bc.column_index[b] for b in bands)
        return _interp_mag_kernel(points, self._param_index_order, self.model_packed,
                                  self._packed_icols, self.bc, band_icols)

    def interp_mag(self, pars, bands=None):
        """Host wrapper (reference models.py:402-445): broadcast numpy
        parameters, return numpy ``(Teff, logg, feh, mags)``."""
        arrs = np.broadcast_arrays(*[np.asarray(p, dtype=float) for p in pars[:5]])
        shape = arrs[0].shape
        pts = torch.as_tensor(np.stack([a.reshape(-1) for a in arrs], axis=-1),
                              device=self.device, dtype=self.dtype)
        Teff, logg, feh, mags = (x.cpu().numpy() for x in self.interp_mag_batch(pts, bands))
        if not shape:
            return float(Teff[0]), float(logg[0]), float(feh[0]), mags[0]
        return Teff.reshape(shape), logg.reshape(shape), feh.reshape(shape), mags.reshape(shape + (-1,))


class IsochroneInterpolator(ModelGridInterpolator):
    """Params (eep, age, feh, distance, AV); grid axes (age, feh, eep)."""

    param_names = ("eep", "age", "feh", "distance", "AV")
    eep_replaces = "mass"
    _param_index_order = (1, 2, 0, 3, 4)
    name = "iso"

    def _axis_names(self):
        return ["age", "feh", "eep"]
