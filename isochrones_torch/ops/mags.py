"""Synthetic magnitudes (counterpart of ``isochrones_tpu/ops/mags.py``):
3-d interpolation of (Teff, logg, feh, Mbol) from the stellar model grid,
then 4-d interpolation of the per-band bolometric corrections at
(Teff, logg, feh, AV), then ``mag = Mbol + 5 log10(d/10) - BC``.

:func:`interp_mag` interpolates through the :func:`~.interp.interp_nd`
dispatcher (kernel B on the card); :func:`interp_mag_plain` through
:func:`~.interp.interp_nd_plain`, for the plain versions of the other
kernels."""

from __future__ import annotations

from typing import Tuple

import torch

from .interp import GridData, interp_nd, interp_nd_plain

__all__ = ["interp_mag", "interp_mag_plain", "interp_mags"]


def _mags(interp, params, index_order, model, model_icols, bc, bc_icols):
    """The magnitudes of :func:`interp_mag`, both lerps through ``interp``."""
    i0, i1, i2, i_dist, i_av = index_order[:5]
    grid_pts = torch.stack([params[..., i0], params[..., i1], params[..., i2]], dim=-1)
    star_props = interp(model.values, model.knots, grid_pts, icols=tuple(model_icols), axis_maps=model.axis_maps)
    Teff, logg, feh, mbol = star_props.unbind(dim=-1)

    bc_pts = torch.stack([Teff, logg, feh, params[..., i_av]], dim=-1)
    bc_vals = interp(bc.values, bc.knots, bc_pts, icols=tuple(bc_icols), axis_maps=bc.axis_maps)

    dist_mod = 5.0 * torch.log10(params[..., i_dist] / 10.0)
    mags = mbol[..., None] + dist_mod[..., None] - bc_vals
    return Teff, logg, feh, mags


def interp_mag(
    params: torch.Tensor,
    index_order: Tuple[int, ...],
    model: GridData,
    model_icols: Tuple[int, int, int, int],
    bc: GridData,
    bc_icols: Tuple[int, ...],
):
    """params : (..., 5) in user parameter order; index_order maps user order
    to grid-axis order; model_icols are the (Teff, logg, feh, Mbol) columns;
    bc_icols the band columns of the BC grid.

    Returns ``(Teff, logg, feh, mags)`` with ``mags`` shaped ``(..., n_bands)``.
    """
    return _mags(interp_nd, params, index_order, model, model_icols, bc, bc_icols)


def interp_mag_plain(params, index_order, model, model_icols, bc, bc_icols):
    """:func:`interp_mag` through :func:`~.interp.interp_nd_plain` on any device."""
    return _mags(interp_nd_plain, params, index_order, model, model_icols, bc, bc_icols)


# the reference's serial-loop ``interp_mags`` (mags.py:64-124): here the one
# batched function serves both
interp_mags = interp_mag
