"""Synthetic magnitudes (counterpart of ``isochrones_tpu/ops/mags.py``):
3-d interpolation of (Teff, logg, feh, Mbol) from the stellar model grid,
then 4-d interpolation of the per-band bolometric corrections at
(Teff, logg, feh, AV), then ``mag = Mbol + 5 log10(d/10) - BC``."""

from __future__ import annotations

from typing import Tuple

import torch

from .interp import GridData, interp_nd

__all__ = ["interp_mag", "interp_mags"]


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
    i0, i1, i2, i_dist, i_av = index_order[:5]
    grid_pts = torch.stack([params[..., i0], params[..., i1], params[..., i2]], dim=-1)
    star_props = interp_nd(model.values, model.knots, grid_pts, icols=tuple(model_icols),
                           axis_maps=model.axis_maps)
    Teff, logg, feh, mbol = star_props.unbind(dim=-1)

    bc_pts = torch.stack([Teff, logg, feh, params[..., i_av]], dim=-1)
    bc_vals = interp_nd(bc.values, bc.knots, bc_pts, icols=tuple(bc_icols), axis_maps=bc.axis_maps)

    dist_mod = 5.0 * torch.log10(params[..., i_dist] / 10.0)
    mags = mbol[..., None] + dist_mod[..., None] - bc_vals
    return Teff, logg, feh, mags


# the reference's serial-loop ``interp_mags`` (mags.py:64-124): here the one
# batched function serves both
interp_mags = interp_mag
