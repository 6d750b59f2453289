"""The catalog likelihood: plain PyTorch version and dispatcher.

Counterpart of the likelihood half of the JAX package's catalog posterior
(``isochrones_tpu/batch.py:145-192``, ``_build_lnpost_data``), which XLA
compiles into one program. For parameters ``(S, B, 5)`` in the order
``(eep, age, feh, distance, AV)`` (S stars, B points each) it interpolates
the 6-column packed table once per point (Teff, logg, feh, Mbol, the
EEP-prior quantity and its d/dEEP derivative), then the BC grid at (Teff,
logg, feh, AV), forms the magnitudes with the distance modulus and adds each
star's own Gaussian spectroscopy, photometry and parallax terms. A NaN
observation (spectroscopy value, band or parallax) adds exactly 0; a NaN or
out-of-bounds coordinate makes the point's interpolation NaN, and so its
``ll``. It returns ``(ll (S, B), orig_val (S, B), deriv (S, B))``: the last
two feed the EEP change-of-variables prior, which stays in torch around the
call (:class:`~isochrones_torch.batch.BatchStarFitter`), as does the caller's
NaN -> -inf of ``ll``.

:func:`catalog_lnlike` dispatches on the parameters' device: a CPU tensor
takes :func:`catalog_lnlike_plain`, a CUDA tensor the hand-written kernel
(:mod:`isochrones_torch.ops.catalog_cuda`), with no fallback between them.
The plain version is also the kernel's oracle on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .interp import GridData, interp_nd
from .likelihood import gauss_lnprob

__all__ = ["CatalogLikelihood", "catalog_lnlike_plain", "catalog_lnlike"]


@dataclasses.dataclass(frozen=True, eq=False)
class CatalogLikelihood:
    """What the catalog likelihood needs besides the parameters: the grids,
    the parameter layout and every star's observations, as tensors with a
    leading star axis on the grids' device and in their dtype. NaN marks a
    missing observation."""

    index_order: Tuple[int, ...]  # user order -> (grid axes 0..2, distance, AV)
    pack6: GridData  # (n0, n1, n2, 6) model table, see model_packed6
    bc: GridData  # (b0, b1, b2, b3, bands) BC table
    band_icols: Tuple[int, ...]
    spec_vals: torch.Tensor  # (S, 3) observed Teff, logg, feh
    spec_uncs: torch.Tensor  # (S, 3)
    mag_vals: torch.Tensor  # (S, n_bands)
    mag_uncs: torch.Tensor  # (S, n_bands)
    plax: Optional[torch.Tensor] = None  # (S,) [mas]
    plax_unc: Optional[torch.Tensor] = None  # (S,)

    @property
    def n_stars(self) -> int:
        return self.spec_vals.shape[0]


def catalog_lnlike_plain(pars: torch.Tensor, lk: CatalogLikelihood):
    """(S, B, 5) -> (ll (S, B), orig_val (S, B), deriv (S, B)) in plain torch
    ops, on any device."""
    io = lk.index_order
    grid_pts = torch.stack([pars[..., io[0]], pars[..., io[1]], pars[..., io[2]]], dim=-1)
    pack6 = lk.pack6
    vals6 = interp_nd(pack6.values, pack6.knots, grid_pts, icols=(0, 1, 2, 3, 4, 5),
                      axis_maps=pack6.axis_maps)  # (S, B, 6)
    model_vals = (vals6[..., 0], vals6[..., 1], vals6[..., 2])

    ll = torch.zeros(pars.shape[:-1], dtype=pars.dtype, device=pars.device)
    for k, model_val in enumerate(model_vals):
        val, unc = lk.spec_vals[:, None, k], lk.spec_uncs[:, None, k]
        ll = ll + torch.where(torch.isnan(val), 0.0, gauss_lnprob(val, unc, model_val))
    if len(lk.band_icols):
        bc = lk.bc
        bc_pts = torch.stack([vals6[..., 0], vals6[..., 1], vals6[..., 2], pars[..., 4]], dim=-1)
        bc_vals = interp_nd(bc.values, bc.knots, bc_pts, icols=lk.band_icols, axis_maps=bc.axis_maps)
        dist_mod = 5.0 * torch.log10(pars[..., 3] / 10.0)
        mags = vals6[..., 3, None] + dist_mod[..., None] - bc_vals  # (S, B, n_bands)
        mag_vals, mag_uncs = lk.mag_vals[:, None, :], lk.mag_uncs[:, None, :]
        # each NaN band's term is dropped before the sum
        terms = torch.where(torch.isnan(mag_vals), 0.0, gauss_lnprob(mag_vals, mag_uncs, mags))
        ll = ll + torch.sum(terms, dim=-1)
    if lk.plax is not None:
        plax, plax_unc = lk.plax[:, None], lk.plax_unc[:, None]
        ll = ll + torch.where(torch.isnan(plax), 0.0, gauss_lnprob(plax, plax_unc, 1000.0 / pars[..., 3]))
    return ll, vals6[..., 4], vals6[..., 5]


def catalog_lnlike(pars: torch.Tensor, lk: CatalogLikelihood):
    """The catalog likelihood: CPU tensors take :func:`catalog_lnlike_plain`,
    CUDA tensors the kernel."""
    kind = pars.device.type
    if kind == "cuda":
        from .catalog_cuda import catalog_lnlike_cuda

        return catalog_lnlike_cuda(pars, lk)
    if kind == "cpu":
        return catalog_lnlike_plain(pars, lk)
    raise ValueError(f"catalog_lnlike runs on cpu or cuda tensors, got {kind}")
