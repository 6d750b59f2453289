"""The fused star likelihood: plain PyTorch version and dispatcher.

Counterpart of the likelihood half of the JAX package's fused posterior
(``isochrones_tpu/starmodel.py:430-486``, ``_build_lnpost_fused``), which XLA
compiles into one program. For ``(B, N+4)`` parameters it interpolates each
component once over the 6-column packed table (``model_packed6``: Teff,
logg, feh, Mbol, the EEP-prior quantity and its d/dEEP derivative), then the
BC grid at (Teff, logg, feh, AV), forms the magnitudes with the distance
modulus, flux-sums the components, and adds the Gaussian spectroscopy terms
(a NaN observation is skipped), the photometry terms and the parallax term.
It returns ``(ll (B,), orig_val (B, N), deriv (B, N))``: the last two feed
the EEP change-of-variables prior, which stays in torch around the call.

:func:`star_lnlike_fused` dispatches on the parameters' device: a CPU tensor
takes :func:`star_lnlike_fused_plain`, a CUDA tensor the hand-written kernel
(:mod:`isochrones_torch.ops.star_cuda`), with no fallback between them. The
plain version is also the kernel's oracle on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .interp import GridData, _tracks_grad, interp_nd_plain
from .likelihood import gauss_lnprob, spectroscopy_lnlike, stack_components

__all__ = ["StarLikelihood", "star_lnlike_fused_plain", "star_lnlike_fused"]


@dataclasses.dataclass(frozen=True, eq=False)
class StarLikelihood:
    """What the fused likelihood of one star (system) needs besides the
    parameters: grids, parameter layout and observations, all fixed for a
    model's lifetime. Observations are host floats; NaN marks a missing
    spectroscopy channel."""

    n_stars: int
    index_order: Tuple[int, ...]  # user order -> (grid axes 0..2, distance, AV)
    pack6: GridData  # (n0, n1, n2, 6) model table, see model_packed6
    bc: GridData  # (b0, b1, b2, b3, bands) BC table
    band_icols: Tuple[int, ...]
    spec_vals: np.ndarray  # (3,) observed Teff, logg, feh
    spec_uncs: np.ndarray  # (3,)
    mag_vals: np.ndarray  # (n_bands,)
    mag_uncs: np.ndarray  # (n_bands,)
    parallax: Optional[Tuple[float, float]] = None  # (value, unc) [mas]
    dist_idx: int = -1  # parameter column of the distance


def _star_ll(pars, comp, vals6, lk: StarLikelihood):
    """The likelihood of :func:`star_lnlike_fused_plain` from the components'
    parameters and their interpolated pack columns."""
    N = lk.n_stars
    io = lk.index_order
    bc = lk.bc
    bc_pts = torch.stack([vals6[..., 0], vals6[..., 1], vals6[..., 2], comp[..., io[4]]], dim=-1)
    bc_vals = interp_nd_plain(bc.values, bc.knots, bc_pts, icols=lk.band_icols, axis_maps=bc.axis_maps)
    dist_mod = 5.0 * torch.log10(comp[..., io[3]] / 10.0)
    comp_mags = vals6[..., 3:4] + dist_mod[..., None] - bc_vals  # (B, N, n_bands)
    if N == 1:
        mags = comp_mags[..., 0, :]
    else:
        mags = -2.5 * torch.log10(torch.sum(10.0 ** (-0.4 * comp_mags), dim=-2))

    ll = spectroscopy_lnlike(lk.spec_vals, lk.spec_uncs, (vals6[..., 0, 0], vals6[..., 0, 1], vals6[..., 0, 2]),
                             pars[..., 0])
    if len(lk.band_icols):
        mag_vals = torch.as_tensor(lk.mag_vals, dtype=pars.dtype, device=pars.device)
        mag_uncs = torch.as_tensor(lk.mag_uncs, dtype=pars.dtype, device=pars.device)
        ll = ll + torch.sum(gauss_lnprob(mag_vals, mag_uncs, mags), dim=-1)
    if lk.parallax is not None:
        plax, plax_unc = lk.parallax
        ll = ll + gauss_lnprob(float(plax), float(plax_unc), 1000.0 / pars[..., lk.dist_idx])
    return ll


def star_lnlike_fused_plain(pars: torch.Tensor, lk: StarLikelihood):
    """(B, N+4) -> (ll (B,), orig_val (B, N), deriv (B, N)) in plain torch
    ops, on any device.

    Its gradient, where ``pars`` require one: a non-finite output passes
    none back. A row whose ``ll`` is not finite sees its inputs detached in
    the likelihood (double-where on the row), and a NaN ``orig_val`` or
    ``deriv`` passes none through :func:`interp_nd_plain`. The
    backward kernel (``csrc/star_lnlike.cu``) holds to the same rule."""
    N = lk.n_stars
    io = lk.index_order
    comp = stack_components(pars, N)  # (B, N, 5)
    grid_pts = torch.stack([comp[..., io[0]], comp[..., io[1]], comp[..., io[2]]], dim=-1)
    pack6 = lk.pack6
    vals6 = interp_nd_plain(pack6.values, pack6.knots, grid_pts, icols=(0, 1, 2, 3, 4, 5),
                      axis_maps=pack6.axis_maps)  # (B, N, 6)
    ll = _star_ll(pars, comp, vals6, lk)
    if _tracks_grad(pars):
        keep = torch.isfinite(ll.detach())[..., None]
        if not bool(keep.all()):  # recompute with the non-finite rows' inputs detached
            pars_l = torch.where(keep, pars, pars.detach())
            vals6_l = torch.where(keep[..., None], vals6, vals6.detach())
            ll = _star_ll(pars_l, stack_components(pars_l, N), vals6_l, lk)
    return ll, vals6[..., 4], vals6[..., 5]


def star_lnlike_fused(pars: torch.Tensor, lk: StarLikelihood):
    """The fused likelihood: CPU tensors take :func:`star_lnlike_fused_plain`,
    CUDA tensors the kernel."""
    kind = pars.device.type
    if kind == "cuda":
        from .star_cuda import star_lnlike_cuda

        return star_lnlike_cuda(pars, lk)
    if kind == "cpu":
        return star_lnlike_fused_plain(pars, lk)
    raise ValueError(f"star_lnlike_fused runs on cpu or cuda tensors, got {kind}")
