"""The observation-tree likelihood: plain PyTorch version and dispatcher.

Counterpart of the body of the JAX package's ``make_tree_lnlike``
(``isochrones_tpu/observation.py:1269-1361``), which XLA compiles into one
program, and of the interpolation that its tree prior repeats per star
(``isochrones_tpu/treemodel.py:370-406``). For ``(B, n_params)`` parameters it
gathers every model star's five parameters, interpolates each star once over
the 6-column packed table (``model_packed6``: Teff, logg, feh, Mbol, the
EEP-prior quantity and its d/dEEP derivative) and the plan's bands for all
stars at once, sums the stars' fluxes into the observation rows through the
membership matrix, takes relative rows against their reference row, and adds
the Gaussian photometry, spectroscopy, parallax and AV terms; limits and
off-grid stars give -inf by the row rules of the reference. It returns
``(ll (B,), orig_val (B, n_stars), deriv (B, n_stars))``: the last two feed
the EEP change-of-variables prior, which stays in torch around the call
(:mod:`isochrones_torch.treemodel`).

:func:`tree_lnlike_fused` dispatches on the parameters' device: a CPU tensor
takes :func:`tree_lnlike_fused_plain`, a CUDA tensor the hand-written kernel
(:mod:`isochrones_torch.ops.tree_cuda`), with no fallback between them. The
plain version is also the kernel's oracle on the card. :func:`tree_lnlike` and
:func:`tree_lnlike_plain` are the same calls' ``ll`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .interp import GridData, _tracks_grad, interp_nd_plain
from .likelihood import LOG_ONE_OVER_ROOT_2PI

__all__ = ["TreeLikelihood", "tree_lnlike_fused_plain", "tree_lnlike_fused", "tree_lnlike_plain", "tree_lnlike"]


@dataclasses.dataclass(frozen=True, eq=False)
class TreeLikelihood:
    """What the tree likelihood needs besides the parameters, built once from
    a :class:`~isochrones_torch.observation.TreePlan` and its interpolator:
    the grids, the parameter layout, and the plan's index (int32) and value
    (the grids' dtype) arrays as tensors on the grids' device."""

    n_params: int
    index_order: Tuple[int, ...]  # user order -> (grid axes 0..2, distance, AV)
    model: GridData  # (n0, n1, n2, 6) model table, see model_packed6
    full_model: Optional[GridData]  # the table with the density column, when a row needs it
    density_icol: Optional[int]
    bc: GridData
    band_icols: Tuple[int, ...]
    star_param_idx: torch.Tensor  # (n_stars, 5)
    member: torch.Tensor  # (n_obs, n_stars) 0/1
    obs_band: torch.Tensor
    obs_val: torch.Tensor
    obs_unc: torch.Tensor
    obs_ref: torch.Tensor  # -1 for an absolute row
    obs_active: torch.Tensor  # int32 0/1
    spec_star: torch.Tensor
    spec_prop: torch.Tensor  # 0 Teff, 1 logg, 2 feh, 3 density
    spec_val: torch.Tensor
    spec_unc: torch.Tensor
    lim_star: torch.Tensor
    lim_prop: torch.Tensor
    lim_lo: torch.Tensor
    lim_hi: torch.Tensor
    plax_idx: torch.Tensor
    plax_val: torch.Tensor
    plax_unc: torch.Tensor
    av_idx: torch.Tensor
    av_val: torch.Tensor
    av_unc: torch.Tensor

    @property
    def n_stars(self) -> int:
        return self.star_param_idx.shape[0]

    @property
    def n_obs(self) -> int:
        return self.member.shape[0]

    @classmethod
    def from_plan(cls, plan):
        """The plan's arrays as tensors on the device and in the dtype of
        the plan's interpolator."""
        ic = plan.ic
        dev, dt = ic.device, ic.dtype

        def ints(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int32), device=dev)

        def vals(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt, device=dev)

        if ic.model_packed6 is None:
            raise ValueError("the tree likelihood needs the grid's EEP-prior columns (initial_mass and dm_deep, "
                             "or age and dt_deep) beside Teff, logg, feh and Mbol")
        has_density = bool((np.asarray(plan.spec_prop) == 3).any() or (np.asarray(plan.lim_prop) == 3).any())
        return cls(
            n_params=int(plan.n_params), index_order=tuple(ic._param_index_order), model=ic.model_packed6,
            full_model=ic.model if has_density else None,
            density_icol=ic.model.column_index["density"] if has_density else None,
            bc=ic.bc, band_icols=tuple(ic.bc.column_index[b] for b in plan.bands),
            star_param_idx=ints(plan.star_param_idx).reshape(-1, 5),
            member=vals(plan.member).reshape(len(plan.obs_band), len(plan.star_labels)),
            obs_band=ints(plan.obs_band), obs_val=vals(plan.obs_val), obs_unc=vals(plan.obs_unc),
            obs_ref=ints(plan.obs_ref), obs_active=ints(np.asarray(plan.obs_active) > 0),
            spec_star=ints(plan.spec_star), spec_prop=ints(plan.spec_prop), spec_val=vals(plan.spec_val),
            spec_unc=vals(plan.spec_unc),
            lim_star=ints(plan.lim_star), lim_prop=ints(plan.lim_prop), lim_lo=vals(plan.lim_lo),
            lim_hi=vals(plan.lim_hi),
            plax_idx=ints(plan.plax_idx), plax_val=vals(plan.plax_val), plax_unc=vals(plan.plax_unc),
            av_idx=ints(plan.av_idx), av_val=vals(plan.av_val), av_unc=vals(plan.av_unc),
        )


def _gauss(val, unc, mod):
    """The Gaussian term of the reference's tree (observation.py:1299-1303),
    with its ``+log(unc)`` constant."""
    return -0.5 * (val - mod) ** 2 / unc ** 2 + LOG_ONE_OVER_ROOT_2PI + torch.log(unc)


def _tree_ll(p, star_pars, vals6, dens, lk: TreeLikelihood, grad: bool):
    """The likelihood of :func:`tree_lnlike_fused_plain` from the stars'
    parameters, their pack columns and densities. With ``grad``, the values
    that a masked branch would otherwise carry into reverse mode (a NaN flux,
    a row of zero flux, an inactive row's magnitude) enter it detached, so
    that a finite ``ll`` takes no NaN from them."""
    neg_inf = float("-inf")
    io = lk.index_order
    Teff, logg, feh, mbol = vals6[..., 0], vals6[..., 1], vals6[..., 2], vals6[..., 3]
    lnl = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)

    if lk.n_obs:
        bc_pts = torch.stack([Teff, logg, feh, star_pars[..., io[4]]], dim=-1)
        bc_vals = interp_nd_plain(lk.bc.values, lk.bc.knots, bc_pts, icols=tuple(lk.band_icols),
                            axis_maps=lk.bc.axis_maps)
        dist_mod = 5.0 * torch.log10(star_pars[..., io[3]] / 10.0)
        mags = mbol[..., None] + dist_mod[..., None] - bc_vals  # (..., n_stars, n_bands)
        flux = 10.0 ** (-0.4 * mags)  # (..., n_stars, n_bands)
        if grad:
            fin = torch.isfinite(mags)
            flux = torch.where(fin, 10.0 ** (-0.4 * torch.where(fin, mags, torch.zeros_like(mags))), flux.detach())
        # A NaN flux is zeroed before the membership sum (0 * NaN would carry
        # one off-grid star into every row) and tracked per row instead, so
        # only rows that contain the off-grid star go bad.
        flux_b = flux[..., lk.obs_band.long()]  # (..., n_stars, n_obs)
        flux_nan = torch.isnan(flux_b)
        model_flux = torch.einsum("...so,os->...o", torch.where(flux_nan, 0.0, flux_b), lk.member)
        row_nan = torch.einsum("...so,os->...o", flux_nan.to(p.dtype), lk.member) > 0
        model_mag = -2.5 * torch.log10(model_flux)  # (..., n_obs)
        if grad:
            pos = model_flux > 0
            model_mag = torch.where(
                pos, -2.5 * torch.log10(torch.where(pos, model_flux, torch.ones_like(model_flux))),
                model_mag.detach())

        is_rel = lk.obs_ref >= 0
        ref_safe = torch.clamp(lk.obs_ref, min=0).long()
        mod = torch.where(is_rel, model_mag - model_mag[..., ref_safe], model_mag)
        val = torch.where(is_rel, lk.obs_val - lk.obs_val[ref_safe], lk.obs_val)
        active = lk.obs_active > 0
        if grad:
            mod = torch.where(active, mod, mod.detach())
        lnl = lnl + torch.sum(torch.where(active, _gauss(val, lk.obs_unc, mod), 0.0), dim=-1)
        # an active row whose members include an off-grid star, or whose
        # reference row does, gives -inf
        row_bad = row_nan | ~torch.isfinite(model_mag)
        row_bad = row_bad | (is_rel & row_bad[..., ref_safe])
        lnl = torch.where((active & row_bad).any(dim=-1), neg_inf, lnl)

    if len(lk.spec_star) or len(lk.lim_star):
        prop_mat = torch.stack([Teff, logg, feh, dens], dim=-1)  # (..., n_stars, 4)

    if len(lk.spec_star):
        mod = prop_mat[..., lk.spec_star.long(), lk.spec_prop.long()]
        lnl = lnl + torch.sum(_gauss(lk.spec_val, lk.spec_unc, mod), dim=-1)
        lnl = torch.where((~torch.isfinite(mod)).any(dim=-1), neg_inf, lnl)

    if len(lk.lim_star):
        mod = prop_mat[..., lk.lim_star.long(), lk.lim_prop.long()]
        broken = ((mod < lk.lim_lo) | (mod > lk.lim_hi) | ~torch.isfinite(mod)).any(dim=-1)
        lnl = torch.where(broken, neg_inf, lnl)

    if len(lk.plax_idx):
        lnl = lnl + torch.sum(_gauss(lk.plax_val, lk.plax_unc, 1000.0 / p[..., lk.plax_idx.long()]), dim=-1)

    if len(lk.av_idx):
        lnl = lnl + torch.sum(_gauss(lk.av_val, lk.av_unc, p[..., lk.av_idx.long()]), dim=-1)

    return torch.where(torch.isnan(lnl), neg_inf, lnl)


def tree_lnlike_fused_plain(p: torch.Tensor, lk: TreeLikelihood):
    """(..., n_params) -> (ll (...,), orig_val (..., n_stars), deriv (...,
    n_stars)) in plain torch ops, on any device.

    Its gradient, where ``p`` requires one: a non-finite output passes none
    back. A row whose ``ll`` is not finite sees its inputs detached in the
    likelihood (double-where on the row), a NaN ``orig_val`` or ``deriv``
    passes none through :func:`interp_nd_plain`, and a finite
    ``ll`` none through the masked values of :func:`_tree_ll`. The backward
    kernel (``csrc/tree_lnlike.cu``) holds to the same rule."""
    io = lk.index_order
    star_pars = p[..., lk.star_param_idx.long()]  # (..., n_stars, 5)
    grid_pts = torch.stack([star_pars[..., io[0]], star_pars[..., io[1]], star_pars[..., io[2]]], dim=-1)
    vals6 = interp_nd_plain(lk.model.values, lk.model.knots, grid_pts, icols=(0, 1, 2, 3, 4, 5),
                      axis_maps=lk.model.axis_maps)  # (..., n_stars, 6)
    if lk.full_model is not None and (len(lk.spec_star) or len(lk.lim_star)):
        dens = interp_nd_plain(lk.full_model.values, lk.full_model.knots, grid_pts, icols=(lk.density_icol,),
                         axis_maps=lk.full_model.axis_maps)[..., 0]
    else:
        dens = torch.zeros_like(vals6[..., 0])
    grad = _tracks_grad(p)
    ll = _tree_ll(p, star_pars, vals6, dens, lk, grad)
    if grad:
        keep = torch.isfinite(ll.detach())[..., None]
        if not bool(keep.all()):  # recompute with the non-finite rows' inputs detached
            p_l = torch.where(keep, p, p.detach())
            ll = _tree_ll(p_l, p_l[..., lk.star_param_idx.long()],
                          torch.where(keep[..., None], vals6, vals6.detach()), torch.where(keep, dens, dens.detach()),
                          lk, True)
    return ll, vals6[..., 4], vals6[..., 5]


def tree_lnlike_fused(p: torch.Tensor, lk: TreeLikelihood):
    """The tree likelihood and the EEP prior's two columns: CPU tensors take
    :func:`tree_lnlike_fused_plain`, CUDA tensors the kernel."""
    kind = p.device.type
    if kind == "cuda":
        from .tree_cuda import tree_lnlike_cuda

        return tree_lnlike_cuda(p, lk)
    if kind == "cpu":
        return tree_lnlike_fused_plain(p, lk)
    raise ValueError(f"tree_lnlike_fused runs on cpu or cuda tensors, got {kind}")


def tree_lnlike_plain(p: torch.Tensor, lk: TreeLikelihood) -> torch.Tensor:
    """``ll`` of :func:`tree_lnlike_fused_plain`."""
    return tree_lnlike_fused_plain(p, lk)[0]


def tree_lnlike(p: torch.Tensor, lk: TreeLikelihood) -> torch.Tensor:
    """``ll`` of :func:`tree_lnlike_fused`."""
    return tree_lnlike_fused(p, lk)[0]
