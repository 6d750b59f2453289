"""Batched EEP (equivalent evolutionary phase) inversion on torch tensors.

Counterpart of ``isochrones_tpu/ops/eep.py``:

* :func:`interp_eep` (reference ``isochrones/interp.py:488-568``): given
  (age, feh, mass), search the 4 neighbouring tracks' age arrays and blend the
  4 integer-resolution EEPs bilinearly, with the end-of-track neighbour
  substitution. The search runs in place on the padded ``(n_feh * n_mass,
  n_eep)`` age matrix (:func:`searchsorted_rows`): a fixed-step lower bound
  that gathers one scalar per point and step, so no row is materialized and
  the batch can hold millions of points.
* :func:`get_eep_newton` (reference ``isochrones/models.py:544-578``): a
  damped Newton iteration on the residual of the interpolated column, the
  derivative taken by ``torch.autograd`` through :func:`interp_nd_plain` (the
  lerp's slope in the located cell; 0 at an exact top knot, and where the
  residual is NaN, where the step is then not finite and the old value is
  kept), or with ``closed_slope`` by :func:`newton_slope`.
* :func:`newton_slope`: that derivative in closed form, the plain version of
  what the forward-model kernel computes (``csrc/interp_common.cuh::
  lerp_slope``).

Age matrices are padded with +inf past each track's end, which makes the
unrestricted lower bound equal to the reference's search with explicit
lengths.
"""

from __future__ import annotations

import math

import torch

from .interp import GridData, corner_data, find_cells_1d, interp_nd_plain

__all__ = ["searchsorted_rows", "interp_eep", "newton_slope", "get_eep_newton"]

#: points of the Newton seed scan that one interpolation call takes
_SCAN_POINTS = 1 << 22


def searchsorted_rows(flat_arrays: torch.Tensor, row_idx: torch.Tensor, x: torch.Tensor, n_cols: int):
    """Batched lower bound: for each b the insertion index (int64) of ``x[b]``
    in ``flat_arrays[row_idx[b] * n_cols : (row_idx[b] + 1) * n_cols]``.

    Branchless fixed-step bisection: one scalar gather per step,
    ``ceil(log2(n_cols)) + 1`` steps. Once the interval has closed on
    ``n_cols`` a further step reads the next row's first entry, and past the
    last row nothing (the comparison is then false, as for the JAX package's
    NaN fill): a query above every entry of a row can so give ``n_cols + 1``,
    which callers treat like ``n_cols``."""
    n_steps = max(1, int(math.ceil(math.log2(max(n_cols, 2)))) + 1)
    lo = torch.zeros_like(row_idx, dtype=torch.int64)
    hi = torch.full_like(lo, n_cols)
    base = row_idx.to(torch.int64) * n_cols
    last = flat_arrays.shape[0] - 1
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        idx = base + mid
        pred = (flat_arrays[torch.clamp(idx, max=last)] < x) & (idx <= last)
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(pred, hi, mid)
    return lo


def interp_eep(
    ages: torch.Tensor,
    fehs: torch.Tensor,
    masses: torch.Tensor,
    feh_knots: torch.Tensor,
    mass_knots: torch.Tensor,
    age_arrays: torch.Tensor,  # (n_feh * n_mass, n_eep), +inf past track end
    lengths: torch.Tensor,  # (n_feh * n_mass,)
    eep0: float = 1.0,
) -> torch.Tensor:
    """Fast (integer-resolution) (age, feh, mass) -> EEP inversion.

    Insertion index + ``eep0`` per corner track, the end-of-track neighbour
    substitution applied in sequence (``e01`` takes the already substituted
    ``e00``), bilinear blend in (feh, mass), NaN for NaN or out-of-bounds
    input and for a query past a full-length track."""
    n_eep = age_arrays.shape[1]
    n_mass = mass_knots.shape[0]
    n_feh = feh_knots.shape[0]

    c0, d0, oob0 = find_cells_1d(feh_knots, fehs)
    c1, d1, oob1 = find_cells_1d(mass_knots, masses)
    bad = torch.isnan(ages) | torch.isnan(fehs) | torch.isnan(masses) | oob0 | oob1
    # a NaN coordinate has no cell: keep its gathers inside the table
    c0 = torch.clamp(c0, 0, n_feh - 1)
    c1 = torch.clamp(c1, 0, n_mass - 1)

    c0p = torch.clamp(c0 + 1, 0, n_feh - 1)
    c1p = torch.clamp(c1 + 1, 0, n_mass - 1)
    ind_00 = c0 * n_mass + c1
    ind_01 = c0 * n_mass + c1p
    ind_10 = c0p * n_mass + c1
    ind_11 = c0p * n_mass + c1p

    flat = age_arrays.reshape(-1)
    i00 = searchsorted_rows(flat, ind_00, ages, n_eep)
    i01 = searchsorted_rows(flat, ind_01, ages, n_eep)
    i10 = searchsorted_rows(flat, ind_10, ages, n_eep)
    i11 = searchsorted_rows(flat, ind_11, ages, n_eep)

    # past the end of a full-length track -> NaN
    bad = bad | (i00 >= n_eep) | (i01 >= n_eep) | (i10 >= n_eep) | (i11 >= n_eep)

    dt = ages.dtype
    e00 = i00.to(dt) + eep0
    e01 = i01.to(dt) + eep0
    e10 = i10.to(dt) + eep0
    e11 = i11.to(dt) + eep0

    inv00 = i00 >= lengths[ind_00]
    inv01 = i01 >= lengths[ind_01]
    inv10 = i10 >= lengths[ind_10]
    inv11 = i11 >= lengths[ind_11]

    # sequential neighbour substitution, in the reference's order
    e00 = torch.where(inv00, e01, e00)
    e01 = torch.where(inv01, e00, e01)
    e10 = torch.where(inv10, e11, e10)
    e11 = torch.where(inv11, e10, e11)

    eep_lo = (1.0 - d1) * e00 + d1 * e01
    eep_hi = (1.0 - d1) * e10 + d1 * e11
    out = (1.0 - d0) * eep_lo + d0 * eep_hi
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def newton_slope(grid: GridData, points: torch.Tensor, icol: int):
    """``(value, slope)`` of column ``icol`` at ``points`` (..., ndim): the
    value as :func:`interp_nd_plain` gives it, and its derivative along the last
    axis in closed form, as ``torch.autograd`` takes it through
    :func:`find_cells_1d` and :func:`interp_nd_plain` where the value is finite:
    the sum over the other axes' corners of their weight times (upper - lower
    corner value), times dt/dx. dt/dx is ``1 / step`` for the
    ``exact_affine`` kind and ``1 / (hi - lo)`` (through ``_safe_div``) for
    the others, and 0 where t is replaced by a constant (an exact knot on the
    searchsorted path, the top knot's ``_pin_top``), whatever the corners
    hold. A NaN-padded corner gives a NaN slope, as its 0 * NaN gives a NaN
    value and as ``jax.grad`` of the JAX package's ``interp_nd`` gives it
    (autograd passes 0 through the port's NaN value); at a NaN or
    out-of-bounds point the corners enter times 0."""
    knots, maps = grid.knots, grid.axis_maps or (None,) * len(grid.knots)
    ndim = len(knots)
    batch_shape = points.shape[:-1]
    pts = points.reshape(-1, ndim)
    corners, weights, bad = corner_data(grid.values, knots, pts, icols=(icol,), axis_maps=grid.axis_maps)
    c = corners[..., 0].to(weights.dtype)  # (B, 2**ndim), the last axis' bit lowest
    value = (weights[..., None] * c[..., None]).sum(dim=1)[:, 0]  # interp_nd's sum, bitwise
    value = torch.where(bad, torch.full_like(value, float("nan")), value)
    # the other axes' weights, in corner_data's product order
    w = torch.ones_like(c[:, :1])
    for d in range(ndim - 1):
        _, t, _ = find_cells_1d(knots[d], pts[:, d], axis_map=maps[d])
        w = (w[:, :, None] * torch.stack([1.0 - t, t], dim=-1)[:, None, :]).reshape(w.shape[0], -1)
    live = (~bad).to(c.dtype)[:, None]  # autograd's gradient at a bad point is 0 times the corners
    diff = (w * (live * c[:, 1::2] - live * c[:, 0::2])).sum(dim=1)
    # dt/dx along the last axis: 1 / den, 0 where pinned
    k, x, amap = knots[-1], pts[:, -1], maps[-1]
    n = k.shape[0]
    cell = find_cells_1d(k, x, axis_map=amap)[0]
    if amap is not None and n > 1:
        pinned = x == k[-1]
        if amap[0] == "exact_affine":
            den = torch.full_like(x, float(amap[2]))
        else:
            lo_i = torch.clamp(cell, 0, n - 2)
            den = k[lo_i + 1] - k[lo_i]
    else:
        pinned = k[torch.clamp(cell, 0, n - 1)] == x
        lo_i = torch.clamp(cell, 0, n - 2) if n > 1 else torch.zeros_like(cell)
        den = k[torch.clamp(lo_i + 1, 0, n - 1)] - k[lo_i]
    den = torch.where(den == 0, torch.ones_like(den), den)
    slope = torch.where(pinned, torch.zeros_like(diff), diff / den)
    return value.reshape(batch_shape), slope.reshape(batch_shape)


def get_eep_newton(
    grid: GridData,
    eep_init: torch.Tensor,
    targets: torch.Tensor,  # target age (track grids) or mass (iso grids)
    x0: torch.Tensor,  # first grid-axis coordinate (feh for tracks, age for isos)
    x1: torch.Tensor,  # second grid-axis coordinate (mass for tracks, feh for isos)
    i_age_col: int,
    n_iter: int = 12,
    closed_slope: bool = False,
):
    """Accurate EEP inversion: ``(eep, residual)`` after ``n_iter`` damped
    Newton steps on ``interp(x0, x1, eep)[col] - target``, seeded by the fast
    estimate, or where that has no finite residual by the best of a 33-point
    scan of the EEP axis. The step is clipped to +-32, the iterate clamped to
    the EEP knots, a non-finite new value keeps the old one, and the result
    is NaN where the final residual is not finite. The slope comes from
    ``torch.autograd``, or with ``closed_slope`` from :func:`newton_slope`."""
    eep_knots = grid.knots[-1]
    eep_min = eep_knots[0]
    eep_max = eep_knots[-1]

    def resid(eep):
        pt = torch.stack([x0.expand_as(eep), x1.expand_as(eep), eep], dim=-1)
        vals = interp_nd_plain(grid.values, grid.knots, pt, icols=(i_age_col,), axis_maps=grid.axis_maps)
        return vals[..., 0] - targets

    # coarse-scan fallback seed: the finite scan point closest to zero
    n_scan = 33
    scan_eeps = torch.linspace(float(eep_min), float(eep_max), n_scan, dtype=targets.dtype, device=targets.device)
    # (n_scan, B), a few scan points per call so that one call's corner
    # gathers stay near _SCAN_POINTS rows
    rows = max(1, _SCAN_POINTS // max(targets.numel(), 1))
    scan_r = torch.cat([resid(scan_eeps[i : i + rows].reshape((-1,) + (1,) * targets.dim()).expand(
        (len(scan_eeps[i : i + rows]),) + targets.shape)) for i in range(0, n_scan, rows)])
    inf = torch.full_like(scan_r, float("inf"))
    best = torch.argmin(torch.where(torch.isfinite(scan_r), scan_r.abs(), inf), dim=0)
    scan_seed = scan_eeps[best]

    eep = torch.clamp(eep_init, eep_min, eep_max)
    r_init = resid(torch.nan_to_num(eep, nan=float(eep_min)))
    eep = torch.where(torch.isfinite(eep) & torch.isfinite(r_init), eep, scan_seed)
    for _ in range(n_iter):
        if closed_slope:
            pt = torch.stack([x0.expand_as(eep), x1.expand_as(eep), eep], dim=-1)
            value, g = newton_slope(grid, pt, i_age_col)
            r = value - targets
        else:
            with torch.enable_grad():
                e = eep.detach().requires_grad_(True)
                r = resid(e)
                (g,) = torch.autograd.grad(r.sum(), e)
            r = r.detach()
        step = r / torch.where(g == 0, torch.ones_like(g), g)
        step = torch.clamp(step, -32.0, 32.0)  # damping against a huge derivative's noise
        new = torch.clamp(eep - step, eep_min, eep_max)
        eep = torch.where(torch.isfinite(new), new, eep)
    final_r = resid(eep)
    return torch.where(torch.isfinite(final_r), eep, torch.full_like(eep, float("nan"))), final_r
