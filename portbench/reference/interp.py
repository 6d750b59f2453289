"""Plain multilinear interpolation on a dense rectilinear table, and the
synthetic magnitudes built on it.

The semantics the program's interpolation documents, written down again:
a NaN or out-of-bounds coordinate gives a NaN row; an exact knot is the
lower corner of its cell with weight 0 on the upper corner; an exact top
knot is the top row; every one of the ``2**ndim`` corners enters the
weighted sum, so a NaN corner poisons the row even at weight 0 (this decides
which ladder rows are finite near the end of a track). Cells are found by a
binary search on the knots, never by the program's index maps.
"""

from __future__ import annotations

import math

import torch


def locate(knots: torch.Tensor, x: torch.Tensor):
    """``(cell, t, bad)`` of ``x`` on the sorted ``knots``: the lower cell
    index, the in-cell coordinate and the NaN-or-outside flag."""
    n = knots.shape[0]
    bad = torch.isnan(x) | (x < knots[0]) | (x > knots[-1])
    xs = torch.where(bad, knots[0], x)
    # the last knot not above x, as the lower corner; the top knot is its own cell
    cell = torch.searchsorted(knots, xs.contiguous(), right=True) - 1
    cell = torch.clamp(cell, 0, n - 1)
    hi = torch.clamp(cell + 1, max=n - 1)
    lo_v, hi_v = knots[cell], knots[hi]
    width = torch.where(hi_v > lo_v, hi_v - lo_v, torch.ones_like(lo_v))
    t = torch.where(hi_v > lo_v, (xs - lo_v) / width, torch.zeros_like(xs))
    return cell, t, bad


def interp(values: torch.Tensor, knots, points: torch.Tensor, cols) -> torch.Tensor:
    """``values`` (n0, ..., nk, C), ``knots`` k+1 tensors, ``points`` (..., k+1)
    -> (..., len(cols)) in the points' dtype."""
    ndim = len(knots)
    dims = values.shape[:-1]
    shape = points.shape[:-1]
    pts = points.reshape(-1, ndim)
    table = values[..., list(cols)].reshape(-1, len(cols))
    cells, ts = [], []
    bad = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for d in range(ndim):
        c, t, b = locate(knots[d], pts[:, d])
        cells.append(c)
        ts.append(t)
        bad |= b
    out = torch.zeros((pts.shape[0], len(cols)), dtype=pts.dtype, device=pts.device)
    for corner in range(2 ** ndim):
        w = torch.ones(pts.shape[0], dtype=pts.dtype, device=pts.device)
        flat = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
        for d in range(ndim):
            up = (corner >> (ndim - 1 - d)) & 1
            w = w * (ts[d] if up else 1.0 - ts[d])
            flat = flat * dims[d] + torch.clamp(cells[d] + up, max=dims[d] - 1)
        out = out + w[:, None] * table[flat]
    out = torch.where(bad[:, None], torch.full_like(out, float("nan")), out)
    return out.reshape(shape + (len(cols),))


def magnitudes(iso, bc, pts5: torch.Tensor, band_cols):
    """``(Teff, logg, feh, mags (..., n_bands))`` at ``pts5`` (..., 5) in the
    order (eep, log10 age, [Fe/H], distance [pc], AV): Teff, logg, [Fe/H] and
    Mbol from the isochrone table at (age, feh, eep), the bolometric
    corrections at (Teff, logg, feh, AV), ``mag = Mbol + 5 log10(d / 10) - BC``.
    ``iso`` and ``bc`` are ``(values, knots, columns)`` triples."""
    values, knots_, columns = iso
    ci = {c: i for i, c in enumerate(columns)}
    grid_pts = torch.stack([pts5[..., 1], pts5[..., 2], pts5[..., 0]], dim=-1)
    props = interp(values, knots_, grid_pts, [ci["Teff"], ci["logg"], ci["feh"], ci["Mbol"]])
    Teff, logg, feh, mbol = props.unbind(-1)
    bvals, bknots, _ = bc
    bcs = interp(bvals, bknots, torch.stack([Teff, logg, feh, pts5[..., 4]], dim=-1), band_cols)
    dist_mod = 5.0 * torch.log10(pts5[..., 3] / 10.0)
    return Teff, logg, feh, mbol[..., None] + dist_mod[..., None] - bcs


def gauss_lnprob(val, unc, model):
    """The likelihood term as the system defines it (its constant's sign
    included): ``ln(1/sqrt(2 pi)) + ln(unc) - (val - model)^2 / (2 unc^2)``."""
    r = val - model
    return -0.5 * math.log(2 * math.pi) + torch.log(unc) - 0.5 * r * r / (unc * unc)
