"""N-dimensional regular-grid multilinear interpolation on torch tensors.

Counterpart of ``isochrones_tpu/ops/interp.py`` (the row-gather path of
``interp_nd``; the block and paired gather paths are not ported). Semantics
match the JAX package exactly:

- NaN in any coordinate -> NaN row out.
- Out of bounds (x < knots[0] or x > knots[-1]) -> NaN row.
- Exact knot match -> cell = match index with weight 0 on the upper corner.
  All ``2**ndim`` corners enter the weighted sum, so the IEEE ``0 * NaN``
  poisoning by a NaN-padded neighbour is kept: it decides which ladder rows
  are finite near a track's end.
- Exact top knot -> upper corner clamped onto the top row (``_pin_top``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GridData", "compute_axis_maps", "find_cells_1d", "corner_data", "interp_nd"]


@dataclasses.dataclass(frozen=True)
class GridData:
    """Dense rectilinear grid on one device: ``values[(i0..ik), c]`` + axis knots.

    ``host_values`` is an optional numpy mirror for metadata queries (column
    limits); ``axis_maps`` are the static per-axis index maps of
    :func:`compute_axis_maps`, computed from the float64 host knots.
    """

    values: torch.Tensor  # (n0, ..., nk, ncols)
    knots: Tuple[torch.Tensor, ...]  # len k+1, each (n_i,)
    columns: Tuple[str, ...] = ()
    host_values: Optional[np.ndarray] = dataclasses.field(default=None, compare=False, repr=False)
    axis_maps: Optional[Tuple] = None

    @property
    def column_index(self):
        return {c: i for i, c in enumerate(self.columns)}


def compute_axis_maps(knots, rtol=1e-5) -> Tuple:
    """Per-axis analytic index maps from host knot arrays (same rule as the
    JAX package): ``("exact_affine", lo, step)`` for bit-exact uniform
    ladders in float32 and float64, ``("affine", lo, step)`` for uniform,
    ``("log", log_lo, log_step)`` for log-uniform, ``("compare", 0, 0)`` for
    small irregular axes, ``None`` for the searchsorted fallback."""
    maps = []
    for k in knots:
        k = np.asarray(k, dtype=float)
        if len(k) < 3:
            maps.append(None)
            continue
        d = np.diff(k)
        if np.allclose(d, d[0], rtol=rtol, atol=0.0) and d[0] > 0:
            step = float(d[0])
            lo0 = float(k[0])
            exact32 = np.array_equal(
                k.astype(np.float32),
                (np.float32(lo0) + np.arange(len(k), dtype=np.float32) * np.float32(step)),
            )
            exact64 = np.array_equal(k, lo0 + np.arange(len(k)) * step)
            if exact32 and exact64:
                maps.append(("exact_affine", lo0, step))
            else:
                maps.append(("affine", lo0, step))
            continue
        if (k > 0).all():
            ld = np.diff(np.log(k))
            if np.allclose(ld, ld[0], rtol=rtol, atol=0.0) and ld[0] > 0:
                maps.append(("log", float(np.log(k[0])), float(ld[0])))
                continue
        if len(k) <= 256 and (np.diff(k) > 0).all():
            maps.append(("compare", 0.0, 0.0))
            continue
        maps.append(None)
    return tuple(maps)


def _safe_div(num, denom):
    return num / torch.where(denom == 0, torch.ones_like(denom), denom)


def find_cells_1d(knots: torch.Tensor, x: torch.Tensor, axis_map=None):
    """Locate each ``x`` in sorted ``knots``: ``(cell, t, oob)`` with ``cell``
    the lower cell index (int64), ``t`` the in-cell coordinate (0 at an exact
    knot) and ``oob`` the strict out-of-bounds flag."""
    n = knots.shape[0]
    oob = (x < knots[0]) | (x > knots[-1])

    if axis_map is not None and n > 1:
        kind, lo0, step = axis_map

        def _pin_top(cell, t):
            # exact top-knot queries: cell = n-1, t = 0, so the weight-0
            # lower corner of the last cell cannot poison the lerp
            top = x == knots[-1]
            cell = torch.where(top, torch.full_like(cell, n - 1), cell)
            t = torch.where(top, torch.zeros_like(t), t)
            return cell, t

        if kind == "exact_affine":
            raw = (x - lo0) / step
            cell = torch.clamp(torch.floor(raw).to(torch.int64), 0, n - 2)
            lo = lo0 + cell.to(x.dtype) * step
            t = (x - lo) / step
            # division rounding may land one cell off near a knot: one
            # arithmetic fix-up keeps t in [0, 1)
            shift = (t >= 1.0).to(torch.int64) - (t < 0.0).to(torch.int64)
            cell = torch.clamp(cell + shift, 0, n - 2)
            lo = lo0 + cell.to(x.dtype) * step
            t = (x - lo) / step
            return (*_pin_top(cell, t), oob)
        if kind == "compare":
            cell = (x[..., None] >= knots).sum(dim=-1) - 1
            cell = torch.clamp(cell, 0, n - 2)
            lo = knots[cell]
            t = _safe_div(x - lo, knots[cell + 1] - lo)
            return (*_pin_top(cell, t), oob)
        xs = torch.log(torch.clamp(x, min=1e-300)) if kind == "log" else x
        raw = (xs - lo0) / step
        cell = torch.clamp(torch.floor(raw).to(torch.int64), 0, n - 2)
        # two-step fix-up against the true knots absorbs rounding in raw
        cell = torch.where(x < knots[cell], cell - 1, cell)
        cell = torch.clamp(cell, 0, n - 2)
        cell = torch.where(x >= knots[torch.clamp(cell + 1, 0, n - 1)], cell + 1, cell)
        cell = torch.clamp(cell, 0, n - 2)
        lo = knots[cell]
        t = _safe_div(x - lo, knots[cell + 1] - lo)
        return (*_pin_top(cell, t), oob)

    i_ins = torch.searchsorted(knots, x.contiguous(), side="left")
    i_safe = torch.clamp(i_ins, 0, n - 1)
    eq = knots[i_safe] == x
    cell = torch.where(eq, i_safe, i_ins - 1)
    cell_safe = torch.clamp(cell, 0, n - 2) if n > 1 else torch.zeros_like(cell)
    lo = knots[cell_safe]
    hi = knots[torch.clamp(cell_safe + 1, 0, n - 1)]
    t_lerp = _safe_div(x - lo, hi - lo)
    t = torch.where(eq, torch.zeros_like(x), t_lerp)
    # exact top knot: keep cell = n-1, t = 0 (upper corner clamps to itself)
    cell = torch.where(eq, cell, cell_safe)
    return cell, t, oob


def corner_data(
    values: torch.Tensor,
    knots: Sequence[torch.Tensor],
    points: torch.Tensor,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
):
    """Gather the ``2**ndim`` corner rows and lerp weights for a batch of
    points. values : (n0..nk, C); points : (B, ndim). Returns ``(corners
    (B, 2**ndim, n_icols), weights (B, 2**ndim), bad (B,))``."""
    ndim = len(knots)
    dims = values.shape[:-1]
    ncols = values.shape[-1]
    assert points.shape[-1] == ndim

    cells, ts = [], []
    bad = torch.isnan(points).any(dim=-1)
    for d in range(ndim):
        amap = axis_maps[d] if axis_maps is not None else None
        cell, t, oob = find_cells_1d(knots[d], points[..., d], axis_map=amap)
        cells.append(cell)
        ts.append(t)
        bad = bad | oob

    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * dims[d + 1]

    corner_w, corner_idx = [], []
    for i in range(2 ** ndim):
        w = torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
        idx = torch.zeros(points.shape[:-1], dtype=torch.int64, device=points.device)
        for d in range(ndim):
            o = (i >> (ndim - 1 - d)) & 1  # bit d of corner i -> offset in dim d
            w = w * (ts[d] if o else (1.0 - ts[d]))
            idx = idx + torch.clamp(cells[d] + o, 0, dims[d] - 1) * strides[d]
        corner_w.append(w)
        corner_idx.append(idx)

    weights = torch.stack(corner_w, dim=-1)  # (B, 2^ndim)
    flat_idx = torch.stack(corner_idx, dim=-1)  # (B, 2^ndim)
    flat_vals = values.reshape(-1, ncols)
    if icols is None:
        icols = tuple(range(ncols))
    col = torch.as_tensor(icols, dtype=torch.int64, device=values.device)
    # one advanced-index gather of just the wanted columns of each corner row
    corners = flat_vals[flat_idx[..., None], col]  # (B, 2^ndim, n_icols)
    return corners, weights, bad


def interp_nd(
    values: torch.Tensor,
    knots: Sequence[torch.Tensor],
    points: torch.Tensor,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
) -> torch.Tensor:
    """Batched multilinear interpolation on a dense rectilinear grid.

    values : (n0, ..., nk, C) dense grid (NaN-padded holes)
    knots  : k+1 sorted 1-D axis tensors
    points : (..., ndim) query coordinates
    icols  : column indices (None = all columns)
    axis_maps : per-axis analytic index maps (compute_axis_maps)

    Returns (..., n_icols); NaN rows for NaN/out-of-bounds queries.
    """
    batch_shape = points.shape[:-1]
    pts = points.reshape(-1, points.shape[-1])
    corners, weights, bad = corner_data(values, knots, pts, icols=icols, axis_maps=axis_maps)
    # elementwise products summed over corners: 0 * NaN stays NaN
    out = (weights[..., None] * corners.to(weights.dtype)).sum(dim=1)
    out = torch.where(bad[:, None], torch.full_like(out, float("nan")), out)
    return out.reshape(batch_shape + (out.shape[-1],))
