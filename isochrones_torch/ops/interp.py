"""N-dimensional regular-grid multilinear interpolation on torch tensors.

Counterpart of ``isochrones_tpu/ops/interp.py`` (the row-gather path of
``interp_nd``; the block and paired gather paths are not ported) and of its
:class:`GridInterpolator`, which densifies a grid's table. Semantics match
the JAX package exactly:

- NaN in any coordinate -> NaN row out.
- Out of bounds (x < knots[0] or x > knots[-1]) -> NaN row.
- Exact knot match -> cell = match index with weight 0 on the upper corner.
  All ``2**ndim`` corners enter the weighted sum, so the IEEE ``0 * NaN``
  poisoning by a NaN-padded neighbour is kept: it decides which ladder rows
  are finite near a track's end.
- Exact top knot -> upper corner clamped onto the top row (``_pin_top``).

:func:`interp_nd` dispatches on the points' device: a CPU tensor takes
:func:`interp_nd_plain`, a CUDA tensor the hand-written kernel
(:mod:`isochrones_torch.ops.interp_cuda`, kernel B, with its backward B'),
with no fallback between them. The plain version is also the kernel's
oracle on the card, and the plain versions of the other kernels
(``ops/star.py``, ``tree.py``, ``catalog.py``, ``generate.py``, ``eep.py``)
call it directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GridData", "compute_axis_maps", "find_cells_1d", "corner_data", "interp_nd", "interp_nd_plain",
           "interp_grid", "GridInterpolator", "REFERENCE_DEVIATIONS"]

#: The intended semantic deviations from the reference implementation, as
#: the JAX package records them; parity harnesses consult it before they
#: compare point by point.
REFERENCE_DEVIATIONS = {
    "top_knot_clamp": {
        "where": "interp_nd exact top-knot queries",
        "reference": "isochrones/interp.py:77-82 — numba kernel reads one row "
                     "past the axis end with weight 0 (undefined behavior; in "
                     "practice returns garbage*0 or poisons with NaN)",
        "here": "upper corner index clamped to the last knot; an exact "
                "top-knot query returns the exact grid value",
        "impact": "only queries with a coordinate exactly equal to the LAST "
                  "knot of any axis differ; interior and OOB semantics match "
                  "bit-for-bit",
    },
}


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
    def ndim_grid(self) -> int:
        return len(self.knots)

    @property
    def n_columns(self) -> int:
        return self.values.shape[-1]

    @property
    def column_index(self):
        return {c: i for i, c in enumerate(self.columns)}

    def astype(self, dtype) -> "GridData":
        """The same grid in the torch ``dtype`` (the host mirror too)."""
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return dataclasses.replace(
            self, values=self.values.to(dtype), knots=tuple(k.to(dtype) for k in self.knots),
            host_values=None if self.host_values is None else self.host_values.astype(np_dtype))

    def icols(self, cols) -> Tuple[int, ...]:
        """Column indices of names (or indices); ``None``/``"all"`` = every column."""
        if cols is None or cols == "all":
            return tuple(range(self.values.shape[-1]))
        ci = self.column_index
        return tuple(ci[c] if isinstance(c, str) else int(c) for c in cols)


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


def _tracks_grad(x: torch.Tensor) -> bool:
    """Whether autograd records the operations on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


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
    (B, 2**ndim, n_icols), weights (B, 2**ndim), bad (B,))``. Where autograd
    records the call, a bad point's ``t`` is zeroed (see :func:`interp_nd_plain`)."""
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

    if _tracks_grad(points):
        # double-where: a bad point's t may be NaN, and reverse mode would
        # multiply the zero cotangent of its masked row into it
        ts = [torch.where(bad, torch.zeros_like(t), t) for t in ts]

    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * dims[d + 1]

    # all 2**ndim corners at once: bit d of corner i is its offset in dim d
    corner = torch.arange(2 ** ndim, device=points.device)
    weights = torch.ones(points.shape[:-1] + (2 ** ndim,), dtype=points.dtype, device=points.device)
    flat_idx = torch.zeros(points.shape[:-1] + (2 ** ndim,), dtype=torch.int64, device=points.device)
    for d in range(ndim):
        o = (corner >> (ndim - 1 - d)) & 1
        weights = weights * torch.where(o.bool(), ts[d][..., None], 1.0 - ts[d][..., None])
        flat_idx = flat_idx + torch.clamp(cells[d][..., None] + o, 0, dims[d] - 1) * strides[d]
    flat_vals = values.reshape(-1, ncols)
    if icols is None:
        icols = tuple(range(ncols))
    col = torch.as_tensor(icols, dtype=torch.int64, device=values.device)
    # one advanced-index gather of just the wanted columns of each corner row
    corners = flat_vals[flat_idx[..., None], col]  # (B, 2^ndim, n_icols)
    return corners, weights, bad


def interp_nd_plain(
    values: torch.Tensor,
    knots: Sequence[torch.Tensor],
    points: torch.Tensor,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
) -> torch.Tensor:
    """Batched multilinear interpolation on a dense rectilinear grid, in
    plain torch ops on any device.

    values : (n0, ..., nk, C) dense grid (NaN-padded holes)
    knots  : k+1 sorted 1-D axis tensors
    points : (..., ndim) query coordinates
    icols  : column indices (None = all columns)
    axis_maps : per-axis analytic index maps (compute_axis_maps)

    Returns (..., n_icols); NaN rows for NaN/out-of-bounds queries. The
    gradient is the lerp's slope: dt/dx is ``1 / step`` or ``1 / (hi - lo)``,
    and 0 where t is a constant (an exact knot on the searchsorted path,
    ``_pin_top``'s top knot). A NaN output passes no gradient: at a bad
    point, or in a column with a NaN-padded corner, it is 0 (the JAX
    package's is NaN there, from the corner's ``0 * NaN``). The backward
    kernels (B' and those of the fused likelihoods) keep this rule.
    """
    batch_shape = points.shape[:-1]
    pts = points.reshape(-1, points.shape[-1])
    corners, weights, bad = corner_data(values, knots, pts, icols=icols, axis_maps=axis_maps)
    corners = corners.to(weights.dtype)
    if _tracks_grad(pts):
        # The same values with a gradient that a NaN output does not poison:
        # a NaN corner is zeroed before the product (double-where) and its
        # column masked after it, so a NaN value passes no gradient and a
        # finite one its lerp's slope.
        nan_corner = torch.isnan(corners)
        out = (weights[..., None] * torch.where(nan_corner, torch.zeros_like(corners), corners)).sum(dim=1)
        bad_col = bad[:, None] | nan_corner.any(dim=1)
        out = torch.where(bad_col, torch.full_like(out, float("nan")), out)
        return out.reshape(batch_shape + (out.shape[-1],))
    # elementwise products summed over corners: 0 * NaN stays NaN
    out = (weights[..., None] * corners).sum(dim=1)
    out = torch.where(bad[:, None], torch.full_like(out, float("nan")), out)
    return out.reshape(batch_shape + (out.shape[-1],))


def interp_nd(
    values: torch.Tensor,
    knots: Sequence[torch.Tensor],
    points: torch.Tensor,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
    planar: bool = False,
) -> torch.Tensor:
    """:func:`interp_nd_plain`'s function: CPU points take it, CUDA points
    kernel B (and B' for their gradient), any other device raises. With
    ``planar`` kernel B reads a column-planar copy of the wanted columns,
    which it builds once per table and column tuple
    (:func:`~isochrones_torch.ops.interp_cuda.planar_columns`): for calls
    whose neighbouring points fall in neighbouring cells. The CPU ignores it."""
    kind = points.device.type
    if kind == "cuda":
        from .interp_cuda import interp_nd_cuda

        return interp_nd_cuda(values, knots, points, icols=icols, axis_maps=axis_maps, planar=planar)
    if kind == "cpu":
        return interp_nd_plain(values, knots, points, icols=icols, axis_maps=axis_maps)
    raise ValueError(f"interp_nd runs on cpu or cuda tensors, got {kind}")


def interp_grid(grid: GridData, points: torch.Tensor, cols=None) -> torch.Tensor:
    """Interpolate named or indexed columns of a :class:`GridData`."""
    return interp_nd(grid.values, grid.knots, points, icols=grid.icols(cols), axis_maps=grid.axis_maps)


class GridInterpolator:
    """Host-facing wrapper of one dense grid (counterpart of the JAX
    package's ``GridInterpolator``, reference ``DFInterpolator``,
    interp.py:571-698).

    Built from a grid's :class:`~isochrones_torch.grids.base.Table`: the
    rows are placed on the product of the index levels (each level's sorted
    values present), NaN where the table has no row (``is_full``: the table
    is that product already, in sorted order), then uploaded to ``device``
    in ``dtype``. ``filename`` caches the dense float64 grid in an ``.npz``
    file. Or built around a :class:`GridData` (``grid_data``).
    """

    def __init__(self, df=None, filename=None, recalc=False, is_full=False, grid_data=None, dtype=None,
                 device="cuda"):
        if grid_data is not None:
            if grid_data.axis_maps is None:
                grid_data = dataclasses.replace(
                    grid_data, axis_maps=compute_axis_maps([k.cpu().numpy() for k in grid_data.knots]))
            self.grid_data = grid_data if dtype is None else grid_data.astype(dtype)
            self.columns = list(grid_data.columns)
            self.index_names = None
        else:
            from ..convert import grid_from_numpy

            self.columns = list(df.columns)
            values, knots = self._densify(df, filename=filename, recalc=recalc, is_full=is_full)
            self.grid_data = grid_from_numpy(values, knots, self.columns, device=device,
                                             dtype=torch.float64 if dtype is None else dtype)
            self.index_names = list(df.index.names)

        self.n_columns = len(self.columns)
        self.column_index = {c: i for i, c in enumerate(self.columns)}
        self.ndim = self.grid_data.ndim_grid

    @property
    def grid(self):
        """The dense grid as a numpy array ``(n0, ..., nk, n_columns)``."""
        if self.grid_data.host_values is not None:
            return self.grid_data.host_values
        return self.grid_data.values.cpu().numpy()

    @property
    def index_columns(self):
        """The knots of each axis, numpy arrays."""
        return tuple(k.cpu().numpy() for k in self.grid_data.knots)

    @staticmethod
    def _densify(df, filename=None, recalc=False, is_full=False):
        """``(grid, levels)``: the table's rows on the product of its index
        levels, float64, NaN where no row is (the JAX package's
        ``reindex(MultiIndex.from_product(levels))``)."""
        import os

        levels = tuple(np.asarray(lv, dtype=float) for lv in df.index.levels)
        if filename is not None and os.path.exists(filename) and not recalc:
            with np.load(filename, allow_pickle=False) as d:
                grid, columns = d["grid"], [str(c) for c in d["columns"]]
            if columns != [str(c) for c in df.columns]:
                raise ValueError("Table columns do not match columns loaded from full grid!")
            return grid, levels

        shape = tuple(len(lv) for lv in levels)
        values = df.values
        if is_full:
            grid = values.reshape(shape + (values.shape[1],))
        else:
            flat = np.ravel_multi_index(df.index.codes, shape)
            if len(np.unique(flat)) != len(flat):
                raise ValueError("cannot densify a table with duplicate index entries")
            grid = np.full((int(np.prod(shape)), values.shape[1]), np.nan)
            grid[flat] = values
            grid = grid.reshape(shape + (values.shape[1],))
        if filename is not None:
            np.savez(filename, grid=grid, columns=np.asarray(df.columns, dtype=str))
        return grid, levels

    def add_column(self, values, name):
        """Append one column of grid shape (reference interp.py:616-623)."""
        g = self.grid_data
        host = None
        if g.host_values is not None:
            hv = np.asarray(values, dtype=g.host_values.dtype)
            host = np.concatenate([g.host_values, hv.reshape(g.host_values.shape[:-1] + (1,))], axis=-1)
        col = torch.as_tensor(np.asarray(values), dtype=g.values.dtype, device=g.values.device)
        new_vals = torch.cat([g.values, col.reshape(g.values.shape[:-1] + (1,))], dim=-1)
        self.columns = self.columns + [name]
        self.grid_data = dataclasses.replace(g, values=new_vals, columns=tuple(self.columns), host_values=host)
        self.n_columns += 1
        self.column_index[name] = self.n_columns - 1

    def __call__(self, p, cols="all"):
        """Interpolate at host points ``p`` (one value or array per axis,
        broadcast together): numpy ``(..., n_cols)``, ``(n_cols,)`` for
        scalars."""
        g = self.grid_data
        icols = g.icols(None if cols == "all" else cols)
        scalar_in = all(np.ndim(x) == 0 for x in p)
        pts = np.broadcast_arrays(*[np.asarray(x, dtype=float) for x in p])
        points = torch.as_tensor(np.stack(pts, axis=-1), dtype=g.values.dtype, device=g.values.device)
        if points.ndim == 1:
            points = points[None, :]
        out = interp_nd(g.values, g.knots, points, icols=icols, axis_maps=g.axis_maps).cpu().numpy()
        if scalar_in:
            return out[0]
        return out

    def find_closest(self, val, lo, hi, v1, v2, col="initial_mass", **kwargs):
        """Root-find along the last grid axis (reference interp.py:404-485,
        625-629)."""
        from .rootfind import find_closest_grid

        return find_closest_grid(self.grid_data, val, lo, hi, v1, v2, self.column_index[col], **kwargs)
