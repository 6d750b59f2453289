"""Root finding along a grid axis on torch tensors.

Counterpart of ``isochrones_tpu/ops/rootfind.py``, the reference's
``find_closest3`` (``isochrones/interp.py:404-485``): bisection seeding a
secant iteration. The JAX package runs both loops as ``lax.while_loop``
under ``vmap``, which iterates until every lane is done and freezes the lanes
that are; here each loop is a Python loop over the whole batch with a
per-lane ``active`` mask and the same caps. Reading ``active.any()`` back
costs one host synchronization per round.
"""

from __future__ import annotations

import torch

from .interp import GridData, interp_nd

__all__ = ["find_closest_grid", "find_closest_grid_batch"]


def _find_closest_fn(f, a, b, bisect_tol=0.5, newton_tol=0.01, max_iter=100, max_bisect=60):
    """Per lane, x in [a, b] with f(x) ~= 0 by bisection + secant. ``f`` maps
    a (B,) tensor to a (B,) tensor; ``a`` and ``b`` are (B,) tensors."""
    a0, b0 = a, b
    ya = f(a)
    yb = f(b)

    # precedence as in the reference: a NaN bracket end -> NaN first, then
    # the |y| < tol shortcuts, then same sign -> NaN
    nan_bracket = torch.isnan(ya) | torch.isnan(yb)
    same_sign = torch.sign(ya) == torch.sign(yb)
    hit_a = ya.abs() < newton_tol
    hit_b = yb.abs() < newton_tol

    # the first bisection comes before the loop (the reference's do-while)
    c = (a + b) / 2
    yc = f(c)
    same = torch.sign(yc) == torch.sign(ya)
    a, b = torch.where(same, c, a), torch.where(same, b, c)
    ya, yb = torch.where(same, yc, ya), torch.where(same, yb, yc)
    i = 1
    while i < max_bisect:
        active = ((b - a) / 2 >= bisect_tol) & (yc != 0)
        if not bool(active.any()):
            break
        c2 = (a + b) / 2
        yc2 = f(c2)
        same = torch.sign(yc2) == torch.sign(ya)
        a, b, ya, yb = (
            torch.where(active & same, c2, a), torch.where(active & ~same, c2, b),
            torch.where(active & same, yc2, ya), torch.where(active & ~same, yc2, yb),
        )
        c = torch.where(active, c2, c)
        yc = torch.where(active, yc2, yc)
        i += 1

    # secant seeded at the bisection midpoint
    x0, y0 = c, yc
    x1 = x0 + 0.1
    y1 = f(x1)
    i = 0
    while i < max_iter:
        active = (y1.abs() > newton_tol) & ~torch.isnan(y1)
        if not bool(active.any()):
            break
        # plain division, as the reference: a stalled secant (y1 == y0)
        # gives inf, f(inf) is NaN, and the lane ends as NaN
        newx = (x0 * y1 - x1 * y0) / (y1 - y0)
        newy = f(newx)
        x0, y0 = torch.where(active, x1, x0), torch.where(active, y1, y0)
        x1, y1 = torch.where(active, newx, x1), torch.where(active, newy, y1)
        i += 1
    nan = torch.full_like(x1, float("nan"))
    xf = torch.where(torch.isnan(y1), nan, x1)

    out = torch.where(hit_a, a0, torch.where(hit_b, b0, torch.where(same_sign, nan, xf)))
    return torch.where(nan_bracket, nan, out)


def _solve(grid, vals, los, his, v1s, v2s, icol, bisect_tol, newton_tol, max_iter):
    dt, dev = grid.values.dtype, grid.values.device
    vals, los, his, v1s, v2s = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=dt, device=dev) for x in (vals, los, his, v1s, v2s)))
    shape = vals.shape
    vals, los, his, v1s, v2s = (x.reshape(-1) for x in (vals, los, his, v1s, v2s))

    def f(x):
        pt = torch.stack([v1s, v2s, x], dim=-1)
        return interp_nd(grid.values, grid.knots, pt, icols=(icol,), axis_maps=grid.axis_maps)[..., 0] - vals

    out = _find_closest_fn(f, los, his, bisect_tol=bisect_tol, newton_tol=newton_tol, max_iter=max_iter)
    return out.reshape(shape)


def find_closest_grid(grid: GridData, val, lo, hi, v1, v2, icol, bisect_tol=0.5, newton_tol=0.01, max_iter=100):
    """Solve ``interp(v1, v2, x)[icol] == val`` for x in [lo, hi] on a 3-d
    grid; a 0-d tensor, NaN where the bracket does not hold a root."""
    return _solve(grid, val, lo, hi, v1, v2, icol, bisect_tol, newton_tol, max_iter)


def find_closest_grid_batch(grid: GridData, vals, los, his, v1s, v2s, icol, bisect_tol=0.5, newton_tol=0.01,
                            max_iter=100):
    """Batched :func:`find_closest_grid`: every argument broadcasts to (B,)."""
    return _solve(grid, vals, los, his, v1s, v2s, icol, bisect_tol, newton_tol, max_iter)
