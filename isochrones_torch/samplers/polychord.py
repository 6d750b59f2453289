"""PolyChord-style nested sampling on one device (the slice-sampling
replacement).

Counterpart of ``isochrones_tpu/samplers/polychord.py``. The reference can
fit with the Fortran PolyChord sampler, whose mark against MultiNest is
slice sampling of the constrained prior (Handley, Hobson & Lasenby 2015).
This is a constrained-replacement kernel independent of
:mod:`.nested`'s adaptive random walk, so that the two nested samplers
cross-check each other's evidences and posteriors.

Per replacement: start from a random survivor and make ``n_repeat``
sequential slice moves. Each move draws a direction from the live points'
covariance (whitened: correlated posteriors mix), brackets the slice with a
fixed number of stepping-out doublings, then shrinks the bracket with a fixed
number of rejection steps, masked so that every chain makes the same
likelihood calls. Evidence assembly, chunked termination (dlogz and ESS),
dynamic threads and equal-weight resampling are :func:`.nested.run_nested`'s,
through its ``core=`` hook.
"""

from __future__ import annotations

from typing import Callable

import torch

from .nested import NestedResult, _live_cholesky_family, run_nested

__all__ = ["run_polychord"]

_N_EXPAND = 4  # stepping-out rounds (the bracket at least doubles each round)
_N_SHRINK = 8  # shrinkage rejections per slice move


def _whitening(live_u):
    """Cholesky factor of the live points' covariance (the slice sampler
    takes a larger jitter than the walk kernel)."""
    return _live_cholesky_family(live_u[None], jitter=1e-10)[0]


def _slice_move(lnlike_u, g, x0, lnl_star, L, w0):
    """One batched slice move of K chains, ``(K, d) -> (x, lnl, done,
    mean tries)``. Directions are drawn in whitened space; a chain that finds
    no proposal inside the slice stays put (its start is a survivor, so L >
    L* holds either way)."""
    K, dim = x0.shape
    n = torch.randn((K, dim), generator=g, device=x0.device, dtype=x0.dtype)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    dvec = n @ L.T  # the covariance-whitened direction

    # the initial bracket [t_lo, t_hi] holds x0 at a random place
    u0 = torch.rand(K, generator=g, device=x0.device, dtype=x0.dtype)
    t_lo = -u0 * w0
    t_hi = t_lo + w0

    def masked_lnl(xs):
        # nested sampling explores the unit cube, whose outside has no prior
        # mass: outside counts as outside the slice (a likelihood that stays
        # finite beyond the cube would otherwise let replacements escape the
        # prior volume and bias ln Z low)
        in_cube = ((xs >= 0.0) & (xs <= 1.0)).all(dim=-1)
        lnl = lnlike_u(xs)
        return torch.where(in_cube & ~torch.isnan(lnl), lnl, torch.full_like(lnl, float("-inf")))

    # stepping out: while an end is still inside the slice, push it outward by
    # the current bracket width (doubling the interval, Neal 2003 sec. 4);
    # both ends in one likelihood call of 2K points
    for _ in range(_N_EXPAND):
        xs = torch.cat([x0, x0]) + torch.cat([t_lo, t_hi])[:, None] * torch.cat([dvec, dvec])
        lnl_b = masked_lnl(xs)
        width = t_hi - t_lo
        t_lo = torch.where(lnl_b[:K] > lnl_star, t_lo - width, t_lo)
        t_hi = torch.where(lnl_b[K:] > lnl_star, t_hi + width, t_hi)

    # shrinkage: uniform proposals on the bracket; a rejection shrinks it toward 0
    x_cur = x0
    lnl_cur = torch.full((K,), float("-inf"), dtype=x0.dtype, device=x0.device)
    done = torch.zeros(K, dtype=torch.bool, device=x0.device)
    tries = torch.zeros(K, dtype=x0.dtype, device=x0.device)
    for _ in range(_N_SHRINK):
        t = t_lo + (t_hi - t_lo) * torch.rand(K, generator=g, device=x0.device, dtype=x0.dtype)
        x_t = x0 + t[:, None] * dvec
        lnl_prop = masked_lnl(x_t)
        ok = (lnl_prop > lnl_star) & ~done
        tries = tries + (~done).to(tries.dtype)  # proposals made while running
        x_cur = torch.where(ok[:, None], x_t, x_cur)
        lnl_cur = torch.where(ok, lnl_prop, lnl_cur)
        done = done | ok
        t_lo = torch.where((t < 0) & ~done, t, t_lo)
        t_hi = torch.where((t >= 0) & ~done, t, t_hi)
    # the mean proposals to acceptance: the bracket-to-slice width ratio, in
    # log2; the adaptation aims at ~2 (a bracket ~2x the slice)
    return x_cur, lnl_cur, done, tries.mean()


def _polychord_core(lnlike_u, u, lnl, g, scale, n_live, n_iter, n_chains, n_repeat, n_batch=1):
    """The slice-sampling replacement, with the signature and the carry and
    return contract of :func:`.nested.run_nested`'s ``core=``, which drives
    it. ``n_chains`` is unused (a slice move is one chain, as PolyChord's)."""
    K = n_batch
    dead_u, dead_lnl = [], []
    for _ in range(n_iter):
        neg_vals, worst = torch.topk(-lnl, K)  # the K smallest lnL, ascending
        d_lnl = -neg_vals
        dead_u.append(u[worst])
        dead_lnl.append(d_lnl)
        lnl_star = d_lnl[-1]
        L = _whitening(u)
        order = torch.argsort(lnl)
        pick = order[torch.randint(K, n_live, (K,), generator=g, device=u.device)]
        x, xl = u[pick], lnl[pick]
        t_sum = torch.zeros((), dtype=u.dtype, device=u.device)
        for _ in range(n_repeat):
            x_new, lnl_new, done, mean_tries = _slice_move(lnlike_u, g, x, lnl_star, L, scale)
            x = torch.where(done[:, None], x_new, x)
            xl = torch.where(done, lnl_new, xl)
            t_sum = t_sum + mean_tries
        u = u.index_copy(0, worst, x)
        lnl = lnl.index_copy(0, worst, xl)
        # adapt the bracket width toward ~2 shrink proposals per acceptance
        scale = torch.clamp(scale * torch.exp(0.3 * (2.0 - t_sum / n_repeat)), 1e-4, 20.0)
    return torch.cat(dead_u), torch.cat(dead_lnl), u, lnl, scale


def run_polychord(
    lnpost_u: Callable,
    prior_transform: Callable,
    n_params: int,
    generator: torch.Generator = None,
    n_live: int = 500,
    n_repeat: int = None,
    n_batch: int = 8,
    **kwargs,
) -> NestedResult:
    """PolyChord-style nested sampling: the slice replacement with whitened
    directions, the evidence and posterior conventions of
    :func:`.nested.run_nested` (whose keywords it takes). ``n_repeat``
    defaults to PolyChord's ``num_repeats`` heuristic, ~2 slice moves per
    dimension (Handley et al. 2015, sec. 3.3)."""
    if n_repeat is None:
        n_repeat = max(4, 2 * n_params)
    kwargs.setdefault("n_chains", 1)
    return run_nested(lnpost_u, prior_transform, n_params, generator, n_live=n_live, n_repeat=n_repeat,
                      n_batch=n_batch, core=_polychord_core, **kwargs)
