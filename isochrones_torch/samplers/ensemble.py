"""Affine-invariant ensemble MCMC on one device.

Counterpart of ``isochrones_tpu/samplers/ensemble.py`` (``run_ensemble``):
Goodman & Weare stretch, differential evolution, DE-snooker and the
Gaussian-KDE move, with ``moves="mixed"`` the reference harness's
KDE/DE/snooker 0.4/0.4/0.2 mixture. The JAX ``lax.scan`` becomes a Python
loop over full-ensemble updates; every random draw comes from one
``torch.Generator`` on the walkers' device. The move of each full update is
drawn once for both half-updates, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["EnsembleState", "run_ensemble", "autocorr_time"]


class EnsembleState(NamedTuple):
    walkers: torch.Tensor  # (n_walkers, n_params)
    ln_prob: torch.Tensor  # (n_walkers,)
    generator: torch.Generator
    n_accept: torch.Tensor  # (n_walkers,) acceptance counts


def _rand(g, shape, like):
    return torch.rand(shape, generator=g, device=like.device, dtype=like.dtype)


def _randint(g, lo, hi, shape, like):
    return torch.randint(lo, hi, shape, generator=g, device=like.device)


def _pick2_distinct(g, n, shape, like):
    """Two distinct indices in [0, n) per element of ``shape``."""
    a = _randint(g, 0, n, shape, like)
    b = _randint(g, 0, n - 1, shape, like)
    return a, b + (b >= a).long()


def _pick3_distinct(g, n, shape, like):
    """Three distinct indices in [0, n) per element of ``shape``."""
    a, b = _pick2_distinct(g, n, shape, like)
    c = _randint(g, 0, n - 2, shape, like)
    c = c + (c >= torch.minimum(a, b)).long()
    c = c + (c >= torch.maximum(a, b)).long()
    return a, b, c


def _mh_accept(g, active, lnp_active, proposal, lnp_prop, ln_factor):
    """Metropolis-Hastings accept/reject with an extra ln proposal factor."""
    lnp_prop = torch.where(torch.isnan(lnp_prop), float("-inf"), lnp_prop)
    ln_ratio = ln_factor + lnp_prop - lnp_active
    accept = torch.log(_rand(g, lnp_active.shape, active)) < ln_ratio
    new_active = torch.where(accept[:, None], proposal, active)
    new_lnp = torch.where(accept, lnp_prop, lnp_active)
    return new_active, new_lnp, accept


def _stretch_half(lnpost_v, active, passive, lnp_active, g, a=2.0):
    """Stretch move of the active half against the passive half."""
    n_act, n_dim = active.shape
    z = ((a - 1.0) * _rand(g, (n_act,), active) + 1.0) ** 2 / a
    partners = passive[_randint(g, 0, passive.shape[0], (n_act,), active)]
    proposal = partners + z[:, None] * (active - partners)
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(g, active, lnp_active, proposal, lnp_prop, (n_dim - 1.0) * torch.log(z))


def _de_half(lnpost_v, active, passive, lnp_active, g, sigma=1e-5):
    """Differential evolution: jump along the difference of two distinct
    complementary walkers, gamma = 2.38/sqrt(2 d) with 10% gamma=1 jumps."""
    n_act, n_dim = active.shape
    i, j = _pick2_distinct(g, passive.shape[0], (n_act,), active)
    diff = passive[i] - passive[j]
    big = _rand(g, (n_act,), active) < 0.1
    g0 = 2.38 / np.sqrt(2.0 * n_dim)
    gamma = torch.where(big, torch.ones_like(lnp_active), torch.full_like(lnp_active, g0))
    eps = torch.randn(active.shape, generator=g, device=active.device, dtype=active.dtype) * sigma
    proposal = active + gamma[:, None] * diff + eps
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(g, active, lnp_active, proposal, lnp_prop, torch.zeros_like(lnp_active))


def _snooker_half(lnpost_v, active, passive, lnp_active, g, gammas=1.7):
    """DE-snooker: jump along the line through a third walker, with the
    |q-z|/|s-z|^(d-1) Jacobian factor."""
    n_act, n_dim = active.shape
    iz, i1, i2 = _pick3_distinct(g, passive.shape[0], (n_act,), active)
    z = passive[iz]
    delta = active - z
    norm = torch.sqrt((delta * delta).sum(dim=-1))
    u = delta / torch.where(norm == 0, torch.ones_like(norm), norm)[:, None]
    proj = ((passive[i1] - passive[i2]) * u).sum(dim=-1)
    proposal = active + gammas * proj[:, None] * u
    norm_q = torch.sqrt(((proposal - z) ** 2).sum(dim=-1))
    # the 1e-300 floors flush to 0 in float32, as in the JAX package
    ln_factor = (n_dim - 1.0) * (
        torch.log(torch.clamp(norm_q, min=1e-300)) - torch.log(torch.clamp(norm, min=1e-300))
    )
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(g, active, lnp_active, proposal, lnp_prop, ln_factor)


def _kde_half(lnpost_v, active, passive, lnp_active, g):
    """Gaussian-KDE move: propose passive[i] + Scott's-rule kernel noise and
    accept with the independence-sampler ratio q(x)/q(x')."""
    n_act, n_dim = active.shape
    n_pas = passive.shape[0]
    mu = passive.mean(dim=0)
    c = passive - mu
    cov = (c.T @ c) / (n_pas - 1)
    h = float(n_pas) ** (-1.0 / (n_dim + 4))  # Scott's rule
    # ridge each axis by a fraction of its own variance (see the JAX move)
    lam = 1e-6 if n_pas > n_dim else 1e-2
    diag = torch.diagonal(cov)
    ridge = lam * diag + 1e-12 * (1.0 + diag.max())
    kcov = (h * h) * (cov + torch.diag(ridge))
    L, info = torch.linalg.cholesky_ex(kcov)
    # a failed factorization is NaN, as jnp.linalg.cholesky returns: every
    # proposal is then rejected
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))

    picks = _randint(g, 0, n_pas, (n_act,), active)
    eps = torch.randn(active.shape, generator=g, device=active.device, dtype=active.dtype)
    proposal = passive[picks] + eps @ L.T

    def ln_kde(x):
        d = x[:, None, :] - passive[None, :, :]  # (n, n_pas, dim)
        y = torch.linalg.solve_triangular(L, d.reshape(-1, n_dim).T, upper=False)
        maha = (y * y).sum(dim=0).reshape(x.shape[0], n_pas)
        return torch.logsumexp(-0.5 * maha, dim=1)

    ln_factor = ln_kde(active) - ln_kde(proposal)
    lnp_prop = lnpost_v(proposal)
    return _mh_accept(g, active, lnp_active, proposal, lnp_prop, ln_factor)


#: mixture weights per ``moves`` mode: (stretch, de, snooker, kde)
_MOVE_WEIGHTS = {
    "stretch": (1.0, 0.0, 0.0, 0.0),
    "de": (0.0, 1.0, 0.0, 0.0),
    "snooker": (0.0, 0.0, 1.0, 0.0),
    "kde": (0.0, 0.0, 0.0, 1.0),
    "mixed": (0.0, 0.4, 0.2, 0.4),  # reference fit.py:110-120: KDE/DE/snooker .4/.4/.2
}


def run_ensemble(
    lnpost_v: Callable,
    walkers0: torch.Tensor,
    generator: torch.Generator,
    n_steps: int,
    thin: int = 1,
    a: float = 2.0,
    moves: str = "stretch",
):
    """Run ``n_steps`` full-ensemble updates.

    lnpost_v : batched log-posterior, (n, n_params) -> (n,)
    walkers0 : (n_walkers, n_params) initial positions (n_walkers even)
    generator : ``torch.Generator`` on the walkers' device; every draw uses it
    moves : "stretch" | "de" | "snooker" | "kde" | "mixed"

    Returns ``(chain (n_steps//thin, n_walkers, n_params), ln_chain
    (n_steps//thin, n_walkers), final EnsembleState)``.
    """
    n_walkers, n_dim = walkers0.shape
    half = n_walkers // 2
    g = generator
    walkers = walkers0
    ln_prob = lnpost_v(walkers0)
    ln_prob = torch.where(torch.isnan(ln_prob), float("-inf"), ln_prob)
    n_accept = torch.zeros(n_walkers, dtype=torch.int64, device=walkers0.device)

    w_moves = _MOVE_WEIGHTS[moves]
    if moves == "mixed" and half <= n_dim + 1:
        # an n_pas-point KDE in n_dim >= n_pas - 1 dimensions is a poor
        # density estimate: small ensembles take the DE/snooker blend
        w_moves = (0.0, 0.6, 0.4, 0.0)
    branches = (
        lambda act, pas, lnp: _stretch_half(lnpost_v, act, pas, lnp, g, a=a),
        lambda act, pas, lnp: _de_half(lnpost_v, act, pas, lnp, g),
        lambda act, pas, lnp: _snooker_half(lnpost_v, act, pas, lnp, g),
        lambda act, pas, lnp: _kde_half(lnpost_v, act, pas, lnp, g),
    )
    if moves == "mixed":
        weights = torch.tensor(w_moves, dtype=torch.float64, device=walkers0.device)
        move_idx = torch.multinomial(weights, max(n_steps, 1), replacement=True, generator=g).tolist()
    else:
        move_idx = [w_moves.index(1.0)] * n_steps

    chain, ln_chain = [], []
    for step in range(n_steps):
        move = branches[move_idx[step]]
        first, second = walkers[:half], walkers[half:]
        new_first, new_lnp1, acc1 = move(first, second, ln_prob[:half])
        new_second, new_lnp2, acc2 = move(second, new_first, ln_prob[half:])
        walkers = torch.cat([new_first, new_second])
        ln_prob = torch.cat([new_lnp1, new_lnp2])
        n_accept = n_accept + torch.cat([acc1, acc2]).long()
        if (step + 1) % thin == 0:
            chain.append(walkers)
            ln_chain.append(ln_prob)

    def _stack(xs, shape):
        return torch.stack(xs) if xs else walkers0.new_empty(shape)

    state = EnsembleState(walkers=walkers, ln_prob=ln_prob, generator=g, n_accept=n_accept)
    return (_stack(chain, (0, n_walkers, n_dim)), _stack(ln_chain, (0, n_walkers)), state)


def autocorr_time(chain) -> np.ndarray:
    """Integrated autocorrelation time per parameter (Sokal window).

    chain : (n_steps, n_walkers, n_params), tensor or array
    """
    x = chain.cpu().numpy() if isinstance(chain, torch.Tensor) else np.asarray(chain)
    n_steps, n_walkers, n_params = x.shape
    taus = np.empty(n_params)
    for p in range(n_params):
        d = x[:, :, p] - x[:, :, p].mean(axis=0, keepdims=True)
        n = 1 << (2 * n_steps - 1).bit_length()
        f = np.fft.rfft(d, n=n, axis=0)
        acf = np.fft.irfft(f * np.conj(f), n=n, axis=0)[:n_steps].mean(axis=1)
        acf /= acf[0] if acf[0] != 0 else 1.0
        tau = 2.0 * np.cumsum(acf) - 1.0
        window = np.arange(len(tau)) < 5.0 * tau
        idx = np.argmin(window) if not window.all() else len(tau) - 1
        taus[p] = tau[max(idx, 1)]
    return taus
