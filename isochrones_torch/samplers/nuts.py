"""No-U-Turn Sampler (NUTS) on one device.

Counterpart of ``isochrones_tpu/samplers/nuts.py``: multinomial NUTS (Hoffman
& Gelman 2014; the multinomial variant of Betancourt 2017) in the iterative
formulation, where a subtree is a loop over leapfrog leaves with a
checkpoint stack of ``max_depth + 1`` states, and the U-turn checks use the
binary-counter bit tricks:

* leaf ``n`` (even) stores a checkpoint at index ``popcount(n)``;
* leaf ``n`` (odd) closes ``trailing_zeros(n + 1)`` subtrees and checks
  U-turns against checkpoint indices ``[popcount(n) - 1 - tz(n + 1) + 1,
  popcount(n) - 1]``.

The JAX package vmaps the transition over chains, whose ``lax.while_loop``s
then run in lockstep. Here the chains are a batch dimension: a Python loop
over leaves advances every chain together, a per-chain mask freezes the
chains whose trajectory has ended (a finished chain's state is never
touched), and each leaf makes one batched value-and-grad call over all
chains, ``torch.autograd.grad(lnp.sum(), z)``, the rows being independent.
On the card that gradient comes from the likelihood kernels' backward kernels
(``ops/star_cuda.py``, ``ops/tree_cuda.py``). Warmup is dual-averaging
step-size adaptation with a diagonal mass matrix from three doubling Welford
windows; every random draw comes from one ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..logger import getLogger

__all__ = ["run_nuts", "NutsResult"]

DIVERGENCE = 1000.0


class NutsResult(NamedTuple):
    samples: np.ndarray  # (n_samples, n_chains, dim)
    lnp: np.ndarray  # (n_samples, n_chains)
    step_size: np.ndarray  # (n_chains,)
    inv_mass: np.ndarray  # (n_chains, dim)
    accept_rate: np.ndarray  # (n_chains,) mean accept statistic of the sampling transitions
    n_divergent: np.ndarray  # (n_chains,)


_LOW32 = 0xFFFFFFFF


def _popcount(n: torch.Tensor) -> torch.Tensor:
    """The number of set bits of the low 32 bits of each entry (int64)."""
    n = n.to(torch.int64) & _LOW32
    c = torch.zeros_like(n)
    for _ in range(32):
        c = c + (n & 1)
        n = n >> 1
    return c


def _trailing_zeros(n: torch.Tensor) -> torch.Tensor:
    """The number of trailing zero bits of the low 32 bits of each entry
    (int64; 32 for 0): popcount((n & -n) - 1) in 32-bit arithmetic."""
    n = n.to(torch.int64) & _LOW32
    return _popcount(((n & (-n)) - 1) & _LOW32)


def _safe_value_and_grad(logp: Callable) -> Callable:
    """``z (C, d) -> (lnp (C,), grad (C, d))`` through one batched call of
    ``logp`` and one ``torch.autograd.grad`` of its sum; a non-finite value
    is -inf with a zero gradient, and a non-finite gradient entry is 0."""

    def fn(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            v = logp(z)
            (g,) = torch.autograd.grad(v.sum(), z)
        v = v.detach()
        bad = ~torch.isfinite(v)
        v = torch.where(bad, torch.full_like(v, float("-inf")), v)
        g = torch.where(torch.isfinite(g) & ~bad[:, None], g, torch.zeros_like(g))
        return v, g

    return fn


def _uturn(dz, r_l, r_r, inv_mass):
    return ((dz * inv_mass * r_l).sum(dim=-1) < 0) | ((dz * inv_mass * r_r).sum(dim=-1) < 0)


def _kinetic(r, inv_mass):
    return 0.5 * (r * inv_mass * r).sum(dim=-1)


def _make_kernel(logp: Callable, max_depth: int, generator: torch.Generator) -> Callable:
    """One NUTS transition of every chain: ``(z, lnp, grad, eps, inv_mass) ->
    (z', lnp', grad', accept_stat, divergent)``, all with a leading chain
    axis."""
    vg = _safe_value_and_grad(logp)
    g = generator
    leaves = torch.arange(1 << max_depth, dtype=torch.int64)
    popcount = _popcount(leaves).tolist()
    n_checks = _trailing_zeros(leaves + 1).tolist()

    def rand(like):
        return torch.rand(like.shape[0], generator=g, device=like.device, dtype=like.dtype)

    def build_subtree(active, z0, r0, g0, eps_signed, inv_mass, h0, n_leaves):
        """The iterative subtree of ``n_leaves`` leaves from (z0, r0) of the
        ``active`` chains (the others are left as they are). Returns (z_end,
        r_end, g_end, z_prop, lnp_prop, g_prop, logw_sub, turning, divergent,
        sum_alpha)."""
        C, d = z0.shape
        z_ck = z0.new_zeros((C, max_depth + 1, d))
        r_ck = z0.new_zeros((C, max_depth + 1, d))
        z, r, gr = z0, r0, g0
        # the init proposal carries weight -inf and can never be selected
        z_p, lnp_p, g_p = z0, torch.full_like(h0, float("-inf")), g0
        logw = torch.full_like(h0, float("-inf"))
        turning = torch.zeros_like(active)
        divergent = torch.zeros_like(active)
        sum_alpha = torch.zeros_like(h0)
        eps = eps_signed[:, None]
        for n in range(n_leaves):
            live = active & ~turning & ~divergent
            if not bool(live.any()):
                break
            lv = live[:, None]
            if n % 2 == 0:  # checkpoint before stepping
                i = popcount[n]
                z_ck[:, i] = torch.where(lv, z, z_ck[:, i])
                r_ck[:, i] = torch.where(lv, r, r_ck[:, i])
            r_half = r + 0.5 * eps * gr
            z_new = z + eps * inv_mass * r_half
            lnp_new, g_new = vg(z_new)
            r_new = r_half + 0.5 * eps * g_new
            e = -lnp_new + _kinetic(r_new, inv_mass)
            logw_leaf = h0 - e  # ln of the multinomial weight
            alpha = torch.clamp(torch.exp(torch.clamp(logw_leaf, max=0.0)), max=1.0)
            sum_alpha = torch.where(live, sum_alpha + torch.nan_to_num(alpha, nan=0.0), sum_alpha)
            # progressive multinomial proposal within the subtree
            logw_new = torch.logaddexp(logw, logw_leaf)
            take = live & (torch.log(rand(h0)) < (logw_leaf - logw_new))
            tk = take[:, None]
            z_p = torch.where(tk, z_new, z_p)
            lnp_p = torch.where(take, lnp_new, lnp_p)
            g_p = torch.where(tk, g_new, g_p)
            logw = torch.where(live, logw_new, logw)
            z = torch.where(lv, z_new, z)
            r = torch.where(lv, r_new, r)
            gr = torch.where(lv, g_new, gr)
            divergent = divergent | (live & ((e - h0) > DIVERGENCE))
            if n % 2 == 1:  # U-turns of every subtree this leaf closes
                i_max = popcount[n] - 1
                turn = torch.zeros_like(active)
                for i in range(i_max - n_checks[n] + 1, i_max + 1):
                    turn = turn | _uturn(z - z_ck[:, i], r_ck[:, i], r, inv_mass)
                turning = turning | (live & turn)
        return z, r, gr, z_p, lnp_p, g_p, logw, turning, divergent, sum_alpha

    def kernel(z, lnp, grad, eps, inv_mass):
        C = z.shape[0]
        r0 = torch.randn(z.shape, generator=g, device=z.device, dtype=z.dtype) / torch.sqrt(inv_mass)
        h0 = -lnp + _kinetic(r0, inv_mass)
        z_m, r_m, g_m = z, r0, grad
        z_pl, r_pl, g_pl = z, r0, grad
        z_prop, lnp_prop, g_prop = z, lnp, grad
        logw = torch.zeros_like(lnp)  # the root leaf's weight exp(h0 - h0) = 1
        turning = torch.zeros(C, dtype=torch.bool, device=z.device)
        divergent = torch.zeros_like(turning)
        sum_alpha = torch.zeros_like(lnp)
        n_leap = torch.zeros_like(lnp)
        for depth in range(max_depth):
            active = ~turning & ~divergent
            if not bool(active.any()):
                break
            fwd = rand(lnp) >= 0.5  # the direction v = +1
            f = fwd[:, None]
            v = torch.where(fwd, 1.0, -1.0).to(z.dtype)
            n_leaves = 1 << depth
            (z_end, r_end, g_end, z_ps, lnp_ps, g_ps, logw_sub, turn_sub, div_sub, sa) = build_subtree(
                active, torch.where(f, z_pl, z_m), torch.where(f, r_pl, r_m), torch.where(f, g_pl, g_m),
                v * eps, inv_mass, h0, n_leaves)
            sum_alpha = torch.where(active, sum_alpha + sa, sum_alpha)
            n_leap = torch.where(active, n_leap + n_leaves, n_leap)
            # the subtree's proposal is merged only if the subtree is valid
            ok = active & ~turn_sub & ~div_sub
            logw_new = torch.logaddexp(logw, logw_sub)
            take = ok & (torch.log(rand(lnp)) < (logw_sub - logw_new))
            tk = take[:, None]
            z_prop = torch.where(tk, z_ps, z_prop)
            lnp_prop = torch.where(take, lnp_ps, lnp_prop)
            g_prop = torch.where(tk, g_ps, g_prop)
            logw = torch.where(ok, logw_new, logw)
            plus = (active & fwd)[:, None]
            minus = (active & ~fwd)[:, None]
            z_pl, r_pl, g_pl = (torch.where(plus, a, b) for a, b in ((z_end, z_pl), (r_end, r_pl), (g_end, g_pl)))
            z_m, r_m, g_m = (torch.where(minus, a, b) for a, b in ((z_end, z_m), (r_end, r_m), (g_end, g_m)))
            # the full trajectory's U-turn (both momenta point outward in time)
            turn = turn_sub | _uturn(z_pl - z_m, r_m, r_pl, inv_mass)
            turning = torch.where(active, turn, turning)
            divergent = torch.where(active, div_sub, divergent)
        # (lnp, grad) of the proposal are carried through the merges
        accept_stat = sum_alpha / torch.clamp(n_leap, min=1.0)
        return z_prop, lnp_prop, g_prop, accept_stat, divergent

    return kernel


def _nuts_run(logp_batch, x0, generator, n_warmup, n_samples, max_depth, target_accept, inv_mass0=None,
              eps_jitter=1.0):
    """Warmup and sampling of ``x0.shape[0]`` chains: ``(chain (n_samples,
    C, d), lnp_chain (n_samples, C), eps (C,), inv_mass (C, d), accept (C,),
    n_divergent (C,))``, tensors."""
    n_chains, dim = x0.shape
    g = generator
    kernel = _make_kernel(logp_batch, max_depth, g)
    lnp0, g0 = _safe_value_and_grad(logp_batch)(x0)

    # warmup: dual averaging and Stan-style doubling mass windows
    gamma, t0, kappa = 0.05, 10.0, 0.75
    # the dual-averaging floor (the JAX package's float32 diagnosis): in
    # reduced precision the accept statistic has a rounding-noise part, so
    # alpha(eps) can sit just below target_accept for every eps below some
    # band, and dual averaging then walks log_eps down until position updates
    # round to zero against |z| ~ 1 (a false equilibrium where the chains
    # freeze while alpha looks healthy). The step size is clamped three
    # decades above the dtype's machine epsilon: in float64 the floor (~2e-13)
    # never engages.
    log_eps_min = math.log(1e3 * torch.finfo(x0.dtype).eps)

    def warm_phase(z, lnp, grad, log_eps0, inv_mass, length, collect):
        """One adaptation phase: dual averaging (restarted), with Welford
        variance collection when ``collect``. Returns the state, the phase's
        averaged log step size and its regularized variance."""
        mu = math.log(10.0) + log_eps0
        log_eps, log_eps_bar = log_eps0, log_eps0
        h_bar = torch.zeros_like(lnp)
        count, mean, m2 = 0.0, torch.zeros_like(x0), torch.zeros_like(x0)
        for i in range(length):
            z, lnp, grad, alpha, _ = kernel(z, lnp, grad, torch.exp(log_eps), inv_mass)
            m = i + 1.0
            eta = 1.0 / (m + t0)
            h_bar = (1 - eta) * h_bar + eta * (target_accept - alpha)
            log_eps = torch.clamp(mu - math.sqrt(m) / gamma * h_bar, min=log_eps_min)
            w = m ** (-kappa)
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
            if collect:
                count += 1.0
                delta = z - mean
                mean = mean + delta / count
                m2 = m2 + delta * (z - mean)
        # Stan-style regularized variance, pooled across chains
        if count > 1.0:
            var = m2.mean(dim=0) / max(count - 1.0, 1.0)
            var = var * (count / (count + 5.0)) + 1e-3 * (5.0 / (count + 5.0))
        else:
            var = torch.ones(dim, dtype=x0.dtype, device=x0.device)
        return z, lnp, grad, log_eps_bar, var.expand(n_chains, dim)

    z, lnp, grad = x0, lnp0, g0
    log_eps = torch.full((n_chains,), math.log(0.1), dtype=x0.dtype, device=x0.device)
    if inv_mass0 is None:
        inv_mass = torch.ones_like(x0)
    else:
        inv_mass = torch.as_tensor(inv_mass0, dtype=x0.dtype, device=x0.device).expand(n_chains, dim)
    # phase lengths: 15% step size only, three doubling mass windows, 10% final
    n1 = max(n_warmup * 15 // 100, 5)
    n_final = max(n_warmup * 10 // 100, 5)
    body = n_warmup - n1 - n_final
    wins = [max(body * 1 // 7, 5), max(body * 2 // 7, 5), max(body * 4 // 7, 5)]
    z, lnp, grad, log_eps, _ = warm_phase(z, lnp, grad, log_eps, inv_mass, n1, False)
    for w_len in wins:
        z, lnp, grad, log_eps, inv_mass = warm_phase(z, lnp, grad, log_eps, inv_mass, w_len, True)
    z, lnp, grad, log_eps, _ = warm_phase(z, lnp, grad, log_eps, inv_mass, n_final, False)
    eps = torch.exp(log_eps)

    # sampling
    chain, lnp_chain = [], []
    acc_sum = torch.zeros_like(lnp)
    div_sum = torch.zeros(n_chains, dtype=torch.int64, device=x0.device)
    for _ in range(n_samples):
        eps_t = eps
        if eps_jitter > 1.0:
            # per-transition log-uniform step-size jitter in [eps / jitter,
            # eps * jitter] (Neal 2011, sec. 3.2), sampling transitions only,
            # so that dual averaging adapted the unjittered centre
            u = 2.0 * torch.rand(n_chains, generator=g, device=x0.device, dtype=x0.dtype) - 1.0
            eps_t = eps * eps_jitter ** u
        z, lnp, grad, alpha, div = kernel(z, lnp, grad, eps_t, inv_mass)
        acc_sum = acc_sum + alpha
        div_sum = div_sum + div.to(torch.int64)
        chain.append(z)
        lnp_chain.append(lnp)
    chain = torch.stack(chain) if chain else x0.new_empty((0, n_chains, dim))
    lnp_chain = torch.stack(lnp_chain) if lnp_chain else x0.new_empty((0, n_chains))
    return chain, lnp_chain, eps, inv_mass, acc_sum / max(n_samples, 1), div_sum


def _warn_frozen(eps: np.ndarray, dtype) -> int:
    """The frozen-sampler guard: a step size at the floating-point resolution
    of the O(1)-scaled run coordinates leaves the positions unmoved, so the
    chain is its start (what a badly scaled metric gives in float32). Warns
    and returns the number of chains whose step size is below ``100 *
    eps(dtype)``. (The dual-averaging floor keeps the adapted step size at
    ``1e3 * eps(dtype)`` or more, so the guard stands behind that floor.)"""
    eps_floor = 100.0 * float(torch.finfo(dtype).eps)
    n_frozen = int(np.sum(np.asarray(eps) < eps_floor))
    if n_frozen:
        getLogger().warning(
            "NUTS: %d/%d chains adapted a step size below the %s resolution floor (%.1e): those chains are "
            "frozen (positions cannot move) and their samples are init-cloud points, not posterior draws. "
            "Check the metric scaling / parameter bounds.", n_frozen, np.asarray(eps).shape[0], str(dtype), eps_floor)
    return n_frozen


def run_nuts(
    logp_batch: Callable,
    x0,
    generator: torch.Generator,
    n_warmup: int = 500,
    n_samples: int = 500,
    max_depth: int = 8,
    target_accept: float = 0.8,
    inv_mass0=None,
    ensemble_init: int = 0,
    n_chains: int = None,
    bounds=None,
    mesh=None,
    eps_jitter: float = 1.0,
) -> NutsResult:
    """Multi-chain NUTS (reference samplers/nuts.py:347-525).

    logp_batch : differentiable (B, dim) tensor -> (B,) log-density
    x0 : (n_chains, dim) initial positions (tensor or array; a tensor's
        device and dtype are the run's) or, with ``ensemble_init``, a larger
        (n_walkers, dim) cloud of independent draws
    generator : ``torch.Generator`` on the device of ``x0``; every draw uses it
    inv_mass0 : optional (dim,) initial diagonal inverse mass (posterior
        variances in parameter space)
    ensemble_init : if > 0, that many affine-invariant ensemble steps over the
        ``x0`` cloud first; the chains start at the best walkers, and a dense
        metric (the Cholesky factor of the posterior-bulk walkers' covariance,
        computed on the host in float64) whitens the coordinates
    bounds : optional (dim, 2) box bounds: sampling then runs in the logit
        reparametrization with its log-Jacobian (the Stan treatment of
        bounded parameters)
    eps_jitter : per-transition log-uniform step-size jitter of the sampling
        transitions (1.0: off)

    ``mesh`` is not ported yet and raises ``NotImplementedError``. Warns when
    a chain adapted a step size below its dtype's resolution floor (a frozen
    chain).
    """
    if mesh is not None:
        raise NotImplementedError(f"run_nuts(mesh={mesh!r}) is not ported yet (ROADMAP queue 1, parallelism)")
    g = generator
    if isinstance(x0, torch.Tensor):
        x0 = x0.detach()
    else:
        x0 = torch.as_tensor(np.asarray(x0), device=g.device)
    dt, dev = x0.dtype, x0.device
    to_z = logjac = None
    if bounds is not None:
        bounds = np.asarray(bounds, dtype=float)
        lo = torch.as_tensor(bounds[:, 0], dtype=dt, device=dev)
        span = torch.as_tensor(bounds[:, 1] - bounds[:, 0], dtype=dt, device=dev)

        def to_z(y):
            return lo + span * torch.sigmoid(y)

        def logjac(y):
            return torch.sum(torch.log(span) + torch.nn.functional.logsigmoid(y)
                             + torch.nn.functional.logsigmoid(-y), dim=-1)

        logp_bounded = logp_batch

        def logp_batch(yb):
            return logp_bounded(to_z(yb)) + logjac(yb)

        p = torch.clamp((x0 - lo) / span, 1e-9, 1.0 - 1e-9)
        x0 = torch.log(p) - torch.log1p(-p)
        if inv_mass0 is not None:
            # inv_mass0 holds parameter-space variances; rescale by the
            # transform's dz/dy = span s (1 - s) at the chain starts' centroid
            y_bar = x0.mean(dim=0)
            dz_dy = span * torch.sigmoid(y_bar) * torch.sigmoid(-y_bar)
            inv_mass0 = torch.as_tensor(inv_mass0, dtype=dt, device=dev) / (dz_dy * dz_dy)
    W = mu = None  # the dense metric's whitening z = mu + W y
    if ensemble_init and inv_mass0 is None:
        from .ensemble import run_ensemble

        n_walkers = x0.shape[0] - (x0.shape[0] % 2)
        n_chains = n_chains or min(8, n_walkers)
        with torch.no_grad():
            _, _, state = run_ensemble(logp_batch, x0[:n_walkers], g, n_steps=int(ensemble_init))
        cloud = state.walkers
        # The dense metric from the burned-in cloud, estimated robustly: after
        # a finite burn from prior-wide starts the cloud still holds stuck
        # walkers (logit-saturated, or stranded at very low lnp) that would
        # inflate the covariance and make the whitened posterior needle-thin,
        # so only the posterior-bulk walkers, lnp >= max - max(2 dim, 10),
        # enter it (the JAX package's round-4 diagnosis). Host-side float64.
        dim = x0.shape[-1]
        cloud_np = cloud.cpu().numpy().astype(np.float64)
        lnp_np = state.ln_prob.cpu().numpy().astype(np.float64)
        finite = np.isfinite(lnp_np)
        bulk = finite & (lnp_np >= lnp_np[finite].max() - max(2.0 * dim, 10.0))
        if bulk.sum() > dim + 2:
            cloud_np = cloud_np[bulk]
        mu_np = cloud_np.mean(axis=0)
        c_np = cloud_np - mu_np
        cov_np = (c_np.T @ c_np) / cloud_np.shape[0]
        cov_np += (1e-10 * np.trace(cov_np) / dim + 1e-30) * np.eye(dim)
        mu = torch.as_tensor(mu_np, dtype=dt, device=dev)
        W = torch.as_tensor(np.linalg.cholesky(cov_np), dtype=dt, device=dev)
        order = torch.argsort(-state.ln_prob)
        x0 = cloud[order[:n_chains]]

    if W is not None:
        logp_z = logp_batch

        def logp_run(y):
            return logp_z(mu[None, :] + y @ W.T)

        x0_run = torch.linalg.solve_triangular(W, (x0 - mu[None, :]).T, upper=False).T
        inv_mass_run = torch.ones(x0.shape[-1], dtype=dt, device=dev)
    else:
        x0_run, logp_run, inv_mass_run = x0, logp_batch, inv_mass0

    chain, lnp_chain, eps, inv_mass, acc, ndiv = _nuts_run(
        logp_run, x0_run, g, int(n_warmup), int(n_samples), int(max_depth), float(target_accept),
        inv_mass0=inv_mass_run, eps_jitter=float(eps_jitter))
    eps_np = eps.cpu().numpy()
    _warn_frozen(eps_np, dt)

    with torch.no_grad():
        if W is not None:
            chain = mu[None, None, :] + torch.einsum("scd,ed->sce", chain, W)
        if to_z is not None:
            # back to parameter space; lnp without the logit Jacobian
            lnp_chain = lnp_chain - logjac(chain)
            chain = to_z(chain)
    return NutsResult(
        samples=chain.cpu().numpy(), lnp=lnp_chain.cpu().numpy(), step_size=eps_np,
        inv_mass=inv_mass.cpu().numpy(), accept_rate=acc.cpu().numpy(), n_divergent=ndiv.cpu().numpy(),
    )
