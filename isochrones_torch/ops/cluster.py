"""Hierarchical-cluster likelihood, plain PyTorch version.

Counterpart of ``isochrones_tpu/ops/cluster.py``: ``calc_lnlike_grid`` builds
the lower-triangular (Nstars, Neep, Neep) binary-mixture plane of one walker
and ``integrate_over_eeps_ln`` takes its max-shifted double trapezoid.
``cluster_lnmarginal`` is the batched entry point over a leading walker
dimension W. It dispatches on the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor the hand-written kernel
(:mod:`isochrones_torch.ops.cluster_cuda`), with no fallback between them.
The plain version is also the kernel's oracle on the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "calc_lnlike_grid",
    "integrate_over_eeps_ln",
    "cluster_lnmarginal_plain",
    "cluster_lnmarginal",
]

#: cells of (stars, Neep, Neep) planes the plain version holds per chunk; it
#: chunks walkers and stars only to bound memory
_PLAIN_CELL_BUDGET = 1 << 25


def _powerlaw_lnpdf(x, alpha, lo, hi):
    """reference priors.py:476-480"""
    a1 = alpha + 1.0
    C = a1 / (hi ** a1 - lo ** a1)
    return torch.log(C) + alpha * torch.log(x)


def calc_lnlike_grid(
    lnlike_prop,  # (Nstars, Neep)
    model_mags,  # (Neep, Nbands)
    masses,  # (Neep,)
    ln_dm_deeps,  # (Neep,)
    mag_values,  # (Nstars, Nbands)
    mag_uncs,  # (Nstars, Nbands)
    alpha,
    gamma,
    fB,
    mass_lo,
    mass_hi,
    q_lo,
    valid=None,  # (Neep,) bool: primary (j) rows with finite model values
    q_jacobian=False,
    valid_k=None,  # (Neep,) bool: secondary (k) rows; defaults to ``valid``
):
    """Lower-triangular (Nstars, Neep, Neep) plane of photometric mixture +
    primary-mass prior + mass-ratio prior + property lnlike at (eep1=j,
    eep2=k), k <= j; -inf outside the mask. See the JAX function for the
    meaning of ``q_jacobian`` and ``valid_k``."""
    n_eep, n_bands = model_mags.shape
    n_stars = mag_values.shape[0]
    assert lnlike_prop.shape == (n_stars, n_eep), "lnlike_prop must be (Nstars, Neep)"
    dt, dev = model_mags.dtype, model_mags.device
    alpha, gamma, fB = (torch.as_tensor(x, dtype=dt, device=dev) for x in (alpha, gamma, fB))

    if valid is None:
        valid = torch.ones(n_eep, dtype=torch.bool, device=dev)
    if valid_k is None:
        valid_k = valid
    either = valid | valid_k
    safe_mags = torch.where(either[:, None], model_mags, torch.zeros_like(model_mags))
    safe_masses = torch.where(either, masses, torch.ones_like(masses))

    flux = 10.0 ** (-0.4 * safe_mags)  # (Neep, Nbands)
    ln_fb = torch.log(fB)
    ln_1mfb = torch.log(1.0 - fB)
    lnlike_phot = torch.zeros((n_stars, n_eep, n_eep), dtype=dt, device=dev)
    for b in range(n_bands):
        tot_mag_binary = -2.5 * torch.log10(flux[:, b][:, None] + flux[:, b][None, :])  # (j, k)
        mag_v = mag_values[:, b][:, None, None]
        mag_u = mag_uncs[:, b][:, None, None]
        resid_b = tot_mag_binary[None] - mag_v
        lnlike_binary = -0.5 * resid_b * resid_b / (mag_u * mag_u)
        resid_s = safe_mags[:, b][None, :, None] - mag_v  # single: primary j only
        lnlike_single = -0.5 * resid_s * resid_s / (mag_u * mag_u)
        lnlike_phot = lnlike_phot + torch.logaddexp(ln_fb + lnlike_binary, ln_1mfb + lnlike_single)

    q = safe_masses[None, :] / safe_masses[:, None]  # (j, k): m_k / m_j
    lnlike_mass = _powerlaw_lnpdf(safe_masses, alpha, mass_lo, mass_hi) + ln_dm_deeps
    lnlike_q = _powerlaw_lnpdf(q, gamma, q_lo, 1.0)
    if q_jacobian:
        lnlike_q = lnlike_q + ln_dm_deeps[None, :] - torch.log(safe_masses)[:, None]

    out = lnlike_phot + lnlike_mass[None, :, None] + lnlike_q[None, :, :] + lnlike_prop[:, :, None]
    tri = torch.ones((n_eep, n_eep), dtype=torch.bool, device=dev).tril()
    mask = (q >= q_lo) & tri & valid[:, None] & valid_k[None, :]
    return torch.where(mask[None], out, float("-inf"))


def integrate_over_eeps_ln(lnlike_grid, eeps):
    """(Nstars,) ln of the double trapezoid over (eep2 then eep1), shifted by
    each star's max so whole planes far below exp-underflow stay finite."""
    m = lnlike_grid.amax(dim=(1, 2))
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    like = torch.exp(lnlike_grid - m_safe[:, None, None])  # -inf -> 0, max -> 1
    n = eeps.shape[0]
    de = eeps[1:] - eeps[:-1]
    # inner trapezoid over k restricted to k+1 <= j
    pair = 0.5 * (like[:, :, :-1] + like[:, :, 1:]) * de[None, None, :]
    ar = torch.arange(n, device=eeps.device)
    kmask = ar[1:][None, :] <= ar[:, None]  # (j, k)
    row = torch.where(kmask[None], pair, torch.zeros_like(pair)).sum(dim=-1)
    integral = (0.5 * (row[:, :-1] + row[:, 1:]) * de[None, :]).sum(dim=-1)
    return m_safe + torch.log(integral)


def cluster_lnmarginal_plain(
    lnlike_prop, model_mags, masses, ln_dm_deeps, eeps, mag_values, mag_uncs,
    alpha, gamma, fB, mass_lo, mass_hi, q_lo, valid=None, q_jacobian=False, valid_k=None,
):
    """(W, S) per-walker, per-star ln marginals: ``integrate_over_eeps_ln(
    calc_lnlike_grid(...))`` for each walker, in chunks of stars."""
    W, S, E = lnlike_prop.shape
    dt, dev = model_mags.dtype, model_mags.device
    alpha, gamma, fB = (torch.as_tensor(x, dtype=dt, device=dev).expand(W) for x in (alpha, gamma, fB))
    if valid is None:
        valid = torch.ones((W, E), dtype=torch.bool, device=dev)
    if valid_k is None:
        valid_k = valid
    chunk = max(1, _PLAIN_CELL_BUDGET // max(E * E, 1))
    out = torch.empty((W, S), dtype=dt, device=dev)
    for w in range(W):
        for s0 in range(0, S, chunk):
            sl = slice(s0, min(S, s0 + chunk))
            grid = calc_lnlike_grid(
                lnlike_prop[w, sl], model_mags[w], masses[w], ln_dm_deeps[w], mag_values[sl],
                mag_uncs[sl], alpha[w], gamma[w], fB[w], mass_lo, mass_hi, q_lo,
                valid=valid[w], q_jacobian=q_jacobian, valid_k=valid_k[w],
            )
            out[w, sl] = integrate_over_eeps_ln(grid, eeps)
    return out


def cluster_lnmarginal(
    lnlike_prop,  # (W, S, E) per-star property lnlike (may hold -inf/nan)
    model_mags,  # (W, E, B) model magnitudes along the EEP ladder
    masses,  # (W, E) primary masses (1.0 where invalid)
    ln_dm_deeps,  # (W, E) ln|dm/deep| (0.0 where invalid)
    eeps,  # (E,) EEP ladder
    mag_values,  # (S, B) observed magnitudes
    mag_uncs,  # (S, B) magnitude uncertainties
    alpha,  # (W,)
    gamma,  # (W,)
    fB,  # (W,)
    mass_lo,
    mass_hi,
    q_lo,
    valid=None,  # (W, E) bool: primary rows
    q_jacobian=False,
    valid_k=None,  # (W, E) bool: secondary rows; defaults to ``valid``
):
    """(W, S) ln marginal likelihoods; -inf where a marginal is zero. CPU
    tensors take :func:`cluster_lnmarginal_plain`, CUDA tensors the kernel."""
    args = (lnlike_prop, model_mags, masses, ln_dm_deeps, eeps, mag_values, mag_uncs,
            alpha, gamma, fB, mass_lo, mass_hi, q_lo)
    kind = lnlike_prop.device.type
    if kind == "cuda":
        from .cluster_cuda import cluster_lnmarginal_cuda

        if valid is None:
            valid = torch.ones(model_mags.shape[:2], dtype=torch.bool, device=model_mags.device)
        return cluster_lnmarginal_cuda(*args, valid, q_jacobian=q_jacobian, valid_k=valid_k)
    if kind == "cpu":
        return cluster_lnmarginal_plain(*args, valid=valid, q_jacobian=q_jacobian, valid_k=valid_k)
    raise ValueError(f"cluster_lnmarginal runs on cpu or cuda tensors, got {kind}")
