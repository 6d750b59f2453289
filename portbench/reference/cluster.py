"""The hierarchical cluster posterior in plain torch (the cluster family's
reference).

Seven parameters (log10 age, [Fe/H], distance [pc], AV, alpha, gamma, fB).
Each member star is marginalized over the plane of its primary and secondary
EEP on a fixed ladder: a binary-fraction mixture of the single and the
unresolved-binary photometry, a power-law(alpha) primary-mass prior with the
|dm/dEEP| Jacobian, a power-law(gamma) mass-ratio prior on q >= minq, and the
member's property terms, integrated by a double trapezoid over (EEP2 <= EEP1)
after a shift by the plane's maximum. The likelihood is the sum of the
members' marginals, -inf when any member has none; the posterior adds the
configuration's priors. Everything is computed here from the tables and the
members' observations, in the tables' dtype, in blocks of walkers.
"""

from __future__ import annotations

import math

import torch

from . import priors as P
from .interp import interp, magnitudes

NEG_INF = float("-inf")


def lnprior(p, cfg):
    """(W, 7) -> (W,): the sum of the seven priors of the configuration."""
    pri = cfg["priors"]
    age, feh, dist, av, alpha, gamma, fb = p.unbind(-1)
    return (P.flat_log(age, *pri["age"]) + P.feh(feh, pri["feh_halo_fraction"]) + P.flat(av, *pri["AV"])
            + P.power_law(dist, 2.0, *pri["distance"]) + P.flat(alpha, *pri["alpha"])
            + P.gaussian(gamma, *pri["gamma"]) + P.flat(fb, *pri["fB"]))


def ladder(cfg, dtype, device):
    lo, hi = cfg["model"]["eep_bounds"]
    step = float(cfg["model"]["eep_step"])
    n = int(math.floor((hi - lo) / step + 1e-9)) + 1
    return lo + step * torch.arange(n, dtype=dtype, device=device)


def ladder_rows(p, tables, cfg):
    """The ladder's rows at walkers ``p`` (W, 7): ``(masses, ln|dm/dEEP|,
    mags (W, E, B), finite (W, E), valid (W, E))`` where ``finite`` marks rows
    with every interpolated value finite and ``valid`` those whose mass also
    lies in the configuration's mass box."""
    values, knots, columns = tables["iso"]
    ci = {c: i for i, c in enumerate(columns)}
    eeps = ladder(cfg, p.dtype, p.device)
    W, E = p.shape[0], eeps.shape[0]
    age, feh, dist, av = (p[:, i, None].expand(W, E) for i in range(4))
    e = eeps.expand(W, E)
    mv = interp(values, knots, torch.stack([age, feh, e], dim=-1), [ci["initial_mass"], ci["dm_deep"]])
    masses, ln_dm = mv[..., 0], torch.log(torch.abs(mv[..., 1]))
    mags = magnitudes(tables["iso"], tables["bc"], torch.stack([e, age, feh, dist, av], dim=-1),
                      tables["band_cols"])[3]
    finite = torch.isfinite(masses) & torch.isfinite(ln_dm) & torch.isfinite(mags).all(dim=-1)
    lo, hi = cfg["model"]["mass_bounds"]
    return masses, ln_dm, mags, finite, finite & (masses >= lo) & (masses <= hi)


def _plane_marginals(lnprop, mags, masses, ln_dm, finite, valid, eeps, mag_v, mag_u, alpha, gamma, fb, cfg):
    """(w, S) marginals of a block of walkers from their ladder rows."""
    lo, hi = cfg["model"]["mass_bounds"]
    qlo = cfg["model"]["minq"]
    safe_mags = torch.where(finite[..., None], mags, torch.zeros_like(mags))
    m = torch.where(finite, masses, torch.ones_like(masses))
    flux = 10.0 ** (-0.4 * safe_mags)  # (w, E, B)
    ln_fb, ln_1mfb = torch.log(fb)[:, None, None, None], torch.log(1.0 - fb)[:, None, None, None]
    phot = 0.0
    for b in range(mags.shape[-1]):
        tot = -2.5 * torch.log10(flux[:, :, None, b] + flux[:, None, :, b])  # (w, j, k)
        v, u = mag_v[None, :, b, None, None], mag_u[None, :, b, None, None]  # (1, S, 1, 1)
        binary = -0.5 * (tot[:, None] - v) ** 2 / (u * u)
        single = -0.5 * (safe_mags[:, None, :, None, b] - v) ** 2 / (u * u)
        phot = phot + torch.logaddexp(ln_fb + binary, ln_1mfb + single)
    a1 = alpha + 1.0
    ln_mass = torch.log(a1 / (hi ** a1 - lo ** a1))[:, None] + alpha[:, None] * torch.log(m) + \
        torch.where(finite, ln_dm, torch.zeros_like(ln_dm))  # (w, j)
    q = m[:, None, :] / m[:, :, None]  # (w, j, k) = m_k / m_j
    g1 = gamma + 1.0
    ln_q = torch.log(g1 / (1.0 - qlo ** g1))[:, None, None] + gamma[:, None, None] * torch.log(q)
    plane = phot + (ln_mass[:, :, None] + ln_q)[:, None] + lnprop[..., None]
    E = eeps.shape[0]
    tri = torch.ones((E, E), dtype=torch.bool, device=eeps.device).tril()
    keep = (q >= qlo) & tri & valid[:, :, None] & finite[:, None, :]
    plane = torch.where(keep[:, None], plane, NEG_INF)
    top = plane.amax(dim=(-2, -1))
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    like = torch.exp(plane - top[..., None, None])
    de = eeps[1:] - eeps[:-1]
    inner = 0.5 * (like[..., :-1] + like[..., 1:]) * de  # (w, S, j, k') for k' + 1 <= j
    ar = torch.arange(E, device=eeps.device)
    rows = torch.where(ar[1:][None, :] <= ar[:, None], inner, torch.zeros_like(inner)).sum(-1)
    integral = (0.5 * (rows[..., :-1] + rows[..., 1:]) * de).sum(-1)
    return top + torch.log(integral)


def lnpost(p, tables, stars, cfg, cells=1 << 26):
    """(W, 7) walkers -> (W,) log-posteriors, in the dtype of ``p`` and the
    tables. ``stars`` holds the members' ``mag_vals``, ``mag_uncs`` (S, B)
    and ``plax``, ``plax_unc`` (S,); ``cells`` bounds the plane cells held at
    once."""
    eeps = ladder(cfg, p.dtype, p.device)
    S, E = stars["mag_vals"].shape[0], eeps.shape[0]
    block = max(1, cells // (S * E * E))
    out = []
    for w0 in range(0, p.shape[0], block):
        pb = p[w0:w0 + block]
        masses, ln_dm, mags, finite, valid = ladder_rows(pb, tables, cfg)
        z = (stars["plax"][None, :] - 1000.0 / pb[:, 2, None]) / stars["plax_unc"][None, :]
        lnprop = torch.nan_to_num(-0.5 * z * z, nan=NEG_INF)[..., None].expand(-1, -1, E)  # (w, S, E)
        marg = _plane_marginals(lnprop, mags, masses, ln_dm, finite, valid, eeps, stars["mag_vals"],
                                stars["mag_uncs"], pb[:, 4], pb[:, 5], pb[:, 6], cfg)
        ll = torch.where(torch.isfinite(marg).all(-1), torch.where(torch.isfinite(marg), marg, 0.0).sum(-1),
                         NEG_INF)
        lp = lnprior(pb, cfg)
        ll = torch.where(torch.isnan(ll), NEG_INF, ll)
        out.append(torch.where(torch.isfinite(lp), lp + ll, NEG_INF))
    return torch.cat(out)
