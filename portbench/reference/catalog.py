"""The catalogue posterior and its summary in plain torch and numpy (the
catalogue family's reference).

A single star on the isochrone grid, parameters (EEP, log10 age, [Fe/H],
distance [pc], AV). The likelihood: Teff, logg and [Fe/H] from the grid
against the star's spectroscopy, the magnitudes (Mbol, the distance modulus
and the bolometric corrections at Teff, logg, [Fe/H], AV) against its
photometry, 1000 / distance against its parallax; a missing observation adds
nothing. The priors: flat in age over the grid's ages, the local [Fe/H] prior
over the grid's [Fe/H], flat AV, a distance power law of index 2 up to 2000 /
parallax (10 kpc without one), and the EEP prior, the Chabrier IMF at the
interpolated initial mass times d(initial mass)/dEEP, on the grid's EEPs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import priors as P
from .interp import gauss_lnprob, interp, magnitudes

NEG_INF = float("-inf")


class Posterior:
    """The posterior of every star of a catalogue, from the tables and the
    observations, in the tables' dtype. ``obs`` holds numpy columns
    ``mag_vals``, ``mag_uncs`` (S, B), ``spec_vals``, ``spec_uncs`` (S, 3;
    Teff, logg, feh) and ``plax``, ``plax_unc`` (S,), NaN where missing."""

    def __init__(self, tables, obs, cfg):
        values, knots, columns = tables["iso"]
        self.tables = tables
        self.dtype, self.device = values.dtype, values.device
        self.ci = {c: i for i, c in enumerate(columns)}
        t = {k: torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device) for k, v in obs.items()}
        self.obs = t
        ages, fehs, eeps = knots
        self.age_b = (float(ages[0]), float(ages[-1]))
        self.feh_b = (float(fehs[0]), float(fehs[-1]))
        self.eep_b = (float(eeps[0]), float(eeps[-1]))
        mass = values[..., self.ci["mass"]]
        mass = mass[torch.isfinite(mass)]
        self.imf = P.Chabrier((float(mass.min()), float(mass.max())))  # the IMF on the grid's masses
        pri = cfg["priors"]
        self.halo = pri["feh_halo_fraction"]
        self.av_b = tuple(pri["AV"])
        plax = np.asarray(obs["plax"], dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            d_hi = np.where(plax > 0, 2000.0 / np.maximum(plax, 1e-3), pri["max_distance"])
        self.d_hi = torch.as_tensor(d_hi, dtype=self.dtype, device=self.device)

    def lnlike(self, x, stars):
        """(s, N, 5) parameters of the stars ``stars`` -> ``(ll, initial
        mass, dm/dEEP)``."""
        o = {k: v[stars] for k, v in self.obs.items()}
        values, knots, _ = self.tables["iso"]
        gp = torch.stack([x[..., 1], x[..., 2], x[..., 0]], dim=-1)
        six = interp(values, knots, gp, [self.ci[c] for c in ("Teff", "logg", "feh", "initial_mass", "dm_deep")])
        ll = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for k in range(3):
            v, u = o["spec_vals"][:, None, k], o["spec_uncs"][:, None, k]
            ll = ll + torch.where(torch.isnan(v), 0.0, gauss_lnprob(v, u, six[..., k]))
        mags = magnitudes(self.tables["iso"], self.tables["bc"], x, self.tables["band_cols"])[3]
        mv, mu = o["mag_vals"][:, None, :], o["mag_uncs"][:, None, :]
        ll = ll + torch.where(torch.isnan(mv), 0.0, gauss_lnprob(mv, mu, mags)).sum(-1)
        pv, pu = o["plax"][:, None], o["plax_unc"][:, None]
        ll = ll + torch.where(torch.isnan(pv), 0.0, gauss_lnprob(pv, pu, 1000.0 / x[..., 3]))
        return ll, six[..., 3], six[..., 4]

    def __call__(self, x, stars):
        ll, mass, dm = self.lnlike(x, stars)
        lnp = P.flat_log(x[..., 1], *self.age_b) + P.feh(x[..., 2], self.halo, self.feh_b) + P.flat(x[..., 4],
                                                                                                      *self.av_b)
        d, d_hi = x[..., 3], self.d_hi[stars][:, None]
        lnp_d = math.log(3.0) - 3.0 * torch.log(d_hi) + 2.0 * torch.log(torch.clamp(d, min=1e-300))
        lnp = lnp + torch.where((d > 0) & (d < d_hi), lnp_d, NEG_INF)
        ok = torch.isfinite(mass) & (dm > 0)
        eep_term = self.imf(torch.where(ok, mass, torch.ones_like(mass))) + torch.log(
            torch.clamp(torch.where(ok, dm, torch.ones_like(dm)), min=1e-300))
        eep = x[..., 0]
        eep_term = torch.where(ok & (eep >= self.eep_b[0]) & (eep <= self.eep_b[1]), eep_term, NEG_INF)
        lnp = lnp + eep_term
        ll = torch.where(torch.isnan(ll), NEG_INF, ll)
        return torch.where(torch.isfinite(lnp), lnp + ll, NEG_INF)

    def derived(self, x, columns):
        """(s, N, 5) -> (s, N, len(columns)) grid columns at the draws."""
        values, knots, _ = self.tables["iso"]
        gp = torch.stack([x[..., 1], x[..., 2], x[..., 0]], dim=-1)
        return interp(values, knots, gp, [self.ci[c] for c in columns])


def quantiles(draws, qs):
    """Per-row quantiles of the draws that are not NaN (linear interpolation
    between order statistics) of ``draws`` (s, N): (len(qs), s); a row
    without a draw gives NaN."""
    srt = np.sort(draws, axis=1)  # NaN last
    n = (~np.isnan(draws)).sum(axis=1)
    out = []
    for q in qs:
        pos = q * np.maximum(n - 1, 0)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, np.maximum(n - 1, 0))
        a = np.take_along_axis(srt, lo[:, None], 1)[:, 0]
        b = np.take_along_axis(srt, hi[:, None], 1)[:, 0]
        out.append(np.where(n > 0, a + (pos - lo) * (b - a), np.nan))
    return np.array(out)
