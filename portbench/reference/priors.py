"""The priors the two configurations use, from their published forms.

Each function maps a tensor to its log-density, -inf outside the prior's
support. Normalizations that have no closed form are integrated here with
``scipy.integrate.quad`` of the density written below, over the bounds the
configuration implies.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.integrate import quad

LN_ROOT_2PI = 0.5 * math.log(2 * math.pi)
NEG_INF = float("-inf")


def _outside(x, lo, hi, ln):
    """-inf where ``x < lo`` or ``x > hi`` (a bound that is None is open)."""
    if lo is not None:
        ln = torch.where(x < lo, NEG_INF, ln)
    if hi is not None:
        ln = torch.where(x > hi, NEG_INF, ln)
    return ln


def flat(x, lo, hi):
    return _outside(x, lo, hi, torch.full_like(x, -math.log(hi - lo)))


def flat_log(x, lo, hi):
    """Flat in ``10**x`` on [lo, hi]."""
    return _outside(x, lo, hi, math.log(math.log(10)) + x * math.log(10) - math.log(10 ** hi - 10 ** lo))


def power_law(x, alpha, lo, hi):
    """``x**alpha`` normalized on [lo, hi]."""
    c = (alpha + 1) / (hi ** (alpha + 1) - lo ** (alpha + 1))
    return _outside(x, lo, hi, math.log(c) + alpha * torch.log(torch.clamp(x, min=1e-300)))


def gaussian(x, mean, sigma):
    z = (x - mean) / sigma
    return -0.5 * z * z - LN_ROOT_2PI - math.log(sigma)


def _feh_pdf(x, halo_fraction, exp):
    """Bensby's local disk (two Gaussians, SDSS) and a halo Gaussian at -1.5."""
    disk = (0.8 / 0.15 * exp(-0.5 * (x - 0.016) ** 2 / 0.15 ** 2)
            + 0.2 / 0.22 * exp(-0.5 * (x + 0.15) ** 2 / 0.22 ** 2)) / 2.5066282746310007
    halo = exp(-0.5 * (x + 1.5) ** 2 / 0.4 ** 2) / (0.4 * math.sqrt(2 * math.pi))
    return halo_fraction * halo + (1 - halo_fraction) * disk


def feh(x, halo_fraction, bounds=None):
    """The [Fe/H] prior; with ``bounds`` it is renormalized on them."""
    norm = 1.0
    if bounds is not None:
        norm = quad(lambda v: _feh_pdf(v, halo_fraction, np.exp), *bounds)[0]
    ln = torch.log(torch.clamp(_feh_pdf(x, halo_fraction, torch.exp), min=1e-300)) - math.log(norm)
    return ln if bounds is None else _outside(x, bounds[0], bounds[1], ln)


class Chabrier:
    """Chabrier (2003) eq. 17: a log-normal (mu = ln 0.079, sigma = 0.69 ln 10)
    below 1 Msun and a Salpeter power law (-2.35 on [1, 100]) above, joined
    continuously at 1 and normalized on ``bounds``."""

    MU, SIGMA, ALPHA, BREAK = math.log(0.079), 0.69 * math.log(10), -2.35, 1.0

    def __init__(self, bounds):
        self.lo, self.hi = bounds
        self._c_pl = (self.ALPHA + 1) / (100.0 ** (self.ALPHA + 1) - 1.0)
        n1 = self._pl(self.BREAK) / self._ln(self.BREAK)
        tot = (quad(self._ln, self.lo, self.BREAK, limit=200)[0]
               + quad(lambda m: self._pl(m) / n1, self.BREAK, self.hi, limit=200)[0])
        self.lognorm = (math.log(tot), math.log(n1 * tot))

    def _ln(self, m):
        y = m / math.exp(self.MU)
        return math.exp(-0.5 * (math.log(y) / self.SIGMA) ** 2) / (math.sqrt(2 * math.pi) * self.SIGMA * y) \
            / math.exp(self.MU) if m > 0 else 0.0

    def _pl(self, m):
        return self._c_pl * m ** self.ALPHA if 1.0 <= m <= 100.0 else 0.0

    def __call__(self, m):
        lg = torch.log(torch.clamp(m / math.exp(self.MU), min=1e-300))
        ln0 = -LN_ROOT_2PI - math.log(self.SIGMA) - lg - 0.5 * (lg / self.SIGMA) ** 2 - self.MU
        ln0 = torch.where(m > 0, ln0, NEG_INF)
        ln1 = _outside(m, 1.0, 100.0, math.log(self._c_pl) + self.ALPHA * torch.log(torch.clamp(m, min=1e-300)))
        ln = torch.where(m < self.BREAK, ln0 - self.lognorm[0], ln1 - self.lognorm[1])
        return _outside(m, self.lo, self.hi, ln)
