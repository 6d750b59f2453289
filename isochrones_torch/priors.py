"""Prior distributions (counterpart of ``isochrones_tpu/priors.py``).

``lnpdf`` works on tensors and includes the bounds mask and normalization
(the JAX package's ``lnpdf_jax``); ``sample`` and ``pdf`` work on numpy.
Constants such as the ``1e-300`` floors are applied in the tensor's dtype,
so in float32 they flush to 0 exactly as JAX's weak typing does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.integrate import quad

__all__ = [
    "Prior",
    "BoundedPrior",
    "GaussianPrior",
    "FlatPrior",
    "FlatLogPrior",
    "PowerLawPrior",
    "FehPrior",
]

ONE_OVER_ROOT_2PI = 1.0 / math.sqrt(2 * math.pi)
LOG_ONE_OVER_ROOT_2PI = math.log(ONE_OVER_ROOT_2PI)
_NEG_INF = float("-inf")


def _norm_bounds(bounds):
    """(lo, hi) with None endpoints as +-inf floats."""
    if bounds is None:
        return None
    lo, hi = bounds
    return (-np.inf if lo is None else float(lo), np.inf if hi is None else float(hi))


def _rng(rng):
    if rng is None or isinstance(rng, (int, np.integer)):
        return np.random.default_rng(rng)
    return rng


class Prior:
    """Base prior: normalized by quadrature of ``_pdf`` over its bounds."""

    def __init__(self, *args, **kwargs):
        self._norm = 1.0

    @property
    def bounds(self):
        return (-np.inf, np.inf) if getattr(self, "_bounds", None) is None else self._bounds

    @bounds.setter
    def bounds(self, new):
        new = _norm_bounds(new)
        self._norm = quad(self._pdf, *new)[0]
        self._bounds = new

    def _pdf(self, x, **kwargs):
        raise NotImplementedError

    def pdf(self, x):
        lo, hi = self.bounds
        x = np.asarray(x, dtype=float)
        return np.where((x < lo) | (x > hi), 0.0, self._pdf(x) / self._norm)

    def lnpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Log-pdf on a tensor, -inf outside the finite bounds."""
        lo, hi = self.bounds
        ln = self._lnpdf(x) - math.log(self._norm)
        inb = torch.ones_like(x, dtype=torch.bool)
        if np.isfinite(lo):
            inb = inb & (x >= lo)
        if np.isfinite(hi):
            inb = inb & (x <= hi)
        return torch.where(inb, ln, _NEG_INF)

    def _lnpdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, n, rng=None):
        raise NotImplementedError


class BoundedPrior(Prior):
    """Prior whose ``_pdf`` is already normalized over its bounds."""

    def __init__(self, bounds=None):
        self._bounds = _norm_bounds(bounds)
        super().__init__()

    @property
    def bounds(self):
        return self._bounds

    @bounds.setter
    def bounds(self, new):
        self._bounds = _norm_bounds(new)
        self._on_bounds_change()

    def _on_bounds_change(self):
        """Hook for subclasses whose normalization depends on the bounds."""

    def pdf(self, x):
        x = np.asarray(x, dtype=float)
        if self.bounds is None:
            return self._pdf(x)
        lo, hi = self.bounds
        return np.where((x < lo) | (x > hi), 0.0, self._pdf(x))

    def lnpdf(self, x: torch.Tensor) -> torch.Tensor:
        ln = self._lnpdf(x)
        if self.bounds is not None:
            lo, hi = self.bounds
            ln = torch.where((x < lo) | (x > hi), _NEG_INF, ln)
        return ln


class GaussianPrior(BoundedPrior):
    """(Truncated) Gaussian (reference priors.py:235-257)."""

    def __init__(self, mean, sigma, bounds=None):
        self.mean = mean
        self.sigma = sigma
        self._bounds = _norm_bounds(bounds)
        self._norm = 1.0
        self._on_bounds_change()

    def _on_bounds_change(self):
        from scipy.stats import norm as _norm, truncnorm

        lo, hi = (-np.inf, np.inf) if self._bounds is None else self._bounds
        if np.isfinite(lo) or np.isfinite(hi):
            a, b = (lo - self.mean) / self.sigma, (hi - self.mean) / self.sigma
            self.distribution = truncnorm(a, b, loc=self.mean, scale=self.sigma)
            self.norm = _norm.cdf(b) - _norm.cdf(a)
            self.lognorm = math.log(self.norm)
        else:
            self.distribution = _norm(self.mean, self.sigma)
            self.norm = 1.0
            self.lognorm = 0.0

    def _pdf(self, x):
        z = (np.asarray(x) - self.mean) / self.sigma
        return np.exp(-(z ** 2) / 2) * ONE_OVER_ROOT_2PI / self.sigma / self.norm

    def _lnpdf(self, x):
        z = (x - self.mean) / self.sigma
        return -(z ** 2) / 2 + LOG_ONE_OVER_ROOT_2PI - math.log(self.sigma) - self.lognorm

    def sample(self, n, rng=None):
        return self.distribution.rvs(n, random_state=_rng(rng))


class FlatPrior(BoundedPrior):
    """reference priors.py:283-293"""

    def __init__(self, bounds):
        super().__init__(bounds=bounds)

    def _pdf(self, x):
        lo, hi = self.bounds
        return np.ones_like(np.asarray(x, dtype=float)) / (hi - lo)

    def _lnpdf(self, x):
        lo, hi = self.bounds
        return torch.full_like(x, -math.log(hi - lo))

    def sample(self, n, rng=None):
        lo, hi = self.bounds
        return _rng(rng).random(n) * (hi - lo) + lo


class FlatLogPrior(BoundedPrior):
    """Flat in 10**x (reference priors.py:296-306)."""

    def __init__(self, bounds):
        super().__init__(bounds=bounds)

    def _pdf(self, x):
        lo, hi = self.bounds
        return np.log(10) * 10 ** np.asarray(x) / (10 ** hi - 10 ** lo)

    def _lnpdf(self, x):
        lo, hi = self.bounds
        return math.log(math.log(10)) + x * math.log(10) - math.log(10 ** hi - 10 ** lo)

    def sample(self, n, rng=None):
        lo, hi = self.bounds
        return np.log10(_rng(rng).random(n) * (10 ** hi - 10 ** lo) + 10 ** lo)


class PowerLawPrior(BoundedPrior):
    """x**alpha on [lo, hi] with inverse-CDF sampling (reference priors.py:309-342)."""

    def __init__(self, alpha, bounds=None):
        self.alpha = alpha
        super().__init__(bounds=bounds)

    def _C(self):
        lo, hi = self.bounds
        return (1 + self.alpha) / (hi ** (1 + self.alpha) - lo ** (1 + self.alpha))

    def _pdf(self, x):
        return self._C() * np.asarray(x) ** self.alpha

    def _lnpdf(self, x):
        return math.log(self._C()) + self.alpha * torch.log(torch.clamp(x, min=1e-300))

    def sample(self, n, rng=None):
        lo, hi = self.bounds
        C = self._C()
        u = _rng(rng).random(n)
        a = self.alpha
        return ((a + 1) * (u / C + (lo ** (a + 1) / (a + 1)))) ** (1 / (a + 1))


class FehPrior(Prior):
    """Local SDSS disk 2-Gaussian mixture + halo Gaussian (reference priors.py:345-406)."""

    def __init__(self, halo_fraction=0.001, local=True, **kwargs):
        self.halo_fraction = halo_fraction
        self.local = local
        super().__init__(**kwargs)

    def _disk(self, feh, xp=np):
        if self.local:
            disk_norm = 2.5066282746310007  # integral of the unnormalized form
            return (
                1.0
                / disk_norm
                * (
                    0.8 / 0.15 * xp.exp(-0.5 * (feh - 0.016) ** 2 / 0.15 ** 2)
                    + 0.2 / 0.22 * xp.exp(-0.5 * (feh + 0.15) ** 2 / 0.22 ** 2)
                )
            )
        mu, sig = -0.3, 0.3
        return ONE_OVER_ROOT_2PI / sig * xp.exp(-0.5 * (feh - mu) ** 2 / sig ** 2)

    def _halo(self, feh, xp=np):
        mu, sig = -1.5, 0.4
        return ONE_OVER_ROOT_2PI / sig * xp.exp(-0.5 * (feh - mu) ** 2 / sig ** 2)

    def _pdf(self, x):
        return self.halo_fraction * self._halo(x) + (1 - self.halo_fraction) * self._disk(x)

    def lnpdf(self, x: torch.Tensor) -> torch.Tensor:
        pdf = self.halo_fraction * self._halo(x, torch) + (1 - self.halo_fraction) * self._disk(x, torch)
        ln = torch.log(torch.clamp(pdf, min=1e-300)) - math.log(self._norm)
        lo, hi = self.bounds
        if np.isfinite(lo):
            ln = torch.where(x < lo, _NEG_INF, ln)
        if np.isfinite(hi):
            ln = torch.where(x > hi, _NEG_INF, ln)
        return ln

    def sample(self, n, rng=None):
        r = _rng(rng)
        if self.local:
            w2, mu1, sig1, mu2, sig2 = 0.2, 0.016, 0.15, -0.15, 0.22
        else:
            w2, mu1, sig1, mu2, sig2 = 0.0, -0.3, 0.3, 0.0, 1.0
        x = r.standard_normal(n) * sig1 + mu1
        x2 = r.standard_normal(n) * sig2 + mu2
        m1 = r.random(n) < w2
        x[m1] = x2[m1]
        xhalo = r.standard_normal(n) * 0.4 - 1.5
        m2 = r.random(n) < self.halo_fraction
        x[m2] = xhalo[m2]
        if getattr(self, "_bounds", None) is not None and np.isfinite(self.bounds).all():
            lo, hi = self.bounds
            oob = (x < lo) | (x > hi)
            while oob.any():
                x[oob] = self.sample(int(oob.sum()), rng=r)
                oob = (x < lo) | (x > hi)
        return x
