"""Prior distributions (counterpart of ``isochrones_tpu/priors.py``).

``lnpdf`` works on tensors and includes the bounds mask and normalization
(the JAX package's ``lnpdf_jax``); ``sample``, ``pdf`` and calling a prior
work on numpy. Setting ``bounds`` renormalizes and runs ``test_integral``,
raising ``ValueError`` if the pdf no longer integrates to one.
Constants such as the ``1e-300`` floors are applied in the tensor's dtype,
so in float32 they flush to 0 exactly as JAX's weak typing does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.integrate import quad

from .ops.interp import interp_nd

__all__ = [
    "Prior",
    "BoundedPrior",
    "BrokenPrior",
    "GaussianPrior",
    "LogNormalPrior",
    "FlatPrior",
    "FlatLogPrior",
    "PowerLawPrior",
    "FehPrior",
    "EEP_prior",
    "AgePrior",
    "DistancePrior",
    "AVPrior",
    "QPrior",
    "SalpeterPrior",
    "ChabrierPrior",
    "powerlaw_pdf",
    "powerlaw_lnpdf",
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


def powerlaw_pdf(x, alpha, lo, hi):
    """Power-law pdf ``C x**alpha`` normalized on [lo, hi], with no bounds
    mask (reference priors.py:469-473); numpy arrays or tensors."""
    a1 = alpha + 1.0
    C = a1 / (hi ** a1 - lo ** a1)
    return C * x ** alpha


def powerlaw_lnpdf(x, alpha, lo, hi):
    """Its logarithm on tensors (reference priors.py:476-480)."""
    a1 = alpha + 1.0
    C = a1 / (hi ** a1 - lo ** a1)
    return math.log(C) + alpha * torch.log(torch.as_tensor(x))


def _rng(rng):
    if rng is None or isinstance(rng, (int, np.integer)):
        return np.random.default_rng(rng)
    return rng


class Prior:
    """Base prior: normalized by quadrature of ``_pdf`` over its bounds."""

    def __init__(self, *args, **kwargs):
        self._norm = 1.0

    def __call__(self, x, **kwargs):
        return self.pdf(x, **kwargs)

    @property
    def bounds(self):
        return (-np.inf, np.inf) if getattr(self, "_bounds", None) is None else self._bounds

    @bounds.setter
    def bounds(self, new):
        new = _norm_bounds(new)
        self._norm = quad(self._pdf, *new)[0]
        self._bounds = new
        try:
            self.test_integral()
        except AssertionError:
            raise ValueError(f"Problem setting bounds to {new}; integral test failed.")

    def _pdf(self, x, **kwargs):
        raise NotImplementedError

    def pdf(self, x, **kwargs):
        lo, hi = self.bounds
        if np.ndim(x) == 0:
            if x < lo or x > hi:
                return 0.0
            return self._pdf(x, **kwargs) / self._norm
        x = np.asarray(x)
        return np.where((x < lo) | (x > hi), 0.0, self._pdf(x, **kwargs) / self._norm)

    def lnpdf(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """Log-pdf on a tensor, -inf outside the finite bounds; ``kwargs`` go
        to ``_lnpdf``, as in the JAX package."""
        lo, hi = self.bounds
        ln = self._lnpdf(x, **kwargs) - math.log(self._norm)
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

    def test_integral(self):
        lo, hi = self.bounds
        assert np.isclose(1, quad(self.pdf, lo, hi)[0])

    def test_sampling(self, n=100000, plot=False, rng=None):
        """Histogram of ``n`` draws against the pdf's bin averages: the
        populated bins (more than 50 draws) must lie within 6 sigma
        (reference priors.py:77-104). ``plot`` draws both with matplotlib,
        imported only then."""
        x = self.sample(n, rng=rng)
        rng_ = None if not np.isfinite(self.bounds).all() else self.bounds
        hn, _ = np.histogram(x, range=rng_)
        h, b = np.histogram(x, density=True, range=rng_)
        pdf = np.array([quad(self.pdf, lo, hi)[0] / (hi - lo) for lo, hi in zip(b[:-1], b[1:])])
        if plot:
            import matplotlib.pyplot as plt

            centers = 0.5 * (b[:-1] + b[1:])
            plt.plot(centers, h, drawstyle="steps-mid")
            plt.plot(centers, pdf)
        mask = hn > 50
        sigma = np.full(hn.shape, np.inf)
        sigma[mask] = 1.0 / np.sqrt(hn[mask])
        resid = np.absolute(pdf - h) / pdf
        assert max((resid / sigma)[mask]) < 6


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
        try:
            self.test_integral()
        except AssertionError:
            raise ValueError(f"Problem setting bounds to {new}; integral test failed.")

    def _on_bounds_change(self):
        """Hook for subclasses whose normalization depends on the bounds."""

    def pdf(self, x, **kwargs):
        if self.bounds is not None:
            lo, hi = self.bounds
            if np.ndim(x) == 0:
                if x < lo or x > hi:
                    return 0.0
            else:
                return np.where((np.asarray(x) < lo) | (np.asarray(x) > hi), 0.0, self._pdf(x, **kwargs))
        return self._pdf(x, **kwargs)

    def lnpdf(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        ln = self._lnpdf(x, **kwargs)
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


class LogNormalPrior(Prior):
    """reference priors.py:260-280"""

    def __init__(self, mu, sigma, bounds=None):
        from scipy.stats import lognorm

        self.mu = mu
        self.sigma = sigma
        self.scale = math.exp(mu)
        self.log_s = math.log(sigma)
        self.distribution = lognorm(sigma, scale=self.scale)
        self._bounds = (0, np.inf)
        super().__init__()

    def _pdf(self, x):
        s = self.sigma
        y = np.asarray(x) / self.scale
        return ONE_OVER_ROOT_2PI / (s * y) * np.exp(-0.5 * (np.log(y) / s) ** 2) / self.scale

    def _lnpdf(self, x):
        s = self.sigma
        y = x / self.scale
        safe = torch.clamp(y, min=1e-300)
        ln = LOG_ONE_OVER_ROOT_2PI - (self.log_s + torch.log(safe)) - 0.5 * (torch.log(safe) / s) ** 2 - self.mu
        return torch.where(y > 0, ln, _NEG_INF)

    def sample(self, n, rng=None):
        return self.distribution.rvs(n, random_state=_rng(rng))


class BrokenPrior(Prior):
    """Stitched multi-component prior with continuity norms (reference
    priors.py:143-232)."""

    def __init__(self, components, breakpoints, bounds=None):
        self.components = components
        self.n_components = len(components)
        self.breakpoints = list(breakpoints)
        nb = _norm_bounds(bounds)
        self._bounds = nb if nb is not None else (-np.inf, np.inf)
        self._norm = 1.0
        self.quad_args = dict(limit=200)
        self._initialize()

    @property
    def bounds(self):
        return self._bounds

    @bounds.setter
    def bounds(self, new):
        self._bounds = _norm_bounds(new)
        self._initialize()

    def _initialize(self):
        lo, hi = self.bounds
        full_domain = [lo] + list(self.breakpoints) + [hi]
        self.domains = list(zip(full_domain[:-1], full_domain[1:]))

        # continuity at each breakpoint chains through the previous norm
        norms = np.ones(self.n_components)
        for i in range(1, self.n_components):
            x = self.breakpoints[i - 1]
            norms[i] = norms[i - 1] * self.components[i](x) / self.components[i - 1](x)

        tot = 0.0
        for comp, (a, b), norm in zip(self.components, self.domains, norms):
            tot += quad(lambda x: comp(x) / norm, a, b, **self.quad_args)[0]

        self.norms = norms * tot
        self.lognorms = np.log(self.norms)

        cumnorm = np.zeros(self.n_components)
        for i, (comp, (a, b), norm) in enumerate(zip(self.components, self.domains, self.norms)):
            cumnorm[i] = quad(lambda x: comp(x) / norm, a, b, **self.quad_args)[0]
        self.cumnorm = cumnorm

    def _pdf(self, x):
        i = np.digitize(x, self.breakpoints)
        if np.ndim(x) == 0:
            return self.components[int(i)](x) / self.norms[int(i)]
        out = np.empty_like(np.asarray(x, dtype=float))
        for k in range(self.n_components):
            m = i == k
            out[m] = self.components[k](np.asarray(x)[m]) / self.norms[k]
        return out

    def lnpdf(self, x: torch.Tensor) -> torch.Tensor:
        # every component evaluated, then selected by the digitize index
        # (the count of breakpoints not above x; NaN counts them all, as
        # jnp.digitize does)
        idx = sum((~(x < b)).to(torch.int64) for b in self.breakpoints)
        ln = self.components[0].lnpdf(x) - self.lognorms[0]
        for k in range(1, self.n_components):
            ln = torch.where(idx == k, self.components[k].lnpdf(x) - self.lognorms[k], ln)
        lo, hi = self.bounds
        if np.isfinite(lo):
            ln = torch.where(x < lo, _NEG_INF, ln)
        if np.isfinite(hi):
            ln = torch.where(x > hi, _NEG_INF, ln)
        return ln

    def sample(self, n, rng=None):
        r = _rng(rng)
        u = r.random(n)
        x = np.zeros(n)
        filled = np.zeros(n, dtype=bool)
        u_cumthresh = 0.0
        for comp, u_thresh, (a, b) in zip(self.components, self.cumnorm, self.domains):
            u_cumthresh += u_thresh
            mask = (u < u_cumthresh) & ~filled
            n_comp = int(mask.sum())
            if n_comp == 0:
                continue
            samples = comp.sample(n_comp, rng=r)
            oob = (samples < a) | (samples > b)
            while oob.sum():
                samples[oob] = comp.sample(int(oob.sum()), rng=r)
                oob = (samples < a) | (samples > b)
            x[mask] = samples
            filled |= mask
        return x


def eep_change_of_variables(orig_prior, orig_val, deriv):
    """ln(orig_prior(orig_val) * deriv), the EEP prior's change of variables
    from the interpolated original quantity and its d/dEEP derivative; -inf
    where ``orig_val`` is not finite or ``deriv`` is not positive. Those
    entries enter the prior and the log detached (double-where), so that their
    masked branch passes no NaN gradient: ``log(0)`` of a float32 ``deriv``
    (whose 1e-300 floor rounds to 0) would otherwise."""
    ok = torch.isfinite(orig_val) & (deriv > 0)
    ov = torch.where(ok, orig_val, orig_val.detach())
    dv = torch.where(ok, deriv, torch.ones_like(deriv))
    ln = orig_prior.lnpdf(ov) + torch.log(torch.clamp(dv, min=1e-300))
    return torch.where(ok, ln, _NEG_INF)


class EEP_prior(BoundedPrior):
    """Change-of-variables prior on EEP: p(eep) = p_orig(orig(eep)) |d orig/d
    eep| from the grid's dm_deep/dt_deep derivative column (reference
    priors.py:409-465). ``lnpdf`` takes the conditioning (``age`` and ``feh``,
    or ``mass`` and ``feh``) as tensors of the eep tensor's shape."""

    def __init__(self, ic, orig_prior, bounds=None):
        self.ic = ic
        self.orig_prior = orig_prior
        self._bounds = bounds if bounds is not None else ic.eep_bounds
        self._norm = 1.0
        self.orig_par = ic.eep_replaces
        if self.orig_par == "age":
            self.deriv_prop = "dt_deep"
        elif self.orig_par == "mass":
            self.deriv_prop = "dm_deep"
        else:
            raise ValueError(f"eep_replaces must be 'age' or 'mass', got {self.orig_par}")
        self._orig_col = self.orig_par if self.orig_par != "mass" else "initial_mass"
        ci = self.ic.model.column_index
        self._icol_orig = ci[self._orig_col]
        self._icol_deriv = ci[self.deriv_prop]

    def _pars(self, eep, **kwargs):
        if self.orig_par == "age":
            return [kwargs["mass"], eep, kwargs["feh"]]
        return [eep, kwargs["age"], kwargs["feh"]]

    def _pdf(self, eep, **kwargs):
        vals = self.ic.interp_value(self._pars(eep, **kwargs), [self._orig_col, self.deriv_prop])
        orig_val, dx_deep = np.asarray(vals).squeeze()
        return self.orig_prior(orig_val) * dx_deep

    def lnpdf(self, eep: torch.Tensor, **kwargs) -> torch.Tensor:
        pts = self._pars(eep, **kwargs)
        io = self.ic._param_index_order
        grid_pts = torch.stack([pts[io[0]], pts[io[1]], pts[io[2]]], dim=-1)
        model = self.ic.model
        vals = interp_nd(model.values, model.knots, grid_pts, icols=(self._icol_orig, self._icol_deriv),
                         axis_maps=model.axis_maps)
        ln = eep_change_of_variables(self.orig_prior, vals[..., 0], vals[..., 1])
        lo, hi = self.bounds
        return torch.where((eep < lo) | (eep > hi), _NEG_INF, ln)

    def _ladder_weights(self, eeps, c0, c1):
        """Unnormalized p(eep | conditioning) on ladder proposals: the
        change-of-variables weight orig_prior(orig(eep)) * |d orig/d eep|."""
        if self.orig_par == "age":
            vals = np.asarray(self.ic.interp_value([c0, eeps, c1], ["dt_deep", "age"]))
        else:
            vals = np.asarray(self.ic.interp_value([eeps, c0, c1], ["dm_deep", "initial_mass"]))
        deriv_val, orig_val = vals[..., 0], vals[..., 1]
        finite = np.isfinite(orig_val)
        safe = np.where(finite, orig_val, 1.0)  # placeholder; masked below
        orig_pr = np.nan_to_num(np.asarray(self.orig_prior.pdf(safe)), nan=0.0)
        return np.where(finite & np.isfinite(deriv_val) & (deriv_val > 0), orig_pr * deriv_val, 0.0)

    def sample(self, n, rng=None, max_tries=100, **kwargs):
        """Weighted resampling over the integer EEP ladder (reference
        priors.py:431-462); with per-row conditioning each row draws from
        its own conditional by importance resampling of 32 proposals."""
        r = _rng(rng)
        lo, hi = self.bounds
        names = ("mass", "feh") if self.orig_par == "age" else ("age", "feh")
        cond = [np.asarray(kwargs[k], dtype=float) for k in names]
        vector = any(np.ndim(c) > 0 and np.unique(c).size > 1 for c in cond)

        if not vector:
            c0 = np.broadcast_to(cond[0], (n,))
            c1 = np.broadcast_to(cond[1], (n,))
            for _ in range(max_tries):
                eeps = r.integers(int(lo), int(hi) + 1, n).astype(float)
                weights = self._ladder_weights(eeps, c0, c1)
                tot = weights.sum()
                if tot > 0:
                    idx = r.choice(n, size=n, replace=True, p=weights / tot)
                    return eeps[idx]
            raise ValueError(
                f"EEP_prior.sample: no ladder point in {self.bounds} has "
                f"support for conditioning {dict(zip(names, cond))}"
            )

        M = 32  # proposals per row
        c0 = np.broadcast_to(cond[0], (n,)).astype(float)
        c1 = np.broadcast_to(cond[1], (n,)).astype(float)
        out = np.full(n, np.nan)
        need = np.ones(n, dtype=bool)
        for _ in range(max_tries):
            m = int(need.sum())
            if m == 0:
                break
            props = r.integers(int(lo), int(hi) + 1, (m, M)).astype(float)
            w = self._ladder_weights(props.ravel(), np.repeat(c0[need], M), np.repeat(c1[need], M)).reshape(m, M)
            tot = w.sum(axis=1)
            ok = tot > 0
            if ok.any():
                cdf = np.cumsum(w[ok], axis=1) / tot[ok, None]
                pick = (cdf < r.random(int(ok.sum()))[:, None]).sum(axis=1)
                rows = np.where(need)[0][ok]
                out[rows] = props[ok, pick]
                need[rows] = False
        if need.any():
            # rows without a supported ladder point get a uniform draw; they
            # have no posterior support and callers redraw the whole row
            out[need] = r.integers(int(lo), int(hi) + 1, int(need.sum())).astype(float)
        return out

    def test_integral(self):
        pass


class AgePrior(FlatLogPrior):
    """Flat-log age prior over (5, 10.15) (reference priors.py:483-488)."""

    def __init__(self, **kwargs):
        super().__init__(bounds=(5, 10.15), **kwargs)


class DistancePrior(PowerLawPrior):
    """p(d) ~ d^2 out to max_distance (reference priors.py:491-493)."""

    def __init__(self, max_distance=10000, **kwargs):
        super().__init__(alpha=2.0, bounds=(0, max_distance), **kwargs)


class AVPrior(FlatPrior):
    """reference priors.py:496-499"""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0, 1.0))
        super().__init__(bounds=bounds)


class QPrior(PowerLawPrior):
    """reference priors.py:502-505"""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0.1, 1))
        super().__init__(alpha=0.3, bounds=bounds, **kwargs)


class SalpeterPrior(PowerLawPrior):
    """reference priors.py:508-511"""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0.1, 10))
        super().__init__(alpha=-2.35, bounds=bounds, **kwargs)


class ChabrierPrior(BrokenPrior):
    """Chabrier (2003) eq 17 IMF: lognormal below 1 Msun, Salpeter above
    (reference priors.py:514-519)."""

    def __init__(self, **kwargs):
        bounds = kwargs.pop("bounds", (0.1, 100.0))
        super().__init__(
            [LogNormalPrior(math.log(0.079), 0.69 * math.log(10)), PowerLawPrior(-2.35, (1.0, 100.0))],
            [1.0],
            bounds=bounds,
            **kwargs,
        )
