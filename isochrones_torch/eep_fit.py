"""Parametric eep(age) track models for the fast MIST EEP lookup
(counterpart of ``isochrones_tpu/eep_fit.py``, the same numpy code).

Reference ``isochrones/eep.py`` (``eep_fn`` eep.py:5, ``eep_jac`` eep.py:21,
``eep_fn_p0`` eep.py:51, ``fit_section_poly`` eep.py:59): a degree-5
polynomial plus an exponential end-of-track ramp, fitted per (feh, mass)
track at bake time and evaluated on the host; the batched EEP inversion on
the device is ``ops/eep.py`` and kernel F.
"""

from __future__ import annotations

import numpy as np

__all__ = ["eep_fn", "eep_jac", "eep_fn_p0", "fit_section_poly"]


def eep_fn(x, p5, p4, p3, p2, p1, p0, A, x0, tau, order=5):
    """Polynomial + exponential eep(age) model (reference eep.py:5-18)."""
    if order < 5:
        p5 = 0.0
        if order < 4:
            p4 = 0.0
            if order < 3:
                p3 = 0.0
                if order < 2:
                    p2 = 0.0
    x = np.asarray(x, dtype=float)
    return (
        p5 * x ** 5 + p4 * x ** 4 + p3 * x ** 3 + p2 * x ** 2 + p1 * x + p0
        + A * np.exp((x - x0) / tau)
    )


def eep_jac(x, p5, p4, p3, p2, p1, p0, A, x0, tau, order=5):
    """Analytic Jacobian of :func:`eep_fn` (reference eep.py:21-48)."""
    x = np.asarray(x, dtype=float)
    e = np.exp((x - x0) / tau)
    out = np.empty((len(x), 9))
    out[:, 0] = x ** 5
    out[:, 1] = x ** 4
    out[:, 2] = x ** 3
    out[:, 3] = x ** 2
    out[:, 4] = x
    out[:, 5] = 0.0  # NB: reference also zeroes the p0 column (eep.py:42)
    out[:, 6] = e
    out[:, 7] = -A / tau * e
    out[:, 8] = -A * (x - x0) / tau ** 2 * e
    return out


def eep_fn_p0(ages, eeps, order=5):
    """Initial guess from a low-EEP linear fit (reference eep.py:51-56)."""
    ages = np.asarray(ages, dtype=float)
    eeps = np.asarray(eeps, dtype=float)
    m = eeps < 300
    if m.sum() < 2:
        m = np.ones_like(eeps, dtype=bool)
    p1, p0 = np.polyfit(ages[m], eeps[m], 1)
    return [0, 0, 0, 0, p1, p0, 1, ages.max() - 0.3, 0.05]


def fit_section_poly(age, eep, a, b, order=3):
    """Per-EEP-section polynomial fit of eep(age) (reference eep.py:59-63)."""
    age = np.asarray(age, dtype=float)
    eep = np.asarray(eep, dtype=float)
    m = (a < eep) & (eep < b)
    if m.sum() < order + 1:
        raise ValueError(f"only {int(m.sum())} points in EEP section ({a}, {b})")
    return np.polyfit(age[m], eep[m], order)
