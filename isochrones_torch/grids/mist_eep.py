"""MIST v1.2 maximum-valid-EEP truncation map (counterpart of
``isochrones_tpu/grids/mist_eep.py``, the same tables).

Given (initial mass, [Fe/H]) return the largest EEP the published MIST v1.2
tracks reach (reference ``isochrones/mist/eep.py:1-59``). Encoded as interval
tables instead of an if-chain so it can also be evaluated for whole mass
arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["max_eep", "default_max_eep", "max_eep_vectorized"]

# default (mass-interval -> eep) map; intervals are (lo, hi, lo_op, hi_op)
# with closed/open endpoints encoded by the comparison used.
_DEFAULT_RULES = (
    # (condition fn, eep)
    (lambda m: m < 0.6, 454),
    (lambda m: m == 0.6, 605),
    (lambda m: m == 0.65, 808),
    (lambda m: m < 6.0, 1710),
    (lambda m: True, 808),
)

# feh-specific overrides (MIST v1.2 truncations)
_FEH_RULES = {
    -4.0: (
        (lambda m: m < 0.6, 454),
        (lambda m: m <= 0.94, 631),
        (lambda m: m < 3.8, 808),
        (lambda m: m <= 4.4, 1409),
        (lambda m: m >= 18, 631),
    ),
    -3.5: (
        (lambda m: m == 0.65, 631),
        (lambda m: 0.65 < m < 1.78, 808),
        (lambda m: m == 1.78, 1409),
        (lambda m: 1.78 < m <= 3.4, 808),
        (lambda m: m >= 19, 707),
    ),
    -3.0: (
        (lambda m: 0.7 <= m <= 2.48, 808),
        (lambda m: 2.5 <= m <= 4.4, 1409),
    ),
    -2.5: (
        (lambda m: 0.7 <= m <= 2.32, 808),
        (lambda m: 2.32 < m <= 5.8, 1409),
    ),
    0.5: (
        (lambda m: 0.7 <= m <= 0.75, 808),
    ),
}


def default_max_eep(mass):
    """Mass-only fallback (reference mist/eep.py:1-13)."""
    for cond, eep in _DEFAULT_RULES:
        if cond(mass):
            return eep


def max_eep(mass, feh):
    """(mass, feh) -> max valid EEP for MIST v1.2 (reference mist/eep.py:16-59)."""
    for cond, eep in _FEH_RULES.get(feh, ()):
        if cond(mass):
            return eep
    return default_max_eep(mass)


def max_eep_vectorized(masses, feh):
    """Array version over masses at fixed feh."""
    return np.array([max_eep(float(m), feh) for m in np.atleast_1d(masses)])
