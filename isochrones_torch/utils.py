"""Math / small utilities (counterpart of ``isochrones_tpu/utils.py``).
Host code on numpy."""

from __future__ import annotations

import numpy as np

# Physical constants in cgs (values of astropy.constants at reference epoch).
G_CGS = 6.6743e-08
MSUN_CGS = 1.98840987069805e33
RSUN_CGS = 6.957e10


def addmags(*mags):
    """NumPy/host magnitude addition with optional (mag, unc) pairs
    (reference: isochrones/utils.py:43-64)."""
    tot = 0
    uncs = []
    for mag in mags:
        if np.isscalar(mag) or isinstance(mag, np.ndarray) or not hasattr(mag, "__len__"):
            tot = tot + 10 ** (-0.4 * np.asarray(mag))
        else:
            try:
                m, dm = mag
            except (TypeError, ValueError):
                tot = tot + 10 ** (-0.4 * np.asarray(mag))
                continue
            f = 10 ** (-0.4 * np.asarray(m))
            tot = tot + f
            uncs.append(f * (1 - 10 ** (-0.4 * np.asarray(dm))))

    totmag = -2.5 * np.log10(tot)
    if uncs:
        f_unc = np.sqrt(np.sum([u ** 2 for u in uncs], axis=0))
        return totmag, -2.5 * np.log10(1 - f_unc / tot)
    return totmag
