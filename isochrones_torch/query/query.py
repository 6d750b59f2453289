"""Query value object and the sky math it needs (counterpart of
``isochrones_tpu/query/query.py``): proper-motion epoch propagation, the
angular separation and the position angle, in numpy."""

from __future__ import annotations

import numpy as np

__all__ = ["Query", "EmptyQueryError", "separation_arcsec", "position_angle_deg"]


class EmptyQueryError(ValueError):
    pass


def separation_arcsec(ra1, dec1, ra2, dec2):
    """Angular separation (arcsec) between two positions in degrees
    (Vincenty formula; exact on the sphere)."""
    ra1, dec1, ra2, dec2 = (np.radians(np.asarray(x, dtype=float)) for x in (ra1, dec1, ra2, dec2))
    dra = ra2 - ra1
    num = np.hypot(
        np.cos(dec2) * np.sin(dra),
        np.cos(dec1) * np.sin(dec2) - np.sin(dec1) * np.cos(dec2) * np.cos(dra),
    )
    den = np.sin(dec1) * np.sin(dec2) + np.cos(dec1) * np.cos(dec2) * np.cos(dra)
    return np.degrees(np.arctan2(num, den)) * 3600.0


def position_angle_deg(ra1, dec1, ra2, dec2):
    """Position angle (deg E of N) of point 2 as seen from point 1."""
    ra1, dec1, ra2, dec2 = (np.radians(np.asarray(x, dtype=float)) for x in (ra1, dec1, ra2, dec2))
    dra = ra2 - ra1
    pa = np.arctan2(
        np.sin(dra),
        np.cos(dec1) * np.tan(dec2) - np.sin(dec1) * np.cos(dra),
    )
    return np.degrees(pa) % 360.0


class Query:
    """RA/dec in decimal degrees, pm in mas/yr, radius in arcsec
    (reference query/query.py:9-39)."""

    def __init__(self, ra, dec, pmra=0.0, pmdec=0.0, epoch=2000.0, radius=5.0):
        self.ra = float(ra)
        self.dec = float(dec)
        self.pmra = float(pmra)
        self.pmdec = float(pmdec)
        self.epoch = float(epoch)
        self.radius = float(radius)  # arcsec

    @property
    def coords(self):
        """(ra, dec) of the query point in degrees."""
        return (self.ra, self.dec)

    def coords_at_epoch(self, epoch):
        """Proper-motion-corrected (ra, dec) at ``epoch``."""
        dt = self.epoch - epoch  # yr
        ra = self.ra - dt * self.pmra / 3.6e6 / np.cos(np.radians(self.dec))
        dec = self.dec - dt * self.pmdec / 3.6e6
        return ra, dec

    def __str__(self):
        return (
            f"({self.ra}, {self.dec}), pm=({self.pmra}, {self.pmdec}), "
            f"epoch={self.epoch}, radius={self.radius} arcsec"
        )

    def __repr__(self):
        return (
            f"Query(ra={self.ra}, dec={self.dec}, pmra={self.pmra}, "
            f"pmdec={self.pmdec}, epoch={self.epoch}, radius={self.radius})"
        )
