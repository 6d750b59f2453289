"""Vizier catalogs: 2MASS, Tycho-2, WISE, Gaia DR2 (counterpart of
``isochrones_tpu/query/vizier.py``).

A query's table comes from ``table_provider`` where one is set, a callable
``(ra, dec, radius_arcsec, vizier_name) -> table``; else from astroquery's
Vizier, imported only then. The table may be a
:class:`~isochrones_torch.summary.Frame`, a dict of arrays, or anything with
``columns`` and column indexing (a pandas ``DataFrame``); it is kept as a
``Frame``. The Tycho BT/VT -> Johnson B/V conversions and the Gaia DR2
Appendix-B quality cuts are the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..summary import Frame
from .catalog import Catalog
from .query import EmptyQueryError, position_angle_deg, separation_arcsec

__all__ = ["VizierCatalog", "TwoMASS", "Tycho2", "WISE", "Gaia"]


def _as_frame(table):
    """A query's table as a :class:`Frame` (a copy of its columns; a
    ``DataFrame``'s index becomes the labels)."""
    if isinstance(table, Frame):
        return table
    cols = list(table.columns) if hasattr(table, "columns") else list(table.keys())
    index = getattr(table, "index", None)
    return Frame({c: np.asarray(table[c]) for c in cols}, index=None if index is None else np.asarray(index))


class VizierCatalog(Catalog):
    """reference query/vizier.py:13-29"""

    columns = ("**", "_r", "_RAJ2000", "_DEJ2000")

    #: injectable (ra, dec, radius_arcsec, vizier_name) -> table
    table_provider = None

    def _fetch(self):
        if self.table_provider is not None:
            ra, dec = self.query_coords
            return self.table_provider(ra, dec, self.query.radius, self.vizier_name)
        try:
            from astroquery.vizier import Vizier
            import astropy.units as u
            from astropy.coordinates import SkyCoord
        except ImportError as e:
            raise RuntimeError(
                "astroquery is not installed and no table_provider was set"
            ) from e
        ra, dec = self.query_coords
        result = Vizier(columns=list(self.columns)).query_region(
            SkyCoord(ra, dec, unit="deg"), radius=self.query.radius * u.arcsec,
            catalog=self.vizier_name,
        )
        try:
            t = result[0]
        except IndexError:
            return None
        # masked float entries as NaN, as astropy's to_pandas gives them
        return {c: np.asarray(t[c].filled(np.nan) if hasattr(t[c], "filled") and t[c].dtype.kind == "f" else t[c])
                for c in t.colnames}

    def _run_query(self):
        if self._empty:
            raise EmptyQueryError(f"{self} is empty!")
        table = self._fetch()
        if table is not None:
            table = _as_frame(table)
        if table is None or table.n_rows() == 0:
            self._empty = True
            raise EmptyQueryError(f"{self} returns empty!")
        self._table = table
        ra0, dec0 = self.query_coords
        if "_r" not in table:
            table["_r"] = separation_arcsec(ra0, dec0, table["_RAJ2000"], table["_DEJ2000"])
        # deliberately (star -> query), as the reference's
        # `coords.position_angle(self.query_coords)` (query/vizier.py:27):
        # the stored PA is the bearing of the query point seen from each star
        table["PA"] = position_angle_deg(table["_RAJ2000"], table["_DEJ2000"], ra0, dec0)


class TwoMASS(VizierCatalog):
    """reference query/vizier.py:32-37"""

    name = "twomass"
    vizier_name = "2mass"
    epoch = 2000.0
    bands = {"Jmag": "J", "Hmag": "H", "Kmag": "K"}
    id_column = "_2MASS"


class Tycho2(VizierCatalog):
    """Tycho-2 with BT/VT -> Johnson conversions
    (reference query/vizier.py:40-104; http://www.aerith.net/astro/color_conversion.html)."""

    name = "Tycho2"
    vizier_name = "tycho2"
    epoch = 2000.0
    bands = {"BTmag": "BT", "VTmag": "VT"}
    conversions = ["B", "V"]

    def get_id(self, brightest=False):
        row = self.brightest if brightest else self.closest
        return "{:.0f}-{:.0f}-{:.0f}".format(row["TYC1"], row["TYC2"], row["TYC3"])

    def V(self, brightest=False):
        mags = self.get_photometry(brightest=brightest, convert=False)
        VT, dVT = mags["VT"]
        BT, dBT = mags["BT"]
        if not (-0.25 < BT - VT < 2.0):
            raise ValueError("BT-VT outside of range to convert")
        a, b, c, d = (0.00097, 0.1334, 0.05486, 0.01998)
        x = BT - VT
        V = VT + a - b * x + c * x ** 2 - d * x ** 3
        dVdVT = 1 + b - 2 * c * x + 3 * d * x ** 2
        dVdBT = -b + 2 * c * x - 3 * d * x ** 2
        dV = np.sqrt(dVdVT ** 2 * dVT ** 2 + dVdBT ** 2 * dBT ** 2)
        return V, dV

    def BmV(self, brightest=False):
        mags = self.get_photometry(brightest=brightest, convert=False)
        VT, dVT = mags["VT"]
        BT, dBT = mags["BT"]
        x = BT - VT
        if 0.5 < x < 2.0:
            e, f, g = (0.007813, 0.1489, 0.03384)
            BmV = x - e * x - f * x ** 2 + g * x ** 3
            dBmVdVT = -1 + e + 2 * f * x - 3 * g * x ** 2
        elif -0.25 < x < 0.5:
            h, i, j = (0.006, 0.1069, 0.1459)
            BmV = x - h - i * x + j * x ** 2
            # the reference writes -1 - i - 2jx (query/vizier.py:89), a sign
            # typo: d/dVT of (x - h - ix + jx^2) with dx/dVT = -1 is
            # -1 + i - 2jx, as the JAX package takes it
            dBmVdVT = -1 + i - 2 * j * x
        else:
            raise ValueError("BT-VT outside of range to convert")
        dBmVdBT = -dBmVdVT
        dBmV = np.sqrt(dBmVdVT ** 2 * dVT ** 2 + dBmVdBT ** 2 * dBT ** 2)
        return BmV, dBmV

    def B(self, brightest=False):
        BmV, dBmV = self.BmV(brightest=brightest)
        V, dV = self.V(brightest=brightest)
        return BmV + V, np.sqrt(dBmV ** 2 + dV ** 2)


class WISE(VizierCatalog):
    """reference query/vizier.py:107-112"""

    name = "WISE"
    vizier_name = "allwise"
    epoch = 2000.0
    bands = {"W1mag": "W1", "W2mag": "W2", "W3mag": "W3"}  # W4 left out
    id_column = "AllWISE"


class Gaia(VizierCatalog):
    """Gaia DR2 with the Appendix-B quality cuts of arXiv:1804.09378
    (reference query/vizier.py:115-143)."""

    name = "Gaia"
    vizier_name = "I/345/gaia2"
    epoch = 2015.5
    bands = {"Gmag": "G", "BPmag": "BP", "RPmag": "RP"}
    id_column = "Source"

    @property
    def is_good(self):
        t = self._table
        good = np.asarray(t["RPlx"]) > 10
        good &= np.asarray(t["RFG"]) > 50
        good &= np.asarray(t["RFRP"]) > 20
        good &= np.asarray(t["RFBP"]) > 20
        good &= np.asarray(t["Nper"]) > 8
        gmag = np.asarray(t["Gmag"], dtype=float)
        factor = np.maximum(np.exp(-0.4 * (gmag - 19.5)), 1.0)
        good &= np.asarray(t["chi2AL"]) / (np.asarray(t["NgAL"]) - 5) < 1.44 * factor
        # a NaN entry already compares False above
        return np.asarray(good, dtype=bool)
