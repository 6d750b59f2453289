"""Catalog query-result base class (counterpart of
``isochrones_tpu/query/catalog.py``): the proper-motion-corrected query
position, the closest and brightest matches, photometry with a systematic
uncertainty floor, and a quality-cut hook. The result table is a
:class:`~isochrones_torch.summary.Frame`."""

from __future__ import annotations

import numpy as np

from .query import EmptyQueryError

__all__ = ["Catalog"]


class Catalog:
    """Base class for results of catalog queries (reference catalog.py:8-111).

    Subclasses define ``name``, ``epoch``, ``bands`` (raw->shortcut column
    map), ``id_column``, and ``_run_query`` filling ``self._table`` (a
    :class:`~isochrones_torch.summary.Frame` with a ``_r`` separation
    column).
    """

    _distance_column = "_r"

    def __init__(self, query):
        self.query = query
        self._table = None
        self._empty = False

    def __repr__(self):
        return f"{type(self).__name__}({self.query!r})"

    def __str__(self):
        return f"{self.name} Query of {self.query}"

    @property
    def query_coords(self):
        """(ra, dec) at the catalog epoch (reference catalog.py:34-42)."""
        return self.query.coords_at_epoch(self.epoch)

    @property
    def coords(self):
        """(ra, dec) arrays of the result rows in degrees."""
        t = self.table
        return (np.asarray(t["_RAJ2000"], dtype=float), np.asarray(t["_DEJ2000"], dtype=float))

    def _run_query(self):
        raise NotImplementedError

    @property
    def table(self):
        if self._table is None:
            self._run_query()
            self._table["is_good"] = np.asarray(self.is_good)
        return self._table

    @property
    def df(self):
        df = self.table
        df = df.loc[df["is_good"]]
        if df.n_rows() == 0:
            raise EmptyQueryError(f"No good sources found! ({self.query})")
        return df

    @property
    def closest(self):
        return self.df.sort_values(by=self._distance_column).iloc[0]

    @property
    def brightest(self):
        band = list(self.bands.keys())[0]
        return self.df.sort_values(by=band).iloc[0]

    def get_id(self, brightest=False):
        row = self.brightest if brightest else self.closest
        return row[self.id_column]

    def get_photometry(self, brightest=False, systematic_unc=0.0, convert=True):
        """Photometry dict of the closest (or brightest) match
        (reference catalog.py:76-105)."""
        row = self.brightest if brightest else self.closest
        if not hasattr(self, "conversions"):
            convert = False

        d = {}
        if convert:
            for b in self.conversions:
                mag, dmag = getattr(self, b)(brightest=brightest)
                d[b] = (mag, np.sqrt(dmag ** 2 + systematic_unc ** 2))
        else:
            for raw, key in self.bands.items():
                mag, dmag = row[raw], row[f"e_{raw}"]
                d[key] = (mag, np.sqrt(dmag ** 2 + systematic_unc ** 2))
        return d

    @property
    def is_good(self):
        """Quality-cut hook (reference catalog.py:107-111): ``_r > 0``, which
        also drops NaN separations (and a source at exactly the query
        position, as the reference does)."""
        return np.asarray(self._table[self._distance_column]) > 0
