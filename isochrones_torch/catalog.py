"""Star catalogs (counterpart of ``isochrones_tpu/catalog.py``, the part the
cluster model reads).

A catalog is a table of ``<band>_mag`` / ``<band>_mag_unc`` photometry plus
named property columns with ``_unc`` partners. It accepts any mapping of
column name to 1-d array: a ``dict`` of numpy arrays, or a DataFrame where
pandas is installed (both offer ``keys()`` and ``[column]``).
"""

from __future__ import annotations

import csv
import re

import numpy as np

from .logger import getLogger

__all__ = ["StarCatalog", "read_csv"]


def read_csv(path):
    """Numeric CSV with a header row -> dict of float64 arrays (no pandas)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: np.array([float(r[i]) for r in body]) for i, name in enumerate(header)}


class StarCatalog:
    """Catalog of star measurements (reference catalog.py:19-63).

    data : mapping of column name -> 1-d array. Bands are inferred from
        ``*_mag`` names when not given. When ``props`` is None, known
        properties present with an ``_unc`` partner are auto-detected; pass
        ``props=()`` for photometry only.
    """

    KNOWN_PROPS = ("Teff", "logg", "feh", "parallax", "density")

    def __init__(self, data, bands=None, props=None):
        self.data = {str(c): np.asarray(data[c]) for c in data.keys()}
        columns = list(self.data)
        if bands is None:
            bands = [m.group(1) for c in columns if (m := re.search("(.+)_mag$", c))]
        self.bands = tuple(bands)
        self.band_cols = tuple(f"{b}_mag" for b in self.bands)
        if props is None:
            props = tuple(p for p in self.KNOWN_PROPS if p in self.data and f"{p}_unc" in self.data)
            if props:
                getLogger().info(
                    "StarCatalog: auto-detected measured props %s (pass props=() for photometry-only)",
                    props,
                )
        self.props = tuple(props)

        for c in self.band_cols + self.props:
            if c not in self.data:
                raise ValueError(f"{c} not in catalog!")
            if f"{c}_unc" not in self.data:
                raise ValueError(f"{c} uncertainty ({c}_unc) not in catalog!")

    def __len__(self):
        return len(next(iter(self.data.values())))

    def get_measurement(self, prop):
        """(values, uncertainties) arrays (reference catalog.py:82-84)."""
        return self.data[prop], self.data[prop + "_unc"]

    def iter_bands(self):
        for b, col in zip(self.bands, self.band_cols):
            yield b, self.get_measurement(col)

    def iter_props(self):
        for p in self.props:
            yield p, self.get_measurement(p)

    def observation_stacks(self):
        """``(mag_vals, mag_uncs, prop_vals, prop_uncs)`` as float64 stacks of
        shapes (S, n_bands) / (S, n_props), star axis leading."""
        mag_vals = np.stack([np.asarray(v, dtype=float) for _, (v, u) in self.iter_bands()], axis=-1)
        mag_uncs = np.stack([np.asarray(u, dtype=float) for _, (v, u) in self.iter_bands()], axis=-1)
        props = [(np.asarray(v, dtype=float), np.asarray(u, dtype=float)) for _, (v, u) in self.iter_props()]
        n = mag_vals.shape[0]
        if props:
            prop_vals = np.stack([v for v, _ in props], axis=-1)
            prop_uncs = np.stack([u for _, u in props], axis=-1)
        else:
            prop_vals = np.zeros((n, 0))
            prop_uncs = np.ones((n, 0))
        return mag_vals, mag_uncs, prop_vals, prop_uncs
