"""Star catalogs (counterpart of ``isochrones_tpu/catalog.py``).

A catalog is a table of ``<band>_mag`` / ``<band>_mag_unc`` photometry plus
named property columns with ``_unc`` partners. It accepts any mapping of
column name to 1-d array: a ``dict`` of numpy arrays, or a DataFrame where
pandas is installed (both offer ``keys()`` and ``[column]``). Besides the
observation stacks that the cluster model and the catalog fitter read, it
makes one star model a row (``iter_models``, with the priors of
``set_prior``) and writes their ``star.ini`` files (``write_ini``). ``ds``
and ``hr`` need ``holoviews``, as in the reference; ``hr_plot`` needs
matplotlib.
"""

from __future__ import annotations

import csv
import os
import re
import shutil

import numpy as np

from .logger import getLogger
from .utils import band_pairs

__all__ = ["StarCatalog", "read_csv"]


def read_csv(path):
    """Numeric CSV with a header row -> dict of float64 arrays (no pandas); an
    empty cell, as ``DataFrame.to_csv`` writes NaN, reads as NaN."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: np.array([float(r[i]) if r[i] else np.nan for r in body]) for i, name in enumerate(header)}


class StarCatalog:
    """Catalog of star measurements (reference catalog.py:19-63).

    df : mapping of column name -> 1-d array, or a ``StarCatalog`` (its
        columns, and its bands and properties where none are given). Bands
        are inferred from ``*_mag`` names when not given. When ``props`` is
        None, known properties present with an ``_unc`` partner are
        auto-detected; pass ``props=()`` for photometry only.
    no_uncs : skip the check that every band and property has its column
        and its ``_unc`` partner (reference catalog.py:61-67).
    """

    KNOWN_PROPS = ("Teff", "logg", "feh", "parallax", "density")

    def __init__(self, df, bands=None, props=None, no_uncs=False):
        if isinstance(df, StarCatalog):
            bands = df.bands if bands is None else bands
            props = df.props if props is None else props
            df = df.data
        self.data = {str(c): np.asarray(df[c]) for c in df.keys()}
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

        if not no_uncs:
            for c in self.band_cols + self.props:
                if c not in self.data:
                    raise ValueError(f"{c} not in catalog!")
                if f"{c}_unc" not in self.data:
                    raise ValueError(f"{c} uncertainty ({c}_unc) not in catalog!")

        self._prior_settings = {}

    def __len__(self):
        return len(next(iter(self.data.values())))

    @property
    def df(self):
        """The catalog's columns (a dict of name -> numpy array; the
        reference's DataFrame, catalog.py:70-76)."""
        return self.data

    @df.setter
    def df(self, newdf):
        self.data = {str(c): np.asarray(newdf[c]) for c in newdf.keys()}

    @property
    def index(self):
        """Row labels of the catalog's summaries: its ``index`` column where
        it has one, else ``0 .. S-1``."""
        if "index" in self.data:
            return np.asarray(self.data["index"])
        return np.arange(len(self))

    def get_measurement(self, prop, values=False):
        """(values, uncertainties) arrays (reference catalog.py:82-84). The
        columns are numpy arrays already, so ``values`` changes nothing, as
        in the JAX package (which always returns ``.values``)."""
        return self.data[prop], self.data[prop + "_unc"]

    def iter_bands(self, **kwargs):
        """``(band, (values, uncertainties))`` per band; ``kwargs`` go to
        :meth:`get_measurement`."""
        for b, col in zip(self.bands, self.band_cols):
            yield b, self.get_measurement(col, **kwargs)

    def iter_props(self, **kwargs):
        """``(prop, (values, uncertainties))`` per property; ``kwargs`` go to
        :meth:`get_measurement`."""
        for p in self.props:
            yield p, self.get_measurement(p, **kwargs)

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

    # ------------------------------------------------------------------ plots
    @property
    def ds(self):
        """Holoviews dataset of the magnitudes and colours (reference
        catalog.py:91-104). Needs the optional ``holoviews``, as the
        reference does."""
        import holoviews as hv

        if getattr(self, "_ds", None) is None:
            cols = dict(self.data)
            for b1, b2 in band_pairs(self.bands):
                cols[b2] = self.data[f"{b2}_mag"]
                cols[f"{b1}-{b2}"] = self.data[f"{b1}_mag"] - self.data[f"{b2}_mag"]
            self._ds = hv.Dataset(cols)
        return self._ds

    @property
    def hr(self):
        """Holoviews colour-magnitude layout (reference catalog.py:106-115)."""
        import holoviews as hv

        if getattr(self, "_hr", None) is None:
            layout = []
            opts = dict(invert_yaxis=True, tools=["hover"])
            for b1, b2 in band_pairs(self.bands):
                kdims = [f"{b1}-{b2}", f"{b1}_mag"]
                layout.append(hv.Points(self.ds, kdims=kdims, vdims=self.ds.kdims).options(**opts))
            self._hr = hv.Layout(layout)
        return self._hr

    def hr_plot(self, ax=None):
        """Colour-magnitude diagram(s) with matplotlib, one panel a band pair
        (the role of the reference's holoviews ``hr``, catalog.py:91-115)."""
        import matplotlib.pyplot as plt

        pairs = band_pairs(self.bands)
        if ax is None:
            fig, axes = plt.subplots(1, max(len(pairs), 1), figsize=(4 * max(len(pairs), 1), 4))
            axes = np.atleast_1d(axes)
        else:
            axes = np.atleast_1d(ax)
            fig = axes[0].figure
        for (b1, b2), a in zip(pairs, axes):
            color = self.df[f"{b1}_mag"] - self.df[f"{b2}_mag"]
            a.scatter(color, self.df[f"{b1}_mag"], s=6, alpha=0.7)
            a.invert_yaxis()
            a.set_xlabel(f"{b1} - {b2}")
            a.set_ylabel(f"{b1}")
        return fig

    # ------------------------------------------------------------------ models
    def _set_prior(self, mod):
        mod.set_prior(**self._prior_settings)
        return mod

    def set_prior(self, **kwargs):
        """Priors set on every model :meth:`iter_models` makes (reference
        catalog.py:117-124)."""
        self._prior_settings.update(kwargs)

    def iter_models(self, ic=None, N=1):
        """One star model a row, named by its row label (reference
        catalog.py:126-139). ``ic`` defaults to ``get_ichrone("mist")`` with
        the catalog's bands, on the card."""
        from .starmodel import BinaryStarModel, SingleStarModel, TripleStarModel

        if ic is None:
            from .isochrone import get_ichrone

            ic = get_ichrone("mist", bands=self.bands)
        mod_type = {1: SingleStarModel, 2: BinaryStarModel, 3: TripleStarModel}
        names = self.index
        for i in range(len(self)):
            mags = {b: (self.data[f"{b}_mag"][i], self.data[f"{b}_mag_unc"][i]) for b in self.bands}
            props = {p: (self.data[p][i], self.data[f"{p}_unc"][i]) for p in self.props}
            yield self._set_prior(mod_type[N](ic, **mags, **props, name=names[i]))

    def write_ini(self, ic=None, root=".", N=1, nest_directories=True, clobber=True):
        """Every row's ``star.ini``, optionally in subdirectories by the
        name's leading digits (reference catalog.py:141-158); returns the
        directories."""
        if ic is None:
            from .isochrone import get_ichrone

            ic = get_ichrone("mist", bands=self.bands)
        n_pre = int(np.log10(len(self)) // 2)
        dirs = []
        for mod in self.iter_models(ic, N=N):
            path = os.path.join(root, str(mod.name)[:n_pre]) if nest_directories else root
            mod_path = os.path.abspath(os.path.join(path, str(mod.name)))
            if os.path.exists(mod_path) and clobber:
                shutil.rmtree(mod_path)
            mod.write_ini(root=path)
            dirs.append(mod_path)
        return dirs
