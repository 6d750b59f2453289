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

:func:`read_table` reads a member table as the JAX package's entry points
do with ``pd.read_hdf`` / ``pd.read_csv``: a pandas HDF table
(``DataFrame.to_hdf``, the ``fixed`` or the ``table`` format, through
:mod:`isochrones_torch.hdf5`), or a CSV file.
"""

from __future__ import annotations

import csv
import io
import os
import pickle
import re
import shutil

import numpy as np

from . import hdf5
from .logger import getLogger
from .utils import band_pairs

__all__ = ["StarCatalog", "read_csv", "read_table", "read_hdf_table"]

HDF_SUFFIXES = (".h5", ".hdf", ".hdf5")


def read_csv(path):
    """Numeric CSV with a header row -> dict of float64 arrays (no pandas); an
    empty cell, as ``DataFrame.to_csv`` writes NaN, reads as NaN."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: np.array([float(r[i]) if r[i] else np.nan for r in body]) for i, name in enumerate(header)}


def read_table(path):
    """A star table -> dict of float64 columns: a pandas HDF table where the
    name ends in ``.h5``, ``.hdf`` or ``.hdf5`` (:func:`read_hdf_table`),
    else a CSV file (:func:`read_csv`)."""
    if str(path).endswith(HDF_SUFFIXES):
        return read_hdf_table(path)
    return read_csv(path)


class _Refused(ValueError):
    """A pickled attribute that names a class."""


class _PlainUnpickler(pickle.Unpickler):
    """PyTables keeps a list, tuple, dict or None attribute as a protocol-0
    pickle; this unpickler rebuilds such plain data and refuses any pickle
    that names a class."""

    def find_class(self, module, name):
        raise _Refused(f"a PyTables attribute pickles {module}.{name}; only plain data is read")


def _pt_attr(attrs, name, default=None):
    """The attribute ``name`` of ``attrs`` as PyTables returns it: a byte
    string that ends in ``.`` is a pickle (plain data only), another one
    text."""
    value = attrs.get(name, default)
    if not isinstance(value, bytes):
        return value
    if value.endswith(b".") and value not in (b"0", b"0."):
        try:
            return _PlainUnpickler(io.BytesIO(value)).load()
        except _Refused:
            raise
        except (pickle.UnpicklingError, EOFError, ValueError, IndexError, KeyError, TypeError):
            pass  # text that happens to end in "." (PyTables tries the same way)
    return value.decode("utf-8")


def _pandas_objects(group, prefix=""):
    """``(key, group)`` of every pandas object under ``group`` (a group with
    a ``pandas_type`` attribute)."""
    out = []
    for name in group:
        node = group.node(name)
        if isinstance(node, hdf5.Group):
            key = f"{prefix}/{name}"
            out += [(key, node)] if "pandas_type" in node.attrs else _pandas_objects(node, key)
    return out


def read_hdf_table(path):
    """A DataFrame that ``DataFrame.to_hdf`` wrote (PyTables' layout; the
    ``fixed`` format, ``FrameFixed``, or the ``table`` format,
    ``AppendableFrameTable``, deflate-compressed or not) -> dict of float64
    columns in the frame's order: the dict that :func:`read_csv` gives for
    ``frame.to_csv(index=False)``. The row index (integers or fixed-length
    strings) is read and dropped, as a CSV file has none. The file holds
    one frame, as ``pd.read_hdf`` without a key requires. A column that is
    not numeric (an object block, which PyTables pickles, a string,
    category or datetime column), a MultiIndex, or another compressor raises
    ``ValueError``."""
    found = _pandas_objects(hdf5.File(path))
    if len(found) != 1:
        raise ValueError(f"{path} holds {len(found)} pandas objects ({[k for k, _ in found]}); one is read")
    key, group = found[0]
    kind = _pt_attr(group.attrs, "pandas_type")
    if kind == "frame":
        columns = _read_fixed_frame(path, key, group)
    elif kind == "frame_table":
        columns = _read_frame_table(path, key, group)
    else:
        raise ValueError(f"{path}: {key} is a pandas {kind!r} object; only DataFrames are read")
    return {str(c): np.asarray(v, dtype=np.float64) for c, v in columns.items()}


def _numeric(path, key, cols, values, dtype_name=None):
    """``values`` where its dtype is numeric; otherwise the columns' refusal."""
    if values.dtype.kind not in "biuf" or str(dtype_name or "").startswith(("datetime", "timedelta", "category")):
        what = dtype_name or values.dtype
        raise ValueError(f"{path}: {key} columns {list(cols)} are stored as {what}; only numeric columns are read")
    return values


def _fixed_index(path, key, group, name, encoding):
    """The labels of a ``fixed`` frame's index node ``name``."""
    attrs = group.node(name).attrs
    kind = _pt_attr(attrs, "kind")
    if "shape" in attrs and 0 in tuple(np.atleast_1d(_pt_attr(attrs, "shape"))):
        return []
    if kind in ("integer", "float"):
        return group[name].tolist()
    if kind == "string":
        return [v.decode(encoding) for v in group[name]]
    raise ValueError(f"{path}: {key}/{name} is a {kind!r} index; integer and string indexes are read")


def _read_fixed_frame(path, key, group):
    attrs = group.attrs
    encoding = _pt_attr(attrs, "encoding") or "UTF-8"
    for axis in ("axis0", "axis1"):
        if _pt_attr(attrs, f"{axis}_variety") != "regular":
            raise ValueError(f"{path}: {key} has a MultiIndex ({axis}); a flat index is read")
    columns = _fixed_index(path, key, group, "axis0", encoding)
    _fixed_index(path, key, group, "axis1", encoding)
    out = {}
    for i in range(int(_pt_attr(attrs, "nblocks"))):
        items = _fixed_index(path, key, group, f"block{i}_items", encoding)
        name = f"block{i}_values"
        try:
            node = group.node(name)
        except ValueError as err:
            raise ValueError(f"{path}: {key} columns {items} are an object block, which PyTables pickles; only "
                             f"numeric columns are read ({err})") from None
        shape = tuple(np.atleast_1d(_pt_attr(node.attrs, "shape", ())))
        value_type = _pt_attr(node.attrs, "value_type")
        if 0 in shape:
            values = np.empty(shape, dtype=value_type)
        else:
            values = _numeric(path, key, items, node.read(), value_type)
            if _pt_attr(node.attrs, "transposed"):
                values = values.T
        out.update({str(c): values[j] for j, c in enumerate(items)})
    return {str(c): out[str(c)] for c in columns}


def _read_frame_table(path, key, group):
    table_type = _pt_attr(group.attrs, "table_type")
    if table_type != "appendable_frame":
        raise ValueError(f"{path}: {key} is a {table_type!r} table; an appendable frame table is read")
    index_cols = _pt_attr(group.attrs, "index_cols") or ()
    if len(index_cols) != 1:
        raise ValueError(f"{path}: {key} has a MultiIndex; a flat index is read")
    table = group.node("table")
    index_kind = _pt_attr(table.attrs, f"{index_cols[0][1]}_kind")
    if index_kind not in ("integer", "float", "string"):
        raise ValueError(f"{path}: {key} has a {index_kind!r} index; integer and string indexes are read")
    data = table.read()
    out = {}
    for vc in _pt_attr(group.attrs, "values_cols"):
        items = _pt_attr(table.attrs, f"{vc}_kind")
        meta = _pt_attr(table.attrs, f"{vc}_meta")
        if meta is not None:
            raise ValueError(f"{path}: {key} columns {list(items)} are {meta}; only numeric columns are read")
        values = _numeric(path, key, items, data[vc], _pt_attr(table.attrs, f"{vc}_dtype")).reshape(len(data), -1)
        out.update({str(c): values[:, j] for j, c in enumerate(items)})
    return {str(c): out[str(c)] for c in _pt_attr(group.attrs, "non_index_axes")[0][1]}


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
