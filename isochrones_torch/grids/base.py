"""Grid management base classes (counterpart of ``isochrones_tpu/grids/base.py``).

Reference ``isochrones/grid.py:10-144`` (``Grid``), ``isochrones/models.py:26-250``
(``StellarModelGrid``) and ``isochrones/bc.py:9-118``
(``BolometricCorrectionGrid``): find the grid's files under
``config.ISOCHRONES`` (extracting a tarball that is already there), parse the
raw tables into standardized tables, cache them, and densify them into a
:class:`~isochrones_torch.ops.interp.GridData` on the device.

The port reads local files only: where the JAX package would download a
tarball, it raises :class:`MissingGridError`, which names the missing path and
the URL to fetch. There is no pandas on the machine with the card, so a
grid's table is a :class:`Table` (numpy columns and a multi-level row index)
and the caches are ``.npz`` files under names of their own (``*.torch.npz``),
so that a shared ``$ISOCHRONES`` never leads one package to read the other's
parquet caches.
"""

from __future__ import annotations

import os
import re
import tarfile

import numpy as np
import torch

from .. import config
from ..logger import getLogger
from ..ops.interp import GridInterpolator
from ..utils import MSUN_CGS, RSUN_CGS

__all__ = ["Grid", "StellarModelGrid", "BolometricCorrectionGrid", "Table", "MissingGridError"]

#: suffix of every cache file the port writes
CACHE_SUFFIX = ".torch.npz"


class MissingGridError(FileNotFoundError):
    """A grid's files are not on disk; nothing is downloaded."""


class Index:
    """The row index of a :class:`Table`: one array per named level."""

    def __init__(self, names=(), arrays=()):
        self.names = list(names)
        self.arrays = tuple(np.asarray(a) for a in arrays)

    @property
    def levels(self):
        """Each level's sorted unique values, as ``MultiIndex.levels`` holds
        them for a table indexed from its columns."""
        return tuple(np.unique(a) for a in self.arrays)

    @property
    def codes(self):
        """Each row's position in each level."""
        return tuple(np.searchsorted(lv, a) for lv, a in zip(self.levels, self.arrays))

    def __len__(self):
        return len(self.arrays[0]) if self.arrays else 0


class Table:
    """A grid's table without pandas: ordered columns (name -> 1-d numpy
    array, each keeping its dtype) and a multi-level row :class:`Index`.

    It has only what the grid pipeline reads through pandas: columns by name,
    ``index.levels``, :meth:`xs` on one or more levels, :meth:`groups` over
    the first levels in sorted order, :meth:`concat` of rows,
    :meth:`join_columns`, :meth:`sort_index`, :meth:`rename` and ``.npz``
    caches (:meth:`save`, :meth:`load`)."""

    def __init__(self, columns=None, index=None):
        self._cols = {k: np.asarray(v) for k, v in (columns or {}).items()}
        self.index = index if index is not None else Index()

    # ---------------------------------------------------------------- access
    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        if self._cols:
            return len(next(iter(self._cols.values())))
        return len(self.index)

    @property
    def shape(self):
        return (len(self), len(self._cols))

    def __getitem__(self, name):
        if isinstance(name, (list, tuple)):
            return Table({c: self._cols[c] for c in name}, self.index)
        return self._cols[name]

    def __setitem__(self, name, value):
        value = np.asarray(value)
        if value.ndim == 0:
            value = np.full(len(self), value[()], dtype=value.dtype)
        elif len(value) != len(self) and self._cols:
            raise ValueError(f"column {name!r} has {len(value)} rows, the table {len(self)}")
        self._cols[name] = value

    @property
    def values(self):
        """The columns as one float64 array ``(rows, columns)`` (bool as 0/1)."""
        if not self._cols:
            return np.empty((len(self), 0))
        return np.stack([np.asarray(v, dtype=np.float64) for v in self._cols.values()], axis=1)

    def copy(self):
        return Table({k: v.copy() for k, v in self._cols.items()}, Index(self.index.names, self.index.arrays))

    def take(self, rows):
        """The rows at ``rows`` (positions or a boolean mask), index included."""
        return Table({k: v[rows] for k, v in self._cols.items()},
                     Index(self.index.names, [a[rows] for a in self.index.arrays]))

    def rename(self, columns):
        """Columns renamed by the mapping ``columns``; a name renamed onto an
        existing one replaces it."""
        out = {}
        for k, v in self._cols.items():
            out[columns.get(k, k)] = v
        return Table(out, self.index)

    # ----------------------------------------------------------------- index
    def set_index(self, names, drop=True):
        """Index the rows by the columns ``names`` (removed from the columns
        unless ``drop`` is False)."""
        index = Index(names, [self._cols[n] for n in names])
        cols = {k: v for k, v in self._cols.items() if not (drop and k in names)}
        return Table(cols, index)

    def sort_index(self):
        """Rows sorted by the index levels, the first the slowest (stable)."""
        if not self.index.arrays:
            return self
        order = np.lexsort(self.index.arrays[::-1])
        return self.take(order)

    def sort_values(self, by):
        """Rows sorted by the columns ``by``, the first the slowest (stable)."""
        order = np.lexsort([self._cols[c] for c in by][::-1])
        return self.take(order)

    def _level(self, level):
        return level if isinstance(level, int) else self.index.names.index(level)

    def xs(self, key, level=0):
        """The rows whose level(s) ``level`` equal ``key`` (a value or a
        tuple of values), without those levels."""
        if not isinstance(level, (list, tuple)):
            key, level = (key,), (level,)
        elif not isinstance(key, (list, tuple)):
            key = (key,)
        ilev = [self._level(lv) for lv in level]
        mask = np.ones(len(self), dtype=bool)
        for i, k in zip(ilev, key):
            mask &= self.index.arrays[i] == k
        out = self.take(np.nonzero(mask)[0])
        keep = [i for i in range(len(self.index.names)) if i not in ilev]
        out.index = Index([out.index.names[i] for i in keep], [out.index.arrays[i] for i in keep])
        return out

    def groups(self, n_levels=2):
        """``(key, rows)`` for each distinct value of the first ``n_levels``
        index levels, in sorted order of the keys; ``rows`` are the group's
        positions in table order."""
        keys = self.index.arrays[:n_levels]
        order = np.lexsort(keys[::-1])
        sorted_keys = [k[order] for k in keys]
        change = np.zeros(len(order), dtype=bool)
        if len(order):
            change[0] = True
            for k in sorted_keys:
                change[1:] |= k[1:] != k[:-1]
        starts = np.nonzero(change)[0]
        ends = np.append(starts[1:], len(order))
        for s, e in zip(starts, ends):
            yield tuple(k[s] for k in sorted_keys), order[s:e]

    # --------------------------------------------------------------- combine
    @staticmethod
    def concat(tables):
        """The rows of ``tables`` one after another (the same columns and
        index levels; the first table's order)."""
        tables = list(tables)
        cols = tables[0].columns
        for t in tables[1:]:
            if sorted(t.columns) != sorted(cols) or t.index.names != tables[0].index.names:
                raise ValueError("Table.concat needs tables with the same columns and index")
        data = {c: np.concatenate([t[c] for t in tables]) for c in cols}
        arrays = [np.concatenate([t.index.arrays[i] for t in tables]) for i in range(len(tables[0].index.names))]
        return Table(data, Index(tables[0].index.names, arrays))

    @staticmethod
    def join_columns(tables):
        """The columns of ``tables`` side by side; their indexes must be equal
        row for row."""
        tables = list(tables)
        first = tables[0]
        data = {}
        for t in tables:
            if t.index.names != first.index.names or not all(
                    np.array_equal(a, b) for a, b in zip(t.index.arrays, first.index.arrays)):
                raise ValueError("Table.join_columns needs tables with the same index")
            data.update(t._cols)
        return Table(data, first.index)

    # ----------------------------------------------------------------- cache
    def save(self, filename):
        """Write the table to an ``.npz`` file (atomically: temporary file,
        then rename)."""
        entries = {"columns": np.asarray(self.columns, dtype=str),
                   "index_names": np.asarray(self.index.names, dtype=str)}
        for i, v in enumerate(self._cols.values()):
            entries[f"c{i}"] = v
        for i, a in enumerate(self.index.arrays):
            entries[f"i{i}"] = a
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        tmp = f"{filename}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **entries)
        os.replace(tmp, filename)

    @classmethod
    def load(cls, filename):
        with np.load(filename, allow_pickle=False) as d:
            names = [str(c) for c in d["columns"]]
            inames = [str(c) for c in d["index_names"]]
            cols = {n: d[f"c{i}"] for i, n in enumerate(names)}
            arrays = [d[f"i{i}"] for i in range(len(inames))]
        return cls(cols, Index(inames, arrays))


def _read_or_build(filename, build):
    """The table cached in ``filename``, built by ``build()`` and cached when
    the file is missing or unreadable."""
    if os.path.exists(filename):
        try:
            return Table.load(filename)
        except (OSError, ValueError, KeyError):
            pass
    table = build()
    table.save(filename)
    return table


class Grid:
    """Base model-grid manager (reference grid.py:10-144). ``device`` and
    ``dtype`` say where :attr:`interp` puts the dense grid (the card unless
    the caller passes ``device="cpu"``)."""

    index_cols = None
    is_full = False
    bounds = tuple()
    name = None

    def __init__(self, device="cuda", dtype=torch.float64, **kwargs):
        self.kwargs = dict(getattr(self, "default_kwargs", {}))
        self.kwargs.update(kwargs)
        self.device = device
        self.dtype = dtype
        self._df = None
        self._df_orig = None
        self._interp = None
        self._interp_orig = None
        self._limits = dict(self.bounds)

    def get_limits(self, prop):
        """reference grid.py:58-61"""
        if prop not in self._limits:
            col = self.df[prop]
            self._limits[prop] = (np.nanmin(col), np.nanmax(col))
        return self._limits[prop]

    @property
    def datadir(self):
        raise NotImplementedError

    # ------------------------------------------------------------- downloads
    def get_tarball_url(self, **kwargs):
        raise NotImplementedError

    def get_tarball_file(self, **kwargs):
        raise NotImplementedError

    def download_tarball(self, **kwargs):
        """Nothing is downloaded: raise :class:`MissingGridError` naming the
        tarball's path and the URL to fetch it from (reference grid.py:80-87
        downloads it)."""
        tarball = self.get_tarball_file(**kwargs)
        if os.path.exists(tarball):
            return
        url = self.get_tarball_url(**kwargs)
        offline = "offline mode; " if config.OFFLINE else ""
        raise MissingGridError(
            f"{offline}grid files missing: no {tarball} and no extracted files under {self.datadir}. "
            f"This package downloads nothing: fetch {url} to {tarball} (or point $ISOCHRONES at a "
            f"directory that holds it)")

    def extract_tarball(self, **kwargs):
        """Extract the tarball that is on disk (reference grid.py:89-101);
        a corrupt one raises, naming its path."""
        tarball = self.get_tarball_file(**kwargs)
        if not os.path.exists(tarball):
            self.download_tarball(**kwargs)
        try:
            with tarfile.open(tarball) as tar:
                getLogger().info("Extracting %s...", tarball)
                tar.extractall(self.datadir, filter="data")
        except (EOFError, tarfile.ReadError) as e:
            raise MissingGridError(f"{tarball} is corrupt ({e}): fetch {self.get_tarball_url(**kwargs)} "
                                   "again") from None

    # ----------------------------------------------------------------- cache
    def get_cache_filename(self, orig=False):
        raise NotImplementedError

    def get_hdf_filename(self, **kwargs):
        """reference grid.py:67-68; the cache is an ``.npz`` file here"""
        return self.get_cache_filename(**kwargs)

    @property
    def hdf_filename(self):
        """reference grid.py:70-72"""
        return self.get_hdf_filename()

    def read_hdf(self, orig=False):
        """reference grid.py:103-110"""
        return self.read_cache(orig=orig)

    def write_hdf(self, orig=False):
        """reference grid.py:112-118"""
        return self.write_cache(orig=orig)

    def read_cache(self, orig=False):
        """The parsed table from its cache, rebuilt on any failure (reference
        read_hdf, grid.py:103-110)."""
        fn = self.get_cache_filename(orig=orig)
        try:
            return Table.load(fn)
        except (OSError, ValueError, KeyError):
            return self.write_cache(orig=orig)

    def write_cache(self, orig=False):
        """reference write_hdf, grid.py:112-118"""
        df = self.get_df(orig=orig)
        fn = self.get_cache_filename(orig=orig)
        df.save(fn)
        getLogger().info("grid cache written to %s.", fn)
        return df

    def get_df(self, orig=False):
        raise NotImplementedError

    @property
    def df(self):
        if self._df is None:
            self._df = self.read_cache()
        return self._df

    @property
    def df_orig(self):
        if self._df_orig is None:
            self._df_orig = self.read_cache(orig=True)
        return self._df_orig

    # ----------------------------------------------------------- interpolator
    def _interpolator(self, df, filename):
        return GridInterpolator(df, filename=filename, is_full=self.is_full, device=self.device, dtype=self.dtype)

    @property
    def interp(self):
        """Lazy dense interpolator (reference grid.py:133-137)."""
        if self._interp is None:
            self._interp = self._interpolator(self.df, getattr(self, "interp_grid_npz_filename", None))
        return self._interp

    @property
    def interp_orig(self):
        """Interpolator over the un-standardized table (reference grid.py:139-144)."""
        if self._interp_orig is None:
            self._interp_orig = self._interpolator(self.df_orig, getattr(self, "interp_grid_orig_npz_filename", None))
        return self._interp_orig

    @property
    def grid_data(self):
        return self.interp.grid_data


class StellarModelGrid(Grid):
    """Stellar-evolution grids with a standard column schema
    (reference models.py:26-250)."""

    default_columns = (
        "eep", "age", "feh", "mass", "initial_mass", "radius", "density",
        "logTeff", "Teff", "logg", "logL", "Mbol",
    )

    def get_dm_deep(self, compute=False):
        """d(initial_mass)/d(EEP) along isochrones (reference
        models.py:126-153); concrete grids implement it — see
        ``grids/mist.py::MISTIsochroneGrid.get_dm_deep``."""
        raise NotImplementedError

    @property
    def prop_map(self):
        """Standard-name -> raw-column mapping (reference models.py:44-56)."""
        return dict(
            eep=self.eep_col,
            age=self.age_col,
            feh=self.feh_col,
            mass=self.mass_col,
            initial_mass=self.initial_mass_col,
            logTeff=self.logTeff_col,
            logg=self.logg_col,
            logL=self.logL_col,
        )

    @property
    def column_map(self):
        return {v: k for k, v in self.prop_map.items()}

    @property
    def datadir(self):
        return os.path.join(config.ISOCHRONES, self.name)

    @property
    def kwarg_tag(self):
        raise NotImplementedError

    def get_directory_path(self, **kwargs):
        raise NotImplementedError

    def get_existing_filenames(self, **kwargs):
        """reference models.py:70-76"""
        d = self.get_directory_path(**kwargs)
        if not os.path.exists(d):
            self.extract_tarball(**kwargs)
        return [os.path.join(d, f) for f in sorted(os.listdir(d)) if re.search(self.filename_pattern, f)]

    def get_filenames(self, **kwargs):
        return self.get_existing_filenames(**kwargs)

    @classmethod
    def get_feh(cls, filename):
        raise NotImplementedError

    @classmethod
    def to_df(cls, filename):
        raise NotImplementedError

    def df_all(self):
        """Full original grid (reference models.py:91-99): every file's rows,
        sorted by and indexed on ``index_cols`` (kept as columns too)."""
        df = Table.concat([self.to_df(f) for f in self.get_filenames()])
        df = df.sort_values(by=list(self.index_cols))
        df.index = Index(self.index_cols, [df[c] for c in self.index_cols])
        return df

    def compute_additional_columns(self, df):
        """Teff/Mbol/radius/density (reference models.py:102-109)."""
        df["Teff"] = 10 ** df["logTeff"]
        df["Mbol"] = 4.74 - 2.5 * df["logL"]
        df["radius"] = 10 ** df["log_R"]
        df["density"] = df["mass"] * MSUN_CGS / (4.0 / 3 * np.pi * (df["radius"] * RSUN_CGS) ** 3)
        return df

    def get_df(self, orig=False):
        """Standardized grid (reference models.py:111-120)."""
        df = self.df_all()
        if not orig:
            df = df.rename(self.column_map)
            df = self.compute_additional_columns(df)
            df = df[list(self.default_columns)]
        return df

    def get_cache_filename(self, orig=False):
        tag = "_orig" if orig else ""
        return os.path.join(self.datadir, f"{self.name}{self.kwarg_tag}{tag}{CACHE_SUFFIX}")

    @property
    def interp_grid_npz_filename(self):
        return os.path.join(self.datadir, f"full_grid{self.kwarg_tag}{CACHE_SUFFIX}")

    # ------------------------------------------------- EEP-inversion support
    @property
    def array_grid_filename(self):
        return os.path.join(self.datadir, f"array_grid{self.kwarg_tag}{CACHE_SUFFIX}")

    def get_array_grids(self, recalc=False):
        """Ragged per-(level 0, level 1) age matrices for the fast EEP
        inversion (reference models.py:171-205): ``(age (+inf padded),
        dt_deep (NaN padded), lengths)``."""
        fn = self.array_grid_filename
        if recalc or not os.path.exists(fn):
            if self.eep_replaces != "age":
                raise NotImplementedError("Not implemented for isochrone grids (as in reference)")
            df = self.df
            ii0, ii1 = df.index.levels[:2]
            n = len(ii0) * len(ii1)
            n_eep = self.n_eep
            age_arrays = np.full((n, n_eep), np.inf)
            dt_arrays = np.full((n, n_eep), np.nan)
            lengths = np.zeros(n, dtype=int)
            age, dt = df["age"], df["dt_deep"]
            for (x0, x1), rows in df.groups(2):
                i = int(np.searchsorted(ii0, x0)) * len(ii1) + int(np.searchsorted(ii1, x1))
                lengths[i] = len(rows)
                age_arrays[i, : len(rows)] = age[rows]
                dt_arrays[i, : len(rows)] = dt[rows]
            os.makedirs(os.path.dirname(fn), exist_ok=True)
            tmp = f"{fn}.tmp.{os.getpid()}.npz"
            np.savez(tmp, age=age_arrays, dt_deep=dt_arrays, lengths=lengths)
            os.replace(tmp, fn)
        with np.load(fn, allow_pickle=False) as d:
            return d["age"], d["dt_deep"], d["lengths"]

    def _load_array_grids(self):
        if getattr(self, "_age_grid", None) is None:
            self._age_grid, self._dt_deep_grid, self._array_lengths = self.get_array_grids()

    @property
    def age_grid(self):
        """reference models.py:211-220"""
        self._load_array_grids()
        return self._age_grid

    @property
    def dt_deep_grid(self):
        """reference models.py:222-231"""
        self._load_array_grids()
        return self._dt_deep_grid

    @property
    def array_lengths(self):
        """reference models.py:233-243"""
        self._load_array_grids()
        return self._array_lengths

    @property
    def interp_grid_orig_npz_filename(self):
        """reference models.py:167-169"""
        return os.path.join(self.datadir, f"full_grid_orig{self.kwarg_tag}{CACHE_SUFFIX}")

    @property
    def n_masses(self):
        """reference models.py:244-250"""
        return len(self.df.index.levels[1])


class BolometricCorrectionGrid(Grid):
    """Bolometric-correction tables per photometric system
    (reference bc.py:9-118)."""

    index_cols = ("Teff", "logg", "[Fe/H]", "Av", "Rv")
    name = None
    is_full = True

    def __init__(self, bands=None, **kwargs):
        super().__init__(**kwargs)
        self.bands = list(bands) if bands is not None else list(self.default_bands)
        self._band_map = None
        self._phot_systems = None

    def get_band(self, *args, **kwargs):
        raise NotImplementedError

    def _make_band_map(self):
        """reference bc.py:42-50"""
        phot_systems = set()
        band_map = {}
        for b in self.bands:
            phot, band = self.get_band(b)
            phot_systems.add(phot)
            band_map[b] = band
        self._band_map = band_map
        self._phot_systems = phot_systems

    @property
    def band_map(self):
        if self._band_map is None:
            self._make_band_map()
        return self._band_map

    @property
    def phot_systems(self):
        if self._phot_systems is None:
            self._make_band_map()
        return self._phot_systems

    @property
    def datadir(self):
        return os.path.join(config.ISOCHRONES, "BC", self.name)

    def get_filename(self, phot, feh):
        """reference bc.py:68-72"""
        sign_str = "m" if feh < 0 else "p"
        return os.path.join(self.datadir, "feh{0}{1:03.0f}.{2}".format(sign_str, abs(feh) * 100, phot))

    def parse_table(self, filename):
        """Whitespace BC table -> indexed :class:`Table` (reference
        bc.py:74-84); column names live on (comment) line 6."""
        from .parse import read_whitespace_table

        with open(filename, encoding="latin-1") as fin:
            for i, line in enumerate(fin):
                if i == 5:
                    names = line[1:].split()
                    break
        return read_whitespace_table(filename, names=names).set_index(list(self.index_cols))

    def get_table(self, phot, feh):
        return self.parse_table(self.get_filename(phot, feh))

    def get_cache_filename(self, phot=None, orig=False):
        """Per-system raw-table cache when ``phot`` is given; otherwise the
        merged-table cache the inherited read/write_cache paths use."""
        if phot is None:
            tag = "_orig" if orig else ""
            return os.path.join(self.datadir, f"bc_merged{tag}{CACHE_SUFFIX}")
        return os.path.join(self.datadir, f"{phot}{CACHE_SUFFIX}")

    def get_tarball_url(self, phot):
        return f"http://waps.cfa.harvard.edu/MIST/BC_tables/{phot}.txz"

    def get_tarball_file(self, phot):
        return os.path.join(self.datadir, f"{phot}.txz")

    def _system_files(self, phot):
        """The system's tables, sorted by name (the JAX package's glob order
        is the file system's; the sort below makes the order moot)."""
        import glob

        return sorted(glob.glob(os.path.join(self.datadir, f"*.{phot}")))

    def get_df(self, orig=False):
        """Merge systems column-wise, rename to shortcut names
        (reference bc.py:99-118)."""
        tables = []
        for phot in sorted(self.phot_systems):
            def build(phot=phot):
                filenames = self._system_files(phot)
                if not filenames:
                    self.extract_tarball(phot=phot)
                    filenames = self._system_files(phot)
                return Table.concat([self.parse_table(f) for f in filenames]).sort_index()

            tables.append(_read_or_build(self.get_cache_filename(phot=phot), build))
        df_all = Table.join_columns(tables)

        if orig:
            return df_all  # merged, original column names
        df_all = df_all.rename({v: k for k, v in self.band_map.items()})
        return df_all[[c for c in df_all.columns if c in self.bands]]

    @property
    def df(self):
        if self._df is None:
            self._df = self.get_df()
        return self._df
