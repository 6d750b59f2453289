"""MIST grid pipeline (counterpart of ``isochrones_tpu/grids/mist.py``).

Reference ``isochrones/mist/models.py`` (``MISTModelGrid``,
``MISTIsochroneGrid``, ``MISTBasicIsochroneGrid``, ``MISTEvolutionTrackGrid``)
and ``isochrones/mist/bc.py`` (``MISTBolometricCorrectionGrid``): tarball
URLs and paths, the ``.iso`` / ``.track.eep`` / BC-table parsers, ragged-track
completion by neighbour-mass interpolation, the dt/dEEP and dm/dEEP
derivative columns, per-track eep(age) curve fits and the band shortcuts of
14 photometric systems. The product is a pair of
:class:`~isochrones_torch.ops.interp.GridData` tables on the device, read by
the interpolators and the kernels.

The files are read from ``config.ISOCHRONES`` (``$ISOCHRONES``) in MIST's own
layout; nothing is downloaded (:class:`~isochrones_torch.grids.base.MissingGridError`
names the missing path and the URL).
"""

from __future__ import annotations

import glob
import itertools
import os
import re
from functools import partial

import numpy as np
import torch

from .. import config
from ..eep_fit import eep_fn, eep_fn_p0, eep_jac, fit_section_poly
from ..logger import getLogger
from .base import CACHE_SUFFIX, BolometricCorrectionGrid, Index, StellarModelGrid, Table, _read_or_build
from .mist_eep import max_eep
from .parse import read_whitespace_table

__all__ = [
    "MISTModelGrid",
    "MISTIsochroneGrid",
    "MISTBasicIsochroneGrid",
    "MISTEvolutionTrackGrid",
    "MISTBolometricCorrectionGrid",
    "get_mist_interpolators",
]


def _read_header(filename, pattern, what):
    """The column names on the first line of ``filename`` (read as latin-1)
    that matches ``pattern``, and the lines before it."""
    before = []
    with open(filename, "r", encoding="latin-1") as fin:
        for line in fin:
            if re.match(pattern, line):
                return line[1:].split(), before
            before.append(line)
    raise ValueError(f"No {what} header found in {filename}")


class MISTModelGrid(StellarModelGrid):
    """Common MIST metadata (reference mist/models.py:23-91)."""

    name = "mist"
    eep_col = "EEP"
    age_col = "log10_isochrone_age_yr"
    feh_col = "[Fe/H]"
    mass_col = "star_mass"
    initial_mass_col = "initial_mass"
    logTeff_col = "log_Teff"
    logg_col = "log_g"
    logL_col = "log_L"

    default_kwargs = {"version": "1.2", "vvcrit": 0.4, "kind": "full_isos"}
    default_columns = StellarModelGrid.default_columns + ("delta_nu", "nu_max", "phase")

    bounds = (("age", (5, 10.13)), ("feh", (-4, 0.5)), ("eep", (0, 1710)), ("mass", (0.1, 300)))

    fehs = np.array([
        -4.00, -3.50, -3.00, -2.50, -2.00, -1.75, -1.50, -1.25, -1.00,
        -0.75, -0.50, -0.25, 0.00, 0.25, 0.50,
    ])
    n_fehs = 15

    primary_eeps = (1, 202, 353, 454, 605, 631, 707, 808, 1409, 1710)
    eep_labels = ("PMS", "ZAMS", "IAMS", "TAMS", "RGBTip", "ZAHB", "TAHB", "TPAGB", "post-AGB", "WDCS")
    eep_labels_highmass = ("PMS", "ZAMS", "IAMS", "TAMS", "RGBTip", "ZACHeB", "TACHeB", "C-burn")
    n_eep = 1710

    def max_eep(self, mass, feh):
        return max_eep(mass, feh)

    @property
    def eep_sections(self):
        return list(zip(self.primary_eeps[:-1], self.primary_eeps[1:]))

    @property
    def kwarg_tag(self):
        return "_v{version}_vvcrit{vvcrit}".format(**self.kwargs)

    def compute_additional_columns(self, df):
        """+ the surface [Fe/H] (reference mist/models.py:81-86). It replaces
        the column ``feh``; an isochrone table's index level ``feh`` keeps the
        file name's [Fe/H]."""
        df = super().compute_additional_columns(df)
        df["feh"] = df["log_surf_z"] - np.log10(df["surface_h1"]) - np.log10(0.0181)
        return df


class MISTIsochroneGrid(MISTModelGrid):
    """Isochrone tables indexed (log10_age, feh, EEP)
    (reference mist/models.py:94-148)."""

    index_cols = ("log10_isochrone_age_yr", "feh", "EEP")
    filename_pattern = r"\.iso$"
    eep_replaces = "mass"

    @property
    def kwarg_tag(self):
        return super().kwarg_tag + "_{kind}".format(**self.kwargs)

    def get_directory_path(self, **kwargs):
        return os.path.join(self.datadir, f"MIST{self.kwarg_tag}")

    def get_tarball_file(self, **kwargs):
        return self.get_directory_path(**kwargs) + ".txz"

    def get_tarball_url(self, **kwargs):
        return (
            "http://waps.cfa.harvard.edu/MIST/data/tarballs"
            "_v{version}/MIST_v{version}_vvcrit{vvcrit}_{kind}.txz".format(**self.kwargs)
        )

    @classmethod
    def get_feh(cls, filename):
        """reference mist/models.py:127-134"""
        m = re.search(r"feh_([mp])([0-9]\.[0-9]{2})_afe", filename)
        if not m:
            raise ValueError(f"{filename} not a valid MIST file? Cannot parse [Fe/H]")
        return float(m.group(2)) * (1 if m.group(1) == "p" else -1)

    @classmethod
    def to_df(cls, filename):
        """.iso parser (reference mist/models.py:135-148): column names on
        the '# EEP ...' header line; feh from the filename."""
        column_names, _ = _read_header(filename, "# EEP", "'# EEP'")
        df = read_whitespace_table(filename, names=column_names)
        df["feh"] = cls.get_feh(filename)
        return df

    def get_dm_deep(self):
        """d(initial_mass)/d(EEP) along each (age, feh) isochrone, a column
        in table order (reference models.py:126-153); an isochrone of one
        row makes ``np.gradient`` raise, as in the JAX package."""

        def build():
            df = self.read_cache()
            out = np.full(len(df), np.nan)
            mass, eep = df["initial_mass"], df["eep"]
            for _, rows in df.groups(2):
                out[rows] = np.gradient(mass[rows], eep[rows])
            return Table({"dm_deep": out})

        fn = os.path.join(self.datadir, f"dm_deep{self.kwarg_tag}{CACHE_SUFFIX}")
        return _read_or_build(fn, build)["dm_deep"]

    @property
    def df(self):
        if self._df is None:
            self._df = self.read_cache()
            self._df["dm_deep"] = self.get_dm_deep()
        return self._df


class MISTBasicIsochroneGrid(MISTIsochroneGrid):
    """basic_isos variant (reference mist/models.py:151-161)."""

    default_kwargs = {"version": "1.2", "vvcrit": 0.4, "kind": "basic_isos"}
    default_columns = StellarModelGrid.default_columns + ("phase",)

    def compute_additional_columns(self, df):
        # basic tables lack the surface-abundance columns
        return StellarModelGrid.compute_additional_columns(self, df)


class MISTEvolutionTrackGrid(MISTModelGrid):
    """Evolution tracks indexed (initial_feh, initial_mass, EEP)
    (reference mist/models.py:164-556)."""

    default_kwargs = {"version": "1.2", "vvcrit": 0.4, "afe": 0.0}
    index_cols = ("initial_feh", "initial_mass", "EEP")
    # a fixed order (a set difference would change with the str hash)
    default_columns = tuple(
        c for c in MISTModelGrid.default_columns if c != "age"
    ) + ("interpolated", "star_age", "age")
    filename_pattern = r"\.track\.eep$"
    eep_replaces = "age"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._approx_eep_interp = None
        self._eep_interps = None
        self._primary_eeps_arr = None
        self._masses = None

    @property
    def datadir(self):
        return os.path.join(config.ISOCHRONES, self.name, "tracks")

    @property
    def kwarg_tag(self):
        return "_v{version}_vvcrit{vvcrit}".format(**self.kwargs)

    @property
    def prop_map(self):
        """Tracks have no age column to map (reference mist/models.py:208-217)."""
        return dict(
            eep=self.eep_col, mass=self.mass_col, initial_mass=self.initial_mass_col,
            logTeff=self.logTeff_col, logg=self.logg_col, logL=self.logL_col,
        )

    def compute_additional_columns(self, df):
        df = super().compute_additional_columns(df)
        df["age"] = np.log10(df["star_age"])
        return df

    # ------------------------------------------------------------- locations
    def get_file_basename(self, feh):
        """reference mist/models.py:229-241"""
        feh_sign = "m" if feh < 0 else "p"
        afe = self.kwargs["afe"]
        afe_sign = "m" if afe < 0 else "p"
        return (
            "MIST_v{version}_feh_{fs}{feh:.2f}_afe_{as_}{afe:.1f}_vvcrit{vvcrit:.1f}_EEPS".format(
                version=self.kwargs["version"], fs=feh_sign, feh=abs(feh),
                as_=afe_sign, afe=abs(afe), vvcrit=self.kwargs["vvcrit"],
            )
        )

    def get_directory_path(self, feh):
        return os.path.join(self.datadir, self.get_file_basename(feh))

    def get_tarball_url(self, feh):
        return "http://waps.cfa.harvard.edu/MIST/data/tarballs_v{version}/{base}.txz".format(
            version=self.kwargs["version"], base=self.get_file_basename(feh)
        )

    def get_tarball_file(self, feh):
        return os.path.join(self.datadir, self.get_file_basename(feh) + ".txz")

    def download_and_extract_all(self):
        """Extract every [Fe/H]'s tarball that is on disk (nothing is
        downloaded)."""
        for feh in self.fehs:
            self.extract_tarball(feh=feh)

    # --------------------------------------------------------------- parsing
    @classmethod
    def get_mass(cls, filename):
        """reference mist/models.py:262-268"""
        m = re.search(r"(\d{5})M.track.eep", filename)
        if not m:
            raise ValueError(f"Cannot parse mass from {filename}.")
        return float(m.group(1)) / 100.0

    @classmethod
    def to_df(cls, filename):
        """.track.eep parser (reference mist/models.py:264-289): EEP range
        from the '# EEPs: ...' header, column names from '#  star_age ...'."""
        column_names, before = _read_header(filename, r"#\s+star_age", "column")
        eep_first = eep_last = None
        for line in before:
            if re.match("^# EEPs", line):
                parts = line.split()
                eep_first = int(parts[2])
                eep_last = int(parts[-1])
        df = read_whitespace_table(filename, names=column_names)
        df["initial_mass"] = cls.get_mass(filename)
        if eep_first is not None and eep_last - eep_first + 1 == len(df):
            df["EEP"] = np.arange(eep_first, eep_last + 1, dtype=int)
        else:
            getLogger().warning(
                "len(df)=%d but header EEPs are %s..%s in %s; numbering from first",
                len(df), eep_first, eep_last, filename,
            )
            start = eep_first if eep_first is not None else 1
            df["EEP"] = np.arange(start, start + len(df), dtype=int)
        return df

    def get_feh_filenames(self, feh):
        directory = self.get_directory_path(feh)
        if not os.path.exists(directory):
            self.extract_tarball(feh=feh)
        return sorted(glob.glob(os.path.join(directory, "*.track.eep")))

    def get_feh_cache_filename(self, feh, interpolated=False):
        tag = "_interpolated" if interpolated else ""
        return os.path.join(self.get_directory_path(feh), f"all_masses{tag}{CACHE_SUFFIX}")

    def get_feh_hdf_filename(self, feh):
        """Per-feh all-masses cache path (reference mist/models.py:297-299);
        an ``.npz`` file here."""
        return self.get_feh_cache_filename(feh)

    def get_feh_interpolated_hdf_filename(self, feh):
        """Per-feh completed-track cache path (reference
        mist/models.py:301-303); an ``.npz`` file here."""
        return self.get_feh_cache_filename(feh, interpolated=True)

    @property
    def masses(self):
        """Initial-mass grid values (reference mist/models.py:186-190)."""
        if self._masses is None:
            self._masses = np.array(self.df.index.levels[1])
        return self._masses

    def df_all_feh(self, feh):
        """All masses at one feh (reference mist/models.py:297-309)."""

        def build():
            df = Table.concat([self.to_df(f) for f in self.get_feh_filenames(feh)])
            df["initial_feh"] = feh
            df = df.sort_values(by=list(self.index_cols))
            df.index = Index(self.index_cols, [df[c] for c in self.index_cols])
            return df

        return _read_or_build(self.get_feh_cache_filename(feh), build)

    def df_all_feh_interpolated(self, feh):
        """Ragged-track tail completion by linear interpolation between the
        nearest complete neighbor masses (reference mist/models.py:318-389):
        a track shorter than ``max_eep(mass, feh)`` is continued to it, its
        new rows flagged in the column ``interpolated``; a missing lighter or
        heavier complete neighbour raises ``ValueError``."""
        return _read_or_build(self.get_feh_cache_filename(feh, interpolated=True),
                              partial(self._complete_tracks, feh))

    def _complete_tracks(self, feh):
        getLogger().info("Interpolating incomplete tracks for feh = %s", feh)
        df = self.df_all_feh(feh)
        df_interp = df.copy()
        df_interp["interpolated"] = False
        masses = df.index.levels[1]
        i_mass = df.index.names.index("initial_mass")
        tracks = {m: df.xs(m, level="initial_mass") for m in masses}
        track_len = {m: len(tracks[m]) for m in masses}
        values = df.values

        new_frames = []
        for i, m in enumerate(masses):
            n_eep = track_len[m]
            eep_max = self.max_eep(m, feh)
            if not eep_max:
                raise ValueError(f"No eep_max return value for ({m}, {feh})?")
            if n_eep >= eep_max:
                continue

            # nearest complete neighbors below/above (mist/models.py:340-363)
            ilo = i
            while True:
                ilo -= 1
                if ilo < 0:
                    raise ValueError(f"Did not find mlo for ({m}, {feh})")
                if track_len[masses[ilo]] >= eep_max:
                    mlo = masses[ilo]
                    break
            ihi = i
            while True:
                ihi += 1
                if ihi >= len(masses):
                    raise ValueError(f"Did not find mhi for ({m}, {feh})")
                if track_len[masses[ihi]] >= eep_max:
                    mhi = masses[ihi]
                    break

            getLogger().info("%s: %s (expected %s). Interpolating between %s and %s",
                             m, n_eep, eep_max, mlo, mhi)
            new_eeps = np.arange(n_eep + 1, eep_max + 1)
            t = (m - mlo) / (mhi - mlo)
            interp_vals = (values[self._track_rows(df, i_mass, feh, mlo, new_eeps)] * (1 - t)
                           + values[self._track_rows(df, i_mass, feh, mhi, new_eeps)] * t)
            new_data = Table({c: interp_vals[:, j] for j, c in enumerate(df.columns)},
                             Index(self.index_cols, [np.full(len(new_eeps), feh), np.full(len(new_eeps), m),
                                                     new_eeps]))
            new_data["initial_mass"] = m
            new_data["EEP"] = new_eeps
            new_data["interpolated"] = True
            new_frames.append(new_data)

        if new_frames:
            df_interp = Table.concat([df_interp] + new_frames)
        df_interp = df_interp.sort_index()
        df_interp.index.names = list(self.index_cols)
        return df_interp

    @staticmethod
    def _track_rows(df, i_mass, feh, mass, eeps):
        """Positions of the rows (feh, mass, each of ``eeps``); a missing row
        raises ``KeyError`` as ``DataFrame.loc`` does."""
        fehs, ms, es = df.index.arrays
        rows = np.nonzero((fehs == feh) & (ms == mass))[0]
        pos = np.searchsorted(es[rows], eeps)
        pos = np.clip(pos, 0, max(len(rows) - 1, 0))
        if len(rows) == 0 or not np.array_equal(es[rows][pos], eeps):
            raise KeyError(f"track ({feh}, {mass}) lacks some of EEPs {eeps[0]}..{eeps[-1]}")
        return rows[pos]

    def df_all(self):
        """reference mist/models.py:391-393"""
        return Table.concat([self.df_all_feh_interpolated(feh) for feh in self.fehs])

    @property
    def df(self):
        if self._df is None:
            self._df = self.read_cache()
            self._df["dt_deep"] = self.get_dt_deep()
        return self._df

    def get_dt_deep(self):
        """d(log age)/dEEP along each track, a column in table order
        (reference mist/models.py:403-435)."""

        def build():
            df = self.read_cache()
            out = np.full(len(df), np.nan)
            log_age, eep = np.log10(df["star_age"]), df["eep"]
            for _, rows in df.groups(2):
                out[rows] = np.gradient(log_age[rows], eep[rows])
            return Table({"dt_deep": out})

        fn = os.path.join(self.datadir, f"dt_deep{self.kwarg_tag}{CACHE_SUFFIX}")
        return _read_or_build(fn, build)["dt_deep"]

    # --------------------------------------------------- eep(age) curve fits
    @property
    def eep_param_filename(self):
        return os.path.join(self.datadir, f"eep_params{self.kwarg_tag}{CACHE_SUFFIX}")

    def _track(self, feh, m):
        return self.df.xs((feh, m), level=("initial_feh", "initial_mass"))

    def _param_table(self, values, columns):
        fehs, ms = self.df.index.levels[:2]
        F, M = (a.ravel() for a in np.meshgrid(fehs, ms, indexing="ij"))
        return Table({c: values[:, j] for j, c in enumerate(columns)}, Index((None, None), (F, M)))

    def fit_eep_section(self, a, b, order=3):
        """Per-(feh, mass) section polynomial (reference mist/models.py:441-462):
        a table indexed by the (feh, mass) product, columns ``p0..p{order}``
        (NaN where a track has too few points in the section)."""
        fehs, ms = self.df.index.levels[:2]
        columns = [f"p{o}" for o in range(order + 1)]
        vals = np.full((len(fehs) * len(ms), order + 1), np.nan)
        for i, (feh, m) in enumerate(itertools.product(fehs, ms)):
            subdf = self._track(feh, m)
            try:
                p = fit_section_poly(subdf["age"], subdf["eep"], a, b, order)
            except (TypeError, ValueError):
                p = [np.nan] * (order + 1)
            for c, n in zip(p, range(order + 1)):
                vals[i, n] = c
        return self._param_table(vals, columns)

    def fit_approx_eep(self, max_fit_eep=808):
        """Per-track eep(age) poly+exponential fit (reference mist/models.py:464-490)."""
        from scipy.optimize import curve_fit

        fehs, ms = self.df.index.levels[:2]
        columns = ["p5", "p4", "p3", "p2", "p1", "p0", "A", "x0", "tau"]
        vals = np.full((len(fehs) * len(ms), len(columns)), np.nan)
        for i, (feh, m) in enumerate(itertools.product(fehs, ms)):
            subdf = self._track(feh, m)
            age, eep = subdf["age"], subdf["eep"]
            p0 = eep_fn_p0(age, eep)
            last_pfit = p0  # reference resets this per track (mist/models.py:476)
            mask = eep < max_fit_eep
            try:
                if eep.max() < 500:
                    raise RuntimeError
                pfit, _ = curve_fit(eep_fn, age[mask], eep[mask], p0, jac=eep_jac)
            except RuntimeError:
                # polynomial-only fallback (A=0), reference mist/models.py:483-485
                pfit = list(np.polyfit(age[mask], eep[mask], 5)) + list(last_pfit[-3:])
                pfit[-3] = 0
            vals[i] = pfit
        return self._param_table(vals, columns)

    def write_eep_params(self, orders=None):
        """reference mist/models.py:492-501"""
        if orders is None:
            orders = [7] * 2 + [3] + [1] * 6
        data = {}
        for (a, b), o in zip(self.eep_sections, orders):
            df = self.fit_eep_section(a, b, order=o)
            data[f"eep_{a:.0f}_{b:.0f}"] = df.values
            data[f"eep_{a:.0f}_{b:.0f}_ncol"] = np.array([df.shape[1]])
        data["approx"] = self.fit_approx_eep().values
        data["fehs"] = np.asarray(self.df.index.levels[0], dtype=float)
        data["masses"] = np.asarray(self.df.index.levels[1], dtype=float)
        os.makedirs(self.datadir, exist_ok=True)
        np.savez(self.eep_param_filename, **data)

    def _load_eep_params(self):
        if not os.path.exists(self.eep_param_filename):
            self.write_eep_params()
        with np.load(self.eep_param_filename, allow_pickle=False) as d:
            return {k: d[k] for k in d.files}

    def _coeff_interp(self, vals, fehs, ms, columns):
        from ..convert import grid_from_numpy
        from ..ops.interp import GridInterpolator

        gd = grid_from_numpy(vals, (fehs, ms), columns, device=self.device, dtype=self.dtype)
        return GridInterpolator(grid_data=gd)

    def get_eep_interps(self):
        """Per-section coefficient interpolators (reference mist/models.py:503-511)."""
        d = self._load_eep_params()
        fehs, ms = d["fehs"], d["masses"]
        interps = []
        for a, b in self.eep_sections:
            vals = d[f"eep_{a:.0f}_{b:.0f}"].reshape(len(fehs), len(ms), -1)
            interps.append(self._coeff_interp(vals, fehs, ms, tuple(f"p{i}" for i in range(vals.shape[-1]))))
        return interps

    def get_approx_eep_interp(self):
        d = self._load_eep_params()
        fehs, ms = d["fehs"], d["masses"]
        vals = d["approx"].reshape(len(fehs), len(ms), -1)
        return self._coeff_interp(vals, fehs, ms, ("p5", "p4", "p3", "p2", "p1", "p0", "A", "x0", "tau"))

    @property
    def approx_eep_interp(self):
        if self._approx_eep_interp is None:
            self._approx_eep_interp = self.get_approx_eep_interp()
        return self._approx_eep_interp

    @property
    def eep_interps(self):
        if self._eep_interps is None:
            self._eep_interps = self.get_eep_interps()
        return self._eep_interps

    @property
    def primary_eeps_arr(self):
        """Primary EEPs as an array (reference mist/models.py:530-534)."""
        if self._primary_eeps_arr is None:
            self._primary_eeps_arr = np.array(self.primary_eeps)
        return self._primary_eeps_arr

    def get_eep_fit(self, mass, age, feh, approx=False):
        """Fast eep(mass, age, feh) via the fitted curves
        (reference mist/models.py:536-556)."""
        pars = np.asarray(self.approx_eep_interp([feh, mass], "all")).squeeze()
        eep = float(eep_fn(np.atleast_1d(age), *pars)[0])
        if approx:
            return eep
        i = int(np.searchsorted(self.primary_eeps_arr, eep))
        if i - 1 < len(self.eep_interps):
            coeffs = np.asarray(self.eep_interps[max(i - 1, 0)]([feh, mass], "all")).squeeze()
            return float(np.polyval(coeffs, age))
        if age > pars[-2]:
            coeffs = np.asarray(self.eep_interps[-1]([feh, mass], "all")).squeeze()
            return float(np.polyval(coeffs, age))
        getLogger().warning(
            "EEP conversion failed for mass=%s, age=%s, feh=%s (approx eep=%s). Returning nan.",
            mass, age, feh, eep,
        )
        return np.nan

    def view_eep_fit(self, mass, feh, plot_fit=True, order=5, p0=None, plot_p0=False, ax=None):
        """Diagnostic plot of the eep(age) fit for one track (reference
        mist/models.py:558-596; matplotlib, imported here): the track's (age,
        eep) points, primary-EEP markers and (optionally) the fitted
        ``eep_fn`` curve. Returns the matplotlib Axes."""
        import matplotlib.pyplot as plt
        from scipy.optimize import curve_fit

        subdf = self.df.xs((mass, feh), level=("initial_mass", "initial_feh"))
        ages = subdf["age"]
        eeps = subdf["eep"]
        eep_index = subdf.index.arrays[0]

        if ax is None:
            _, ax = plt.subplots(figsize=(10, 5))
        ax.plot(ages, eeps, "+", color="C0", label="track")
        prim = [(ages[np.nonzero(eep_index == e)[0][0]], e) for e in self.primary_eeps
                if e < eeps.max() and e in eep_index]
        if prim:
            pa, pe = zip(*prim)
            ax.plot(pa, pe, "o", color="C1", ms=8, label="primary EEPs")

        if p0 is None:
            p0 = eep_fn_p0(ages, eeps, order=order)
        m = eeps < 808
        if plot_fit:
            import warnings

            from scipy.optimize import OptimizeWarning

            with warnings.catch_warnings():
                # diagnostic overlay only; the covariance (discarded below)
                # is often singular on short tracks
                warnings.simplefilter("ignore", OptimizeWarning)
                pfit, _ = curve_fit(
                    partial(eep_fn, order=order), ages[m], eeps[m], p0,
                    jac=partial(eep_jac, order=order),
                )
            ax.plot(ages, eep_fn(ages, *pfit, order=order), "-", color="C2", label="fit")
        if plot_p0:
            ax.plot(ages, eep_fn(ages, *p0, order=order), "--", color="C3", label="p0")
        ax.set_xlabel("log10(age)")
        ax.set_ylabel("EEP")
        ax.set_title(f"mass={mass}, feh={feh}")
        ax.legend()
        return ax


class MISTBolometricCorrectionGrid(BolometricCorrectionGrid):
    """MIST BC tables: 14 photometric systems, Rv fixed at 3.1
    (reference mist/bc.py)."""

    name = "mist"

    phot_bands = dict(
        UBVRIplus=[
            "Bessell_U", "Bessell_B", "Bessell_V", "Bessell_R", "Bessell_I",
            "2MASS_J", "2MASS_H", "2MASS_Ks", "Kepler_Kp", "Kepler_D51",
            "Hipparcos_Hp", "Tycho_B", "Tycho_V", "Gaia_G_DR2Rev",
            "Gaia_BP_DR2Rev", "Gaia_RP_DR2Rev", "Gaia_G_MAW", "Gaia_BP_MAWf",
            "Gaia_BP_MAWb", "Gaia_RP_MAW", "TESS",
        ],
        WISE=["WISE_W1", "WISE_W2", "WISE_W3", "WISE_W4"],
        CFHT=["CFHT_u", "CFHT_g", "CFHT_r", "CFHT_i_new", "CFHT_i_old", "CFHT_z"],
        DECam=["DECam_u", "DECam_g", "DECam_r", "DECam_i", "DECam_z", "DECam_Y"],
        GALEX=["GALEX_FUV", "GALEX_NUV"],
        JWST=[
            "F070W", "F090W", "F115W", "F140M", "F150W2", "F150W", "F162M",
            "F164N", "F182M", "F187N", "F200W", "F210M", "F212N", "F250M",
            "F277W", "F300M", "F322W2", "F323N", "F335M", "F356W", "F360M",
            "F405N", "F410M", "F430M", "F444W", "F460M", "F466N", "F470N", "F480M",
        ],
        LSST=["LSST_u", "LSST_g", "LSST_r", "LSST_i", "LSST_z", "LSST_y"],
        PanSTARRS=["PS_g", "PS_r", "PS_i", "PS_z", "PS_y", "PS_w", "PS_open"],
        SkyMapper=[
            "SkyMapper_u", "SkyMapper_v", "SkyMapper_g", "SkyMapper_r",
            "SkyMapper_i", "SkyMapper_z",
        ],
        SDSSugriz=["SDSS_u", "SDSS_g", "SDSS_r", "SDSS_i", "SDSS_z"],
        HST_ACSHR=["ACS_HRC_F330W", "ACS_HRC_F555W", "ACS_HRC_F775W"],
        HST_ACSWF=["ACS_WFC_F435W", "ACS_WFC_F606W", "ACS_WFC_F814W"],
        HST_WFC3=["WFC3_UVIS_F336W", "WFC3_UVIS_F555W", "WFC3_UVIS_F814W"],
        UKIDSS=["UKIDSS_Z", "UKIDSS_Y", "UKIDSS_J", "UKIDSS_H", "UKIDSS_K"],
    )

    default_bands = ("J", "H", "K", "G", "BP", "RP", "W1", "W2", "W3", "TESS", "Kepler")

    def get_df(self, *args, **kwargs):
        """Rv=3.1 cross-section -> effective 4-d grid
        (reference mist/bc.py:160-163)."""
        df = super().get_df(*args, **kwargs)
        return df.xs(3.1, level="Rv")

    @classmethod
    def get_band(cls, b, **kwargs):
        """Shortcut-name -> (photometric system, column) resolution
        (reference mist/bc.py:166-233)."""
        phot = None
        band = None
        if b in ("u", "g", "r", "i", "z"):
            phot, band = "SDSSugriz", f"SDSS_{b}"
        elif b in ("U", "B", "V", "R", "I"):
            phot, band = "UBVRIplus", f"Bessell_{b}"
        elif b in ("J", "H", "Ks"):
            phot, band = "UBVRIplus", f"2MASS_{b}"
        elif b == "K":
            phot, band = "UBVRIplus", "2MASS_Ks"
        elif b in ("kep", "Kepler", "Kp"):
            phot, band = "UBVRIplus", "Kepler_Kp"
        elif b == "TESS":
            phot, band = "UBVRIplus", "TESS"
        elif b in ("W1", "W2", "W3", "W4"):
            phot, band = "WISE", f"WISE_{b}"
        elif b in ("G", "BP", "RP"):
            phot, band = "UBVRIplus", f"Gaia_{b}_DR2Rev"
        elif b == "Bp":
            phot, band = "UBVRIplus", "Gaia_BP_DR2Rev"
        elif b == "Rp":
            phot, band = "UBVRIplus", "Gaia_RP_DR2Rev"
        else:
            m = re.match(r"([a-zA-Z]+)_([a-zA-Z_0-9]+)", b)
            if m:
                if m.group(1) in cls.phot_bands:
                    phot = m.group(1)
                    band = f"PS_{m.group(2)}" if phot == "PanSTARRS" else m.group(0)
                elif m.group(1) in ("UK", "UKIRT"):
                    phot, band = "UKIDSS", f"UKIDSS_{m.group(2)}"
        if phot is None:
            for system, bands in cls.phot_bands.items():
                if b in bands:
                    phot, band = system, b
                    break
        if phot is None:
            raise ValueError(f"MIST grids cannot resolve band {b}!")
        return phot, band


def get_mist_interpolators(bands=None, basic=False, device="cuda", dtype=torch.float64, **kwargs):
    """``(IsochroneInterpolator, EvolutionTrackInterpolator)`` on ``device``
    (the card unless the caller passes ``device="cpu"``) in ``dtype``, from
    the MIST files under ``config.ISOCHRONES`` (the ``get_ichrone("mist")``
    backend; reference mist/isochrone.py:6-33). Raises
    :class:`~isochrones_torch.grids.base.MissingGridError`, naming the path,
    where a file is missing."""
    from ..models import EvolutionTrackInterpolator, IsochroneInterpolator

    iso_cls = MISTBasicIsochroneGrid if basic else MISTIsochroneGrid
    where = dict(device=device, dtype=dtype)
    iso_grid = iso_cls(**where, **{k: v for k, v in kwargs.items() if k in ("version", "vvcrit", "kind")})
    track_grid = MISTEvolutionTrackGrid(
        **where, **{k: v for k, v in kwargs.items() if k in ("version", "vvcrit", "afe")})
    bc_grid = MISTBolometricCorrectionGrid(bands=bands, **where)

    bc_data = bc_grid.grid_data
    age_arrays, dt_arrays, lengths = track_grid.get_array_grids()
    track_data = track_grid.grid_data
    dev = track_data.values.device
    eep_support = (
        track_data.knots[0], track_data.knots[1],
        torch.as_tensor(np.where(np.isnan(age_arrays), np.inf, age_arrays), dtype=track_data.values.dtype,
                        device=dev),
        torch.as_tensor(lengths, dtype=torch.int64, device=dev),
    )
    track = EvolutionTrackInterpolator(track_data, bc_data, bands=bc_grid.bands, eep_support=eep_support)
    iso = IsochroneInterpolator(iso_grid.grid_data, bc_data, bands=bc_grid.bands, track=track)
    track._iso = iso
    # the reference's class hooks (models.py:255-257), set per instance: the
    # factory owns the grid pairing
    iso.grid_type, track.grid_type = iso_cls, MISTEvolutionTrackGrid
    iso.bc_type = track.bc_type = MISTBolometricCorrectionGrid
    return iso, track
