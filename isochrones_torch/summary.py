"""Catalog summaries (counterpart of the catalog part of
``isochrones_tpu/summary.py``).

A fitted :class:`~isochrones_torch.batch.BatchStarFitter` holds every star's
posterior draws as one ``(S, N, 5)`` array, so the summary is one vectorized
quantile pass plus one interpolator call, on the fitter's device, for the
derived physical columns of all ``S x N`` draws. Without pandas (the machine
with the card has none) a table is a :class:`Frame`: an ordered dict of numpy
columns with the row index beside it, written to CSV in the layout of
``DataFrame.to_csv``.

The per-folder API (``get_quantiles``, ``get_summary_df``,
``write_results_txt``) is not ported yet (ROADMAP queue 1, summary and
plotting).
"""

from __future__ import annotations

import csv
import re

import numpy as np

__all__ = ["Frame", "quantile_frame", "derived_quantile_frame", "summarize_batch", "DEFAULT_QS", "DEFAULT_COLUMNS"]

DEFAULT_QS = (0.05, 0.16, 0.5, 0.84, 0.95)
DEFAULT_COLUMNS = ("eep", "mass", "radius", "age", "feh", "distance", "AV")


class Frame(dict):
    """An ordered dict of column name -> 1-d numpy array, one row per star,
    with the rows' labels in ``index`` (``None``: ``0 .. n-1``).

    The few table operations the forward model and the populations need, as
    ``DataFrame`` has them: :meth:`dropna`, :attr:`iloc` (a row slice or
    take), :meth:`concat` (rows of frames with the same columns; the labels
    start again at 0), :meth:`rename` and :meth:`copy`. ``Frame(frame)``
    drops the labels, as ``reset_index(drop=True)`` does."""

    def __init__(self, columns=(), index=None):
        super().__init__(columns)
        self.index = None if index is None else np.asarray(index)

    @property
    def columns(self):
        return list(self)

    def _labels(self):
        if self.index is not None:
            return self.index
        return np.arange(len(next(iter(self.values()))) if self else 0)

    def _rows(self, rows):
        return Frame({c: v[rows] for c, v in self.items()}, index=None if self.index is None else self.index[rows])

    @property
    def iloc(self):
        """``frame.iloc[rows]``: the rows at these positions (a slice, an
        integer array or a boolean mask), with their labels."""
        frame = self

        class _ILoc:
            def __getitem__(self, rows):
                return frame._rows(rows)

        return _ILoc()

    def dropna(self, subset=None):
        """The rows with no NaN in the columns ``subset`` (every column when
        None), with their labels."""
        keep = np.ones(len(self._labels()), dtype=bool)
        for c in self.columns if subset is None else subset:
            v = np.asarray(self[c])
            if v.dtype.kind in "fc":
                keep &= ~np.isnan(v)
        out = self._rows(keep)
        out.index = self._labels()[keep]
        return out

    @staticmethod
    def concat(frames):
        """The rows of ``frames`` (the same columns in the same order) one
        after another, labelled ``0 .. n-1``."""
        cols = frames[0].columns
        for f in frames[1:]:
            if f.columns != cols:
                raise ValueError("Frame.concat needs frames with the same columns")
        return Frame({c: np.concatenate([np.asarray(f[c]) for f in frames]) for c in cols})

    def rename(self, columns):
        """A frame with the columns renamed by the mapping ``columns``."""
        return Frame({columns.get(c, c): v for c, v in self.items()}, index=self.index)

    def copy(self):
        """A frame with copies of the columns and of the labels."""
        return Frame({c: np.array(v, copy=True) for c, v in self.items()},
                     index=None if self.index is None else self.index.copy())

    def to_csv(self, filename, index=True):
        """Write the table as ``DataFrame.to_csv`` does: a header whose first
        cell (the index's) is empty, one line per row starting with its
        label, floats in their shortest round-trip form, NaN as an empty
        cell; with ``index`` False, without the labels' column."""
        n = len(next(iter(self.values()))) if self else 0
        labels = self.index if self.index is not None else np.arange(n)
        lead = [""] if index else []
        with open(filename, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(lead + self.columns)
            cols = list(self.values())
            for i in range(n):
                w.writerow(([_cell(labels[i])] if index else []) + [_cell(c[i]) for c in cols])


def _cell(x):
    if isinstance(x, (float, np.floating)):
        return "" if np.isnan(x) else repr(float(x))
    if isinstance(x, (np.integer, np.bool_)):
        return str(x.item())
    return str(x)


def _q_col(name, q):
    return f"{name}_{q * 100:02.0f}"


def quantile_frame(samples, names, qs=DEFAULT_QS, index=None):
    """Wide per-row quantile table from stacked posterior draws.

    samples : (S, N) or (S, N, P) array: S rows (stars), N draws each.
    names : P column names (or one name for 2-d input).
    Returns a :class:`Frame` with one row per star and ``{name}_{qq}``
    columns from one ``np.nanquantile`` call per parameter; a row whose draws
    are all NaN gets NaN quantiles.
    """
    arr = np.asarray(samples, dtype=float)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if isinstance(names, str):
        names = [names]
    if arr.shape[-1] != len(names):
        raise ValueError(f"{arr.shape[-1]} sample columns vs {len(names)} names")
    out = Frame(index=index)
    with np.errstate(invalid="ignore"):
        for i, p in enumerate(names):
            col = arr[:, :, i]
            all_nan = np.isnan(col).all(axis=1)
            safe = np.where(all_nan[:, None], 0.0, col)
            quants = np.nanquantile(safe, qs, axis=1)  # (len(qs), S)
            quants = np.where(all_nan[None, :], np.nan, quants)
            for q, row in zip(qs, quants):
                out[_q_col(p, q)] = row
    return out


def derived_quantile_frame(ic, samples, qs=DEFAULT_QS, columns=None, index=None):
    """Quantiles of derived physical quantities (mass, radius, Teff, logg,
    magnitudes, ...) of a whole catalog's posterior draws.

    samples : (S, N, 5) draws in ``(eep, age, feh, distance, AV)`` order. The
    derived values come from one ``ic(...)`` call over all S * N draws, on the
    interpolator's device; rows with a NaN draw (a star without support) are
    evaluated at a stand-in point and masked to NaN afterwards. ``columns``
    filters the derived columns by regular expression, as the reference's
    column selection does.
    """
    arr = np.asarray(samples, dtype=float)
    S, N, P = arr.shape
    if P != 5:
        raise ValueError("derived summaries need (eep, age, feh, distance, AV) draws")
    flat = arr.reshape(S * N, P)
    bad = ~np.isfinite(flat).all(axis=1)
    if bad.any():
        stand_in = np.nanmedian(np.where(bad[:, None], np.nan, flat), axis=0) if not bad.all() else np.ones(P)
        flat = np.where(bad[:, None], stand_in, flat)
    flat = np.where(np.isfinite(flat), flat, 1.0)
    derived = ic(*[flat[:, i] for i in range(5)])
    names = [c for c in derived if columns is None or any(re.search(c2, c) for c2 in columns)]
    stacked = np.stack([np.where(bad, np.nan, np.asarray(derived[c], dtype=float)) for c in names], axis=-1)
    return quantile_frame(stacked.reshape(S, N, len(names)), names, qs=qs, index=index)


def summarize_batch(fitter, qs=DEFAULT_QS, derived=True, columns=DEFAULT_COLUMNS, filename=None,
                    max_derived_draws=2000):
    """One catalog -> one summary :class:`Frame` from a fitted
    :class:`~isochrones_torch.batch.BatchStarFitter`: the fitted parameters'
    quantiles, the derived physical quantiles, and ``logz``/``logzerr``
    columns when the fit has an evidence.

    max_derived_draws : cap on the draws per star entering the derived
        interpolator call (evenly strided); the parameter quantiles use every
        draw. ``None``: all.
    filename : a CSV path to write the table to; an HDF5 name (``.h5``,
        ``.hdf``, ``.hdf5``) is not ported yet.
    """
    if filename is not None and str(filename).endswith((".h5", ".hdf", ".hdf5")):
        raise NotImplementedError("an HDF5 summary is not ported yet (ROADMAP queue 1, summary and plotting); "
                                  "give a .csv filename")
    idx = fitter.catalog.index
    out = quantile_frame(fitter.samples, list(fitter.param_names), qs=qs, index=idx)
    if derived:
        samples_d = np.asarray(fitter.samples)
        n_draws = samples_d.shape[1]
        if max_derived_draws is not None and n_draws > max_derived_draws:
            stride = np.linspace(0, n_draws - 1, max_derived_draws).astype(int)
            samples_d = samples_d[:, stride]
        for c, v in derived_quantile_frame(fitter.ic, samples_d, qs=qs, columns=columns, index=idx).items():
            out.setdefault(c, v)  # the fitted parameters' columns come first
    if getattr(fitter, "_evidence", None) is not None:
        out["logz"], out["logzerr"] = fitter.evidence
    if filename is not None:
        out.to_csv(filename)
        print(f"Summary table written to {filename}")
    return out
