"""Fit summaries (counterpart of ``isochrones_tpu/summary.py``).

A fitted :class:`~isochrones_torch.batch.BatchStarFitter` holds every star's
posterior draws as one ``(S, N, 5)`` array, so the summary is one vectorized
quantile pass plus one interpolator call, on the fitter's device, for the
derived physical columns of all ``S x N`` draws. Without pandas (the machine
with the card has none) a table is a :class:`Frame`: an ordered dict of numpy
columns with the row index beside it, written to CSV in the layout of
``DataFrame.to_csv``.

The per-folder API (:func:`get_quantiles`, :func:`get_summary_df`,
:func:`write_results_txt`) reads the HDF5 results files that ``starfit``
writes (``<models>_starmodel_<mult>.h5``, the JAX package's layout, through
:mod:`isochrones_torch.hdf5`). An HDF5 summary name (``.h5``, ``.hdf``,
``.hdf5``) is written as CSV to ``<name>.csv``, as the JAX package does
where PyTables is absent.
"""

from __future__ import annotations

import ast
import csv
import io
import os
import re
import tokenize

import numpy as np

from .utils import load_results, stored_table

__all__ = ["Frame", "quantile_frame", "derived_quantile_frame", "summarize_batch", "get_quantiles",
           "quantile_worker", "get_summary_df", "write_results_txt", "DEFAULT_QS", "DEFAULT_COLUMNS"]

DEFAULT_QS = (0.05, 0.16, 0.5, 0.84, 0.95)
DEFAULT_COLUMNS = ("eep", "mass", "radius", "age", "feh", "distance", "AV")


class Frame(dict):
    """An ordered dict of column name -> 1-d numpy array, one row per star,
    with the rows' labels in ``index`` (``None``: ``0 .. n-1``).

    The table operations the port needs, as ``DataFrame`` has them:
    :meth:`dropna`, :attr:`iloc` (a row, or a row slice or take), :attr:`loc`
    (rows by a boolean mask), :meth:`sort_values`, :meth:`query`,
    :meth:`quantile`, :meth:`nanmin`, :meth:`nanmax`, column assignment (a
    scalar fills the column), :meth:`concat` (rows of frames with the same
    columns; the labels start again at 0), :meth:`rename` and :meth:`copy`.
    ``Frame(frame)`` drops the labels, as ``reset_index(drop=True)`` does.
    ``len(frame)`` counts columns (it is a dict): :meth:`n_rows` counts
    rows."""

    def __init__(self, columns=(), index=None):
        super().__init__(columns)
        self.index = None if index is None else np.asarray(index)

    @property
    def columns(self):
        return list(self)

    def n_rows(self):
        return len(next(iter(self.values()))) if self else 0

    def __setitem__(self, column, value):
        if np.ndim(value) == 0:
            value = np.full(self.n_rows(), value)
        elif isinstance(value, (list, tuple)):
            value = np.asarray(value)
        super().__setitem__(column, value)

    def _labels(self):
        if self.index is not None:
            return self.index
        return np.arange(self.n_rows())

    def _rows(self, rows):
        return Frame({c: v[rows] for c, v in self.items()}, index=None if self.index is None else self.index[rows])

    def _take(self, rows):
        """The rows at ``rows`` (positions or a boolean mask) with their
        labels, the positions' labels where the frame has none."""
        out = self._rows(rows)
        out.index = self._labels()[rows]
        return out

    @property
    def iloc(self):
        """``frame.iloc[i]``: the row at position ``i`` as a dict of column ->
        value; ``frame.iloc[rows]``: the rows at these positions (a slice, an
        integer array or a boolean mask), with their labels."""
        frame = self

        class _ILoc:
            def __getitem__(self, rows):
                if isinstance(rows, (int, np.integer)):
                    return {c: v[rows] for c, v in frame.items()}
                return frame._rows(rows)

        return _ILoc()

    @property
    def loc(self):
        """``frame.loc[mask]``: the rows where the boolean ``mask`` is true,
        with their labels."""
        frame = self

        class _Loc:
            def __getitem__(self, mask):
                mask = np.asarray(mask)
                if mask.dtype != bool:
                    raise TypeError("Frame.loc takes a boolean row mask")
                return frame._take(mask)

        return _Loc()

    def sort_values(self, by):
        """The rows sorted by the column ``by``, NaN last, as
        ``DataFrame.sort_values`` sorts one column (pandas' ``nargsort``:
        numpy's quicksort ``argsort`` of the non-NaN values)."""
        v = np.asarray(self[by])
        nan = np.isnan(v) if v.dtype.kind in "fc" else np.zeros(len(v), dtype=bool)
        pos = np.arange(len(v))
        order = np.concatenate([pos[~nan][v[~nan].argsort(kind="quicksort")], pos[nan]])
        return self._take(order)

    def query(self, expr):
        """The rows where the boolean expression ``expr`` holds, as
        ``DataFrame.query`` selects them. ``expr`` may hold column names,
        numbers, comparisons (chained too), ``&``, ``|``, ``~``, ``and``, ``or``
        and ``not``; ``&`` and ``|`` bind as ``and`` and ``or``, as in pandas.
        Anything else raises ``ValueError``; nothing is evaluated as Python."""
        mask = np.broadcast_to(np.asarray(_QueryEval(self).run(expr), dtype=bool), (self.n_rows(),))
        return self._take(mask)

    def quantile(self, q=0.5):
        """Every column's ``q`` quantile (linear), skipping NaN, as
        ``DataFrame.quantile``: a dict of column -> value for a scalar ``q``,
        else a frame with one row a quantile, labelled by it."""
        qs = np.atleast_1d(np.asarray(q, dtype=float))
        out = self._reduce(lambda v: np.quantile(v, qs), np.full(len(qs), np.nan))
        if np.ndim(q) == 0:
            return {c: v[0] for c, v in out.items()}
        return Frame(out, index=qs)

    def _reduce(self, fn, empty=np.nan):
        """``fn`` of every column's non-NaN values; ``empty`` for a column of NaN."""
        out = {}
        for c, v in self.items():
            v = np.asarray(v, dtype=float)
            v = v[~np.isnan(v)]
            out[c] = fn(v) if len(v) else empty
        return out

    def nanmin(self):
        """Every column's least value, skipping NaN (``DataFrame.min``); NaN
        for a column of NaN."""
        return self._reduce(np.min)

    def nanmax(self):
        """Every column's greatest value, skipping NaN (``DataFrame.max``); NaN
        for a column of NaN."""
        return self._reduce(np.max)

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
        cell; with ``index`` False, without the labels' column. ``filename``
        may also be an open text file."""
        if hasattr(filename, "write"):
            self._write_csv(filename, index)
        else:
            with open(filename, "w", newline="") as f:
                self._write_csv(f, index)

    def _write_csv(self, f, index):
        n = self.n_rows()
        labels = self._labels()
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + self.columns)
        cols = list(self.values())
        for i in range(n):
            w.writerow(([_cell(labels[i])] if index else []) + [_cell(c[i]) for c in cols])


_QUERY_CMP = {ast.Lt: np.less, ast.LtE: np.less_equal, ast.Gt: np.greater, ast.GtE: np.greater_equal,
              ast.Eq: np.equal, ast.NotEq: np.not_equal}


class _QueryEval:
    """Evaluates a :meth:`Frame.query` expression over the frame's columns by
    walking its syntax tree; only the nodes named there are taken."""

    def __init__(self, frame):
        self.frame = frame

    def run(self, expr):
        # pandas reads & and | as `and` and `or` (pandas.core.computation.expr._replace_booleans),
        # which bind looser than a comparison
        try:
            toks = [(tokenize.NAME, {"&": "and", "|": "or"}[t.string])
                    if t.type == tokenize.OP and t.string in ("&", "|") else (t.type, t.string)
                    for t in tokenize.generate_tokens(io.StringIO(expr).readline)]
            tree = ast.parse(tokenize.untokenize(toks).strip(), mode="eval")
        except (SyntaxError, tokenize.TokenError) as e:
            raise ValueError(f"cannot parse the query {expr!r}: {e}") from None
        return self.eval(tree.body)

    def eval(self, node):
        if isinstance(node, ast.BoolOp):
            vals = [np.asarray(self.eval(v), dtype=bool) for v in node.values]
            op = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
            out = vals[0]
            for v in vals[1:]:
                out = op(out, v)
            return out
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, (ast.Not, ast.Invert)):
                return np.logical_not(np.asarray(self.eval(node.operand), dtype=bool))
            if isinstance(node.op, (ast.USub, ast.UAdd)):
                v = self.eval(node.operand)
                return -v if isinstance(node.op, ast.USub) else v
        if isinstance(node, ast.Compare):
            out, left = True, self.eval(node.left)
            for op, comp in zip(node.ops, node.comparators):
                if type(op) not in _QUERY_CMP:
                    raise ValueError(f"unsupported comparison in a query: {type(op).__name__}")
                right = self.eval(comp)
                out = np.logical_and(out, _QUERY_CMP[type(op)](left, right))
                left = right
            return out
        if isinstance(node, ast.Name):
            if node.id not in self.frame:
                raise ValueError(f"unknown column in a query: {node.id!r}")
            return np.asarray(self.frame[node.id])
        if isinstance(node, ast.Constant) and isinstance(node.value, (bool, int, float)):
            return node.value
        raise ValueError(f"unsupported expression in a query: {ast.dump(node)}")


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
        ``.hdf``, ``.hdf5``) is written to ``<name>.csv`` (:func:`_write`).
    """
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
        _write(out, filename)
    return out


# --------------------------------------------------------------------------
# the per-folder API (reference summary.py:9-76): one fitted model's results
# file a folder, its derived samples' quantiles one row


def get_quantiles(name, rootdir=".", columns=DEFAULT_COLUMNS, qs=DEFAULT_QS, modelname="mist_starmodel_single",
                  verbose=False, raise_exceptions=False, device="cuda", dtype=None):
    """Parameter quantiles for one fitted starmodel folder: the derived
    samples' columns that match ``columns`` (regular expressions), one row
    labelled ``name``. The model is ``<rootdir>/<name>/<modelname>.h5``,
    reloaded as ``BasicStarModel.load_hdf`` does (its interpolator rebuilt
    on ``device`` in ``dtype``); an empty :class:`Frame` where it cannot be
    loaded, unless ``raise_exceptions``."""
    from .starmodel import BasicStarModel

    modfile = os.path.join(rootdir, name, f"{modelname}.h5")
    try:
        mod = BasicStarModel.load_hdf(modfile, device=device, dtype=dtype)
    except Exception:
        if verbose:
            print(f"cannot load starmodel! ({modfile})")
        if raise_exceptions:
            raise
        return Frame()

    ds = mod.derived_samples
    names = [c for c in ds if any(re.search(c2, c) for c2 in columns)]
    values = np.stack([np.asarray(ds[c], dtype=float) for c in names], axis=-1) if names else np.zeros((0, 0))
    return quantile_frame(values[None], names, qs=qs, index=[name])


class quantile_worker:
    """Picklable pool worker: :func:`get_quantiles` of one folder name with
    fixed keywords."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, name):
        return get_quantiles(name, **self.kwargs)


def _concat_rows(frames):
    """The rows of ``frames`` one after another with their labels, the union
    of their columns in order of appearance, NaN where a frame lacks one
    (``pd.concat`` of the frames; an empty frame adds nothing)."""
    frames = [f for f in frames if f]
    cols = list(dict.fromkeys(c for f in frames for c in f))
    out = Frame({c: np.concatenate([np.asarray(f[c], dtype=float) if c in f else np.full(f.n_rows(), np.nan)
                                    for f in frames]) for c in cols})
    out.index = np.concatenate([f._labels() for f in frames]) if frames else None
    return out


def get_summary_df(names=None, pool=None, filename=None, **kwargs):
    """The quantile rows of every folder in ``names`` (:func:`get_quantiles`
    with ``kwargs``; through ``pool.map`` where a pool is given), written to
    ``filename`` where one is given. For whole-catalog fits
    :func:`summarize_batch` needs no per-folder reload."""
    map_fn = map if pool is None else pool.map
    df = _concat_rows(list(map_fn(quantile_worker(**kwargs), names)))
    if filename is not None:
        _write(df, filename)
    return df


RESULTS_PROPS = ("mass", "radius", "Teff", "logg", "feh", "age", "distance", "AV")


def write_results_txt(folder, models="mist", mult="single", props=RESULTS_PROPS):
    """Per-folder ``{models}_{mult}_results.txt`` with the median, 15.85% and
    84.15% quantiles of each physical property (the reference
    ``scripts/starfit-summarize`` folders mode). Reads the stored derived
    samples of ``{models}_starmodel_{mult}.h5`` (flat and tree models alike:
    ``mass``, else ``mass_0_0``, else ``mass_0``); ``nan nan nan`` for a
    property the table lacks."""
    path = os.path.join(folder, f"{models}_starmodel_{mult}.h5")
    ds = stored_table(load_results(path), "derived_samples")
    if ds is None:
        raise KeyError(f"{path} holds no derived samples")
    results_file = os.path.join(folder, f"{models}_{mult}_results.txt")
    vals = []
    for p in props:
        col = next((c for c in (p, f"{p}_0_0", f"{p}_0") if c in ds), None)
        if col is None:
            vals.append("nan nan nan")
            continue
        med, lo, hi = Frame({col: ds[col]}).quantile([0.5, 0.1585, 0.8415])[col]
        vals.append(f"{med:.3f} {lo:.3f} {hi:.3f}")
    with open(results_file, "w") as f:
        f.write(" ".join(f"{p} {p}_lo {p}_hi" for p in props) + " \n")
        f.write(" ".join(vals) + " \n")
    return results_file


def _write(df, filename):
    """Write a summary table as CSV; an HDF5 name (``.h5``, ``.hdf``,
    ``.hdf5``) goes to ``<name>.csv``, where the JAX package writes it
    wherever PyTables is absent."""
    if str(filename).endswith((".h5", ".hdf", ".hdf5")):
        filename = str(filename) + ".csv"
    df.to_csv(filename)
    print(f"Summary dataframe written to {filename}")
