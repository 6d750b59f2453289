"""The table operations of the port's ``summary.Frame`` against pandas on the
same table (NaN and ties included): row selection by a mask, ``sort_values``,
``iloc`` rows, column assignment, ``quantile``, ``nanmin``/``nanmax`` and
``query``, whose expressions are compiled from their syntax tree and refused
(``ValueError``) past column names, numbers, comparisons and the boolean
operators."""

import io

import numpy as np
import pandas as pd
import pytest

from isochrones_torch.summary import Frame


def _table(n=40, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.choice([0.1, 0.25, 0.5, 0.7, 0.9], n)  # ties
    a[rng.choice(n, 6, replace=False)] = np.nan
    c = rng.normal(0.0, 1.0, n)
    c[[3, 17]] = np.nan
    return {
        "a": a,
        "b": rng.integers(0, 5, n),
        "c": c,
        "d": np.full(n, np.nan),
        "s": np.array([f"src{i % 7}" for i in range(n)]),
    }


def _both(index=None):
    cols = _table()
    return Frame(cols, index=index), pd.DataFrame(cols, index=index)


def _same(got, ref):
    assert got.columns == list(ref.columns)
    np.testing.assert_array_equal(got._labels(), ref.index.values)
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], ref[c].values)


@pytest.mark.parametrize("index", [None, np.arange(100, 140)[::-1]])
def test_loc_mask_and_sort_values(index):
    fr, df = _both(index)
    mask = np.asarray(df["b"] >= 2)
    _same(fr.loc[mask], df.loc[mask])
    for by in ("a", "b", "c", "d"):
        _same(fr.sort_values(by=by), df.sort_values(by=by))
        _same(fr.loc[mask].sort_values(by), df.loc[mask].sort_values(by=by))
    with pytest.raises(TypeError):
        fr.loc[np.arange(3)]


def test_iloc_row_and_column_assignment():
    fr, df = _both(np.arange(40) * 2)
    for i in (0, 7, 39, -1):
        row, ref = fr.iloc[i], df.iloc[i]
        assert list(row) == list(ref.index)
        for c in ref.index:
            assert row[c] == ref[c] or (np.isnan(row[c]) and np.isnan(ref[c]))
    fr["e"], df["e"] = 1.5, 1.5
    fr["f"] = df["f"] = np.arange(40.0)
    fr["g"], df["g"] = [1] * 40, [1] * 40
    _same(fr, df)
    _same(fr.iloc[5:9], df.iloc[5:9])


def test_quantile_and_extrema():
    fr, df = _both()
    num = ["a", "b", "c", "d"]
    fn, dn = Frame({c: fr[c] for c in num}), df[num]
    for qs in ([0.5, 0.1585, 0.8415], [0.05, 0.16, 0.5, 0.84, 0.95], [0.0, 1.0]):
        got, ref = fn.quantile(qs), dn.quantile(qs)
        np.testing.assert_array_equal(got.index, ref.index.values)
        for c in num:
            np.testing.assert_array_equal(got[c], ref[c].values)
    for c, v in fn.quantile(0.3).items():
        np.testing.assert_array_equal(v, dn.quantile(0.3)[c])
    for got, ref in ((fn.nanmin(), dn.min()), (fn.nanmax(), dn.max())):
        assert list(got) == num
        np.testing.assert_array_equal([got[c] for c in num], ref[num].values)


QUERIES = [
    "a > 0.5",
    "a >= 0.5",
    "a == 0.5",
    "a != 0.5",
    "0.1 < a <= 0.7",
    "c > -0.25",
    "-c < 0.25",
    "a > 0.2 & b < 3",
    "a > 0.2 and b < 3",
    "a > 0.8 | b == 0",
    "a > 0.8 or b == 0",
    "~(a > 0.5)",
    "not a > 0.5",
    "(a > 0.2) & (b >= 2) | (c < -1)",
    "b > 2 or c < 0 and a > 0.1",
    "~(a < 0.3) & ~(c > 0.5) | b == 4",
    "d > 0 | a < 0.3",
    "b > 1.5 & b < 3.5 & c == c",
]


@pytest.mark.parametrize("expr", QUERIES)
def test_query_matches_pandas(expr):
    fr, df = _both(np.arange(40) + 7)
    _same(fr.query(expr), df.query(expr))


@pytest.mark.parametrize("expr", [
    "a.mean() > 0", "abs(a) > 0.1", "__import__('os')", "a + 1 > 2", "a > 'x'", "s == 'src1'",
    "a in [0.1, 0.5]", "a > @x", "zz > 1", "a >", "lambda: 1", "[a > 1][0]",
])
def test_query_refuses_other_expressions(expr):
    fr, _ = _both()
    with pytest.raises(ValueError):
        fr.query(expr)


def test_csv_to_an_open_file():
    fr, df = _both(np.arange(40) + 3)
    buf = io.StringIO()
    fr.iloc[:5].to_csv(buf)
    assert buf.getvalue() == df.iloc[:5].to_csv()
