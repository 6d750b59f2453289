"""Numeric-table parsing for the grid bakes (counterpart of
``isochrones_tpu/grids/parse.py``).

The JAX package parses MIST's whitespace tables with a native C++ parser
(``native/fastparse.cpp``, built with g++ at first use) and falls back to
pandas. The port parses with numpy's C ``loadtxt`` instead: both round each
number correctly, so the parsed float64 tables are bitwise the same, and
neither a compiler nor pandas is needed on the machine with the card.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

__all__ = ["read_whitespace_table", "parse_numeric_table"]


def parse_numeric_table(filename) -> np.ndarray:
    """A '#'-commented whitespace numeric table as a (rows, cols) float64
    array; blank lines and comment lines anywhere are skipped. Rows that
    disagree on their number of columns raise ``ValueError``."""
    if os.path.getsize(filename) == 0:
        return np.empty((0, 0), dtype=np.float64)
    try:
        with warnings.catch_warnings():
            # a table of comments only: loadtxt warns, the JAX parser returns no rows
            warnings.simplefilter("ignore", UserWarning)
            data = np.loadtxt(filename, dtype=np.float64, comments="#", encoding="latin-1", ndmin=2)
    except ValueError as e:
        raise ValueError(f"{filename}: not a rectangular numeric table ({e})") from None
    return data if data.size else np.empty((0, 0), dtype=np.float64)


def read_whitespace_table(filename, names):
    """:func:`parse_numeric_table` as a :class:`~isochrones_torch.grids.base.Table`
    with the given column names."""
    from .base import Table

    data = parse_numeric_table(filename)
    if data.shape[1] != len(names):
        raise ValueError(f"{filename}: {data.shape[1]} columns, expected {len(names)} ({names})")
    return Table({n: np.ascontiguousarray(data[:, i]) for i, n in enumerate(names)})
