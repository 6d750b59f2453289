"""The work counts on tiny shapes counted by hand."""

import math

import numpy as np
import pytest
import torch

from portbench import work
from portbench.work import _touched_rows

EEPS = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)


@pytest.mark.parametrize("masses, valid, want", [
    # (1,0) (1,1) (2,0) (2,1) (2,2); (0,0) has no trapezoid weight
    ([1.0, 0.9, 0.5], [True, True, True], 5),
    # q = m_k / m_j under 0.6 drops (1,0) and (2,0)
    ([0.5, 0.9, 1.0], [True, True, True], 3),
    # row j = 1 not valid drops (1,0) and (1,1)
    ([1.0, 0.9, 0.5], [True, False, True], 3),
])
def test_cluster_cells_by_hand(masses, valid, want):
    m = torch.tensor([masses], dtype=torch.float64)
    finite = torch.ones((1, 3), dtype=torch.bool)
    assert work.cluster_cells(m, finite, torch.tensor([valid]), EEPS, 0.6) == want


def test_cluster_cells_are_the_trapezoids_weighted_cells():
    """A plane's double trapezoid equals the sum of exp(L) over the counted
    cells with positive weights: the count is of the cells the integral reads."""
    E = 6
    eeps = torch.arange(E, dtype=torch.float64) * 2.0
    rng = np.random.default_rng(0)
    L = torch.as_tensor(rng.normal(size=(E, E)))
    tri = torch.ones((E, E), dtype=torch.bool).tril()
    like = torch.exp(torch.where(tri, L, -math.inf))
    de = eeps[1:] - eeps[:-1]
    inner = 0.5 * (like[:, :-1] + like[:, 1:]) * de
    ar = torch.arange(E)
    rows = torch.where(ar[1:][None, :] <= ar[:, None], inner, torch.zeros_like(inner)).sum(-1)
    integral = float((0.5 * (rows[:-1] + rows[1:]) * de).sum())
    # the same integral cell by cell: which cells carry weight
    weights = torch.zeros((E, E), dtype=torch.float64)
    for j in range(E):
        wo = 0.5 * ((de[j - 1] if j > 0 else 0) + (de[j] if j < E - 1 else 0))
        for k in range(j + 1):
            wi = 0.5 * ((de[k] if k + 1 <= j else 0) + (de[k - 1] if k >= 1 else 0))
            weights[j, k] = wo * wi
    assert float((like * weights).sum()) == pytest.approx(integral, rel=1e-13)
    m = torch.ones((1, E), dtype=torch.float64)
    ok = torch.ones((1, E), dtype=torch.bool)
    assert work.cluster_cells(m, ok, ok, eeps, 0.2) == int((weights > 0).sum())


def test_cluster_work_by_hand():
    nbytes, flops, specials = work.cluster_work(5, W=1, S=2, E=3, B=1, itemsize=8)
    assert flops == 5 * (2 * 1 * 10 + 2 * 5 + 1 * 3)
    assert specials == 5 * (2 * 2 + 1)
    # flux and mags 2*3, masses and ln|dm| 2*3, row term 2*3, ladder 3, members 2*2, scalars 4, out 2; masks 2*3 bytes
    assert nbytes == 8 * (6 + 6 + 6 + 3 + 4 + 4 + 2) + 6


def test_touched_rows_by_hand():
    values = torch.zeros((3, 3, 1), dtype=torch.float64)
    knots = (torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64),) * 2
    pts = torch.tensor([[0.5, 0.5], [0.2, 0.7]], dtype=torch.float64)
    assert _touched_rows(values, knots, pts) == 4  # one cell's 4 corners
    pts = torch.tensor([[0.5, 0.5], [1.5, 0.5]], dtype=torch.float64)
    assert _touched_rows(values, knots, pts) == 6  # two cells share an edge
    pts = torch.tensor([[2.0, 2.0], [float("nan"), 0.5], [3.0, 0.5]], dtype=torch.float64)
    assert _touched_rows(values, knots, pts) == 1  # the top corner alone; NaN and outside read nothing


def test_catalog_work_by_hand(tiny_cell):
    from portbench.drivers.common import interpolator

    _, _, cfg, _ = tiny_cell("catalog4096.nested")
    _, tables = interpolator(cfg, torch.device("cpu"))
    x = torch.tensor([[[300.0, 9.0, 0.0, 200.0, 0.1]]], dtype=torch.float64)
    nbytes, flops, specials = work.catalog_work(x, tables, 3, [7], 8)
    assert flops == 70 + 8 * 18 + 16 * (8 + 6) + 9 + 60 + 6 * 7
    assert specials == 1 + 8 + 7
    assert nbytes == 8 * (5 + 1 + 6 * 8 + 3 * 16 + 8 + 6)  # one point: 8 grid rows, 16 BC rows


def test_bound_takes_the_slower_side():
    t, what = work.bound_s(3.35e12, 0, 0, torch.float64)
    assert what == "bytes" and t == pytest.approx(1.0)
    t, what = work.bound_s(0, 34e12 - 20 * 1e12, 1e12, torch.float64)
    assert what == "operations" and t == pytest.approx(1.0)
