"""Kernel B's choices that live in Python, pinned on the CPU.

- ``interp_cuda.launch_choice``: the exact column instances (1-4 columns on
  grids of up to 4 axes, 32-bit offsets), chunks of 8 otherwise, 64-bit
  offsets from 2**31 table elements on.
- ``interp_cuda.planar_columns``: the column-planar copy ``(len(icols), n0,
  ..., n_{d-1})`` of a table's columns that kernel B reads where a call asks
  for it, built once per table and column tuple, kept while its table
  lives; ``interp_nd(..., planar=True)`` on the CPU builds none (bitwise the
  plain version's result).
- The cluster ladder asks for its copies (the mass pair, each property
  column but the parallax); looked up as the card's path does, they are
  built once per table, whatever the number of models.
"""

import gc

import numpy as np
import pytest
import torch

import isochrones_torch.cluster as cluster_mod
from isochrones_torch import StarClusterModel, get_ichrone
from isochrones_torch.catalog import read_csv
from isochrones_torch.ops import interp_cuda
from isochrones_torch.ops.interp import interp_nd, interp_nd_plain
from isochrones_torch.ops.interp_cuda import planar_columns


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("table_len,ncols,ndim,want", [
    (1000, 1, 3, (1, False)), (1000, 2, 3, (2, False)), (1000, 3, 4, (3, False)), (1000, 4, 1, (4, False)),
    (1000, 5, 3, (8, False)), (1000, 15, 3, (8, False)), (1000, 128, 2, (8, False)), (1000, 2, 5, (8, False)),
    (1000, 1, 6, (8, False)), ((1 << 31) - 1, 2, 3, (2, False)), (1 << 31, 2, 3, (8, True)),
    (1 << 33, 1, 4, (8, True)),
])
def test_launch_choice(table_len, ncols, ndim, want):
    assert interp_cuda.launch_choice(table_len, ncols, ndim) == want


def test_launch_choice_follows_the_wide_threshold(monkeypatch):
    """The card tests force the 64-bit path through this threshold."""
    monkeypatch.setattr(interp_cuda, "WIDE_ELEMENTS", 0)
    assert interp_cuda.launch_choice(10, 2, 3) == (interp_cuda.CHUNK, True)


def _table(dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(5, 4, 7, 6)), dtype=dtype)


@pytest.mark.parametrize("icols", [(0,), (4, 1), (5, 0, 3), (0, 1, 2, 3, 4, 5)])
def test_planar_columns_layout_and_cache(icols):
    values = _table()
    pc = planar_columns(values, icols)
    assert pc.is_contiguous()
    assert tuple(pc.shape) == (len(icols), 5, 4, 7)
    for j, c in enumerate(icols):
        assert torch.equal(pc[j], values[..., c])
    assert planar_columns(values, list(icols)) is pc  # once per table and column tuple
    assert planar_columns(values.clone(), icols) is not pc  # another table
    as32 = values.float()
    assert planar_columns(as32, icols).dtype == torch.float32


def test_planar_copy_lives_as_long_as_its_table():
    values = _table(seed=1)
    planar_columns(values, (1, 2))
    n = len(interp_cuda._PLANAR)
    del values
    gc.collect()
    assert len(interp_cuda._PLANAR) == n - 1


def test_interp_nd_on_cpu_ignores_the_planar_copy():
    values = _table(seed=2)
    knots = tuple(torch.linspace(0.0, 1.0, n, dtype=torch.float64) for n in values.shape[:-1])
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-0.1, 1.1, (500, 3)))
    icols = (3, 0)
    got = interp_nd(values, knots, pts, icols=icols, planar=True)
    assert torch.equal(torch.nan_to_num(got, nan=7.0),
                       torch.nan_to_num(interp_nd_plain(values, knots, pts, icols=icols), nan=7.0))
    assert values not in interp_cuda._PLANAR  # no copy on the CPU


def test_cluster_ladder_builds_its_planar_copies_once(monkeypatch):
    """The ladder asks for the planar layout on its mass pair and its Teff
    column (the parallax needs no lerp); looked up as kernel B's wrapper
    does on the card, two cluster models on one grid share those copies,
    and the CPU path itself builds none."""
    ic = get_ichrone("synthetic", device="cpu", n_feh=5, n_mass=40, n_eep=1710, n_age=20)
    data = read_csv("isochrones_torch/data/cluster50_synthetic.csv")
    data["Teff"] = np.full(len(data["J_mag"]), 6000.0)
    data["Teff_unc"] = np.full(len(data["J_mag"]), 300.0)
    kw = dict(bands=("J", "H", "K"), props=("parallax", "Teff"), eep_bounds=(1, 1400), eep_step=20.0,
              max_distance=3000, minq=0.2, mass_bounds=(0.6, 2.0))
    ci = ic.model.column_index
    p = np.array([[9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3]])
    lp_cpu = StarClusterModel(ic, data, **kw).lnpost_batch(p).numpy()
    assert ic.model.values not in interp_cuda._PLANAR
    asked = []

    def card_lookup(values, knots, points, icols=None, axis_maps=None, planar=False):
        if planar:
            asked.append((tuple(icols), planar_columns(values, icols)))
        return interp_nd_plain(values, knots, points, icols=icols, axis_maps=axis_maps)

    monkeypatch.setattr(cluster_mod, "interp_nd", card_lookup)
    lps = [StarClusterModel(ic, data, **kw).lnpost_batch(p).numpy() for _ in range(2)]
    want = [(ci["initial_mass"], ci["dm_deep"]), (ci["Teff"],)]
    assert [c for c, _ in asked] == want * 2
    assert all(asked[i][1] is asked[i + 2][1] for i in range(2))
    assert set(interp_cuda._PLANAR[ic.model.values]) == set(want)
    assert np.isfinite(lp_cpu).all() and np.array_equal(lps[0], lp_cpu) and np.array_equal(lps[1], lp_cpu)
