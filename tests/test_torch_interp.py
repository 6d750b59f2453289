"""Port parity: ``isochrones_torch.ops.interp`` and ``ops.mags`` against the
JAX package on the same float64 inputs.

Cell location must agree exactly (cell index, in-cell coordinate within
1e-15, OOB flag); interpolated values within rtol 1e-12 with an identical
NaN pattern — which pins the IEEE ``0 * NaN`` poisoning by NaN-padded
neighbours at exact knots and the top-knot clamp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.ops.interp import compute_axis_maps as jax_compute_axis_maps
from isochrones_tpu.ops.interp import corner_data as jax_corner_data
from isochrones_tpu.ops.interp import find_cells_1d as jax_find_cells_1d
from isochrones_tpu.ops.interp import interp_nd as jax_interp_nd
from isochrones_torch import get_ichrone
from isochrones_torch.ops.interp import compute_axis_maps, corner_data, find_cells_1d, interp_nd

# one axis per index-map kind
_AXES = {
    "exact_affine": np.arange(1.0, 41.0),
    "affine": np.linspace(0.1, 0.73, 10),
    "log": np.exp(np.linspace(np.log(0.1), np.log(10.0), 12)),
    "compare": np.array([0.0, 0.3, 0.35, 1.0, 2.5, 2.6, 4.0, 7.5]),
    "searchsorted": np.sort(np.random.default_rng(5).uniform(-3, 3, 300)),
}


def _queries(k, rng):
    """Interior points, every knot exactly (incl. both ends), OOB and NaN."""
    lo, hi = k[0], k[-1]
    span = hi - lo
    return np.concatenate([
        rng.uniform(lo, hi, 64), k, [lo - 0.1 * span, hi + 0.1 * span, np.nan, np.nextafter(hi, lo)],
    ])


@pytest.mark.parametrize("kind", list(_AXES))
def test_find_cells_1d_every_axis_map(kind):
    k = _AXES[kind]
    amap = compute_axis_maps([k])[0]
    assert amap == jax_compute_axis_maps([k])[0]
    if kind == "searchsorted":
        assert amap is None
    else:
        assert amap[0] == kind
    x = _queries(k, np.random.default_rng(0))
    for m in {amap, None}:  # the analytic map and the searchsorted fallback
        cell, t, oob = find_cells_1d(torch.as_tensor(k), torch.as_tensor(x), axis_map=m)
        jc, jt, jo = jax_find_cells_1d(jnp.asarray(k), jnp.asarray(x), axis_map=m)
        ok = ~np.isnan(x)
        np.testing.assert_array_equal(cell.numpy()[ok], np.asarray(jc)[ok])
        np.testing.assert_allclose(t.numpy()[ok], np.asarray(jt)[ok], rtol=0, atol=1e-15)
        np.testing.assert_array_equal(oob.numpy(), np.asarray(jo))


def _holey_grid(rng):
    """(10, 12, 40, 3) grid on affine x log x exact-affine axes, NaN-padded
    past a per-track end (like the stellar grids) plus scattered holes."""
    knots = (_AXES["affine"], _AXES["log"], _AXES["exact_affine"])
    vals = rng.normal(0, 1, (10, 12, 40, 3))
    ends = rng.integers(20, 41, (10, 12))
    vals[np.arange(40)[None, None, :] >= ends[..., None]] = np.nan
    vals[rng.random((10, 12, 40)) < 0.02] = np.nan
    return vals, knots


def _grid_points(knots, rng, n=400):
    pts = np.stack([rng.uniform(k[0], k[-1], n) for k in knots], axis=-1)
    # exact knots on the innermost (EEP-like) axis, the top knot on each axis,
    # OOB and NaN rows
    pts[:150, 2] = rng.choice(knots[2], 150)
    pts[150:170, 0] = knots[0][-1]
    pts[170:190, 1] = knots[1][-1]
    pts[190:210, 2] = knots[2][-1]
    pts[210:220, 0] = knots[0][0] - 0.01
    pts[220:230, 2] = np.nan
    return pts


@pytest.mark.parametrize("use_maps", [True, False])
def test_corner_data_and_interp_nd(use_maps):
    rng = np.random.default_rng(1)
    vals, knots = _holey_grid(rng)
    pts = _grid_points(knots, rng)
    maps = compute_axis_maps(knots) if use_maps else None
    tk = tuple(torch.as_tensor(k) for k in knots)
    jk = tuple(jnp.asarray(k) for k in knots)

    corners, w, bad = corner_data(torch.as_tensor(vals), tk, torch.as_tensor(pts), icols=(2, 0), axis_maps=maps)
    jcorners, jw, jbad = jax_corner_data(jnp.asarray(vals), jk, jnp.asarray(pts), icols=(2, 0), axis_maps=maps)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    ok = ~bad.numpy()
    np.testing.assert_allclose(w.numpy()[ok], np.asarray(jw)[ok], rtol=0, atol=1e-14)
    np.testing.assert_array_equal(corners.numpy()[ok], np.asarray(jcorners)[ok])

    for icols in (None, (1,), (2, 0)):
        got = interp_nd(torch.as_tensor(vals), tk, torch.as_tensor(pts).reshape(20, 20, 3),
                        icols=icols, axis_maps=maps).numpy().reshape(400, -1)
        ref = np.asarray(jax_interp_nd(jnp.asarray(vals), jk, jnp.asarray(pts), icols=icols, axis_maps=maps))
        assert np.array_equal(np.isnan(got), np.isnan(ref))
        m = ~np.isnan(ref)
        np.testing.assert_allclose(got[m], ref[m], rtol=1e-12, atol=1e-14)
        assert np.isnan(ref[210:230]).all()  # OOB and NaN rows


@pytest.fixture(scope="module")
def ics():
    kw = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
    return jax_get_ichrone("synthetic", **kw), get_ichrone("synthetic", **kw)


def test_interp_mag_matches_jax(ics):
    """Magnitudes along EEP ladders (exact knots, running past track ends)
    plus random interior points, OOB and NaN."""
    jic, tic = ics
    rng = np.random.default_rng(2)
    eeps = np.concatenate([np.arange(1.0, 101.0), rng.uniform(1, 100, 100)])
    n = len(eeps)
    ages = np.where(np.arange(n) % 2 == 0, 9.0, rng.uniform(6.0, 10.1, n))
    fehs = np.where(np.arange(n) % 3 == 0, 0.0, rng.uniform(-2.0, 0.5, n))
    dists = rng.uniform(10, 2000, n)
    avs = rng.uniform(0, 1, n)
    ages[-3], fehs[-2], eeps[-1] = 10.5, np.nan, 100.0
    pars = [eeps, ages, fehs, dists, avs]
    bands = ["J", "H", "K", "G"]
    got = tic.interp_mag(pars, bands)
    ref = jic.interp_mag(pars, bands)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert np.array_equal(np.isnan(g), np.isnan(r))
        m = ~np.isnan(r)
        # atol for feh, which interpolates to ~1e-17 where it should be 0
        np.testing.assert_allclose(g[m], r[m], rtol=1e-12, atol=1e-14)
    assert np.isfinite(ref[3]).any() and np.isnan(ref[3]).any()
    for prop in ("eep", "age", "feh", "mass"):
        assert tic.get_limits(prop) == jic.get_limits(prop)


def test_exact_affine_float32_matches_jax():
    """The exact-affine floor fix-up in float32 (the card's dtype): EEP
    ladder points on the knots, between them and at the top knot locate the
    same cells with the same in-cell coordinate as the JAX function."""
    k = np.arange(1.0, 1711.0)
    amap = compute_axis_maps([k])[0]
    assert amap[0] == "exact_affine"
    rng = np.random.default_rng(3)
    x = np.concatenate([1.0 + 2.0 * np.arange(700), rng.uniform(1, 1710, 500), [1710.0, 0.5, 1711.0]])
    x32 = x.astype(np.float32)
    cell, t, oob = find_cells_1d(torch.as_tensor(k, dtype=torch.float32), torch.as_tensor(x32), axis_map=amap)
    jc, jt, jo = jax_find_cells_1d(jnp.asarray(k, dtype=jnp.float32), jnp.asarray(x32), axis_map=amap)
    assert np.asarray(jt).dtype == np.float32 and t.dtype == torch.float32
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(oob.numpy(), np.asarray(jo))
    assert np.all(t.numpy()[:700] == 0.0)  # ladder points sit exactly on knots
