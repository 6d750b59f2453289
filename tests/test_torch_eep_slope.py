"""The accurate EEP inversion's closed-form slope and its dispatchers on the
CPU, float64, inputs from a numpy seed.

``isochrones_torch.ops.eep.newton_slope`` is the plain version of the slope
that the forward-model kernel computes (``csrc/interp_common.cuh::
lerp_slope``): it is held against ``torch.autograd`` through the port's
``interp_nd`` where the value is finite and against ``jax.grad`` of the JAX
package's ``interp_nd``, to 1e-12 of the slope's scale (the same products,
summed in another order), on 3-d grids whose last axis takes every axis-map
kind, at points inside cells, on knots, on the top knot, next to NaN-padded
rows, off the grid and NaN. Against ``jax.grad`` the NaN patterns are
identical (a NaN-padded corner gives a NaN slope), only where the point is on
the grid: off it the two packages gather their zero-weighted corners from
other rows. Where the value is NaN, ``torch.autograd`` passes 0 (a NaN
output of ``interp_nd`` passes no gradient) and the closed form NaN or 0. ``get_eep_newton`` with that slope (``closed_slope``) is held against
the JAX ``get_eep_newton`` to 1e-10 in the EEP and the residual, on the track
and the isochrone grid, with identical NaN patterns. The CUDA wrappers of the
accurate forms refuse CPU tensors and name their caps; the CPU dispatchers
take the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_tpu.ops.eep as jeep
import isochrones_torch.ops.eep as teep
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.ops.interp import GridData as JaxGridData
from isochrones_tpu.ops.interp import interp_nd as jax_interp_nd
from isochrones_torch import get_ichrone
from isochrones_torch.convert import grid_from_numpy
from isochrones_torch.ops.generate import NewtonGrid, eep_newton, get_eep_accurate
from isochrones_torch.ops.generate_cuda import (
    MAX_BANDS, MAX_PROPS, eep_newton_cuda, generate_accurate_cuda, get_eep_accurate_cuda,
)
from isochrones_torch.ops.interp import compute_axis_maps, interp_nd

DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
RTOL_SLOPE = 1e-12
ATOL = 1e-10
KINDS = ["exact_affine", "affine", "log", "compare", "searchsorted"]


def _eep_knots(kind, n):
    """Knots of the last axis whose axis map is ``kind`` (searchsorted:
    irregular knots, more than ``compute_axis_maps`` compares)."""
    if kind == "exact_affine":
        k = np.arange(1.0, n + 1.0)
    elif kind == "affine":
        k = 0.37 * np.arange(1.0, n + 1.0)
    elif kind == "log":
        k = np.exp(np.linspace(0.0, np.log(300.0), n))
    else:
        d = 1.0 + 0.5 * np.sin(np.arange(n - 1))
        k = 1.0 + np.concatenate([[0.0], np.cumsum(d)])
    return k


def _grids(kind, seed=0):
    """The same 3-d grid in both packages: axes (affine, compare, ``kind``),
    two columns, a steep one along the last axis; some (i0, i1) rows
    NaN-padded past a row end, as tracks are."""
    rng = np.random.default_rng(seed)
    n0, n1, n2 = 5, 6, 40
    k0 = np.linspace(-1.0, 1.0, n0)
    k1 = np.sort(rng.uniform(0.5, 3.0, n1))
    k2 = _eep_knots(kind, n2)
    a, b, c = np.meshgrid(k0, k1, np.arange(n2), indexing="ij")
    col = 0.3 * a + b + 0.05 * c + 0.002 * c ** 2 + rng.normal(0, 0.01, a.shape)
    values = np.stack([col, np.sin(a + b) * c], axis=-1)
    ends = rng.integers(n2 // 2, n2 + 1, (n0, n1))
    values[np.arange(n2)[None, None, :] >= ends[:, :, None]] = np.nan
    knots = [k0, k1, k2]
    maps = compute_axis_maps(knots)
    if kind == "searchsorted":
        maps = maps[:2] + (None,)
    assert (maps[2] is None) if kind == "searchsorted" else maps[2][0] == kind, maps
    tgrid = grid_from_numpy(values, knots, ("m", "s"), axis_maps=maps, device="cpu", dtype=torch.float64)
    jgrid = JaxGridData(values=jnp.asarray(values), knots=tuple(jnp.asarray(k) for k in knots),
                        columns=("m", "s"), axis_maps=maps)
    return tgrid, jgrid, knots, ends


def _points(knots, ends, n=3000, seed=1):
    """Points inside cells, on every knot of the last axis (the top one
    too), at each row's last valid knot and just below it (next to the
    NaN-padded rows), on knots of the first two axes, off the grid, NaN."""
    rng = np.random.default_rng(seed)
    k0, k1, k2 = knots
    m = len(k2)
    e = np.interp(rng.uniform(0, m - 1, n), np.arange(m), k2)  # as many points a cell whatever the knots
    p = np.stack([rng.uniform(k0[0], k0[-1], n), rng.uniform(k1[0], k1[-1], n), e], -1)
    p[:m, 2] = k2
    p[m: m + 40, 0], p[m: m + 40, 1] = rng.choice(k0, 40), rng.choice(k1, 40)
    i0, i1 = rng.integers(0, len(k0), 200), rng.integers(0, len(k1), 200)
    last = k2[np.minimum(ends[i0, i1], m) - 1]
    sl = slice(m + 40, m + 240)
    p[sl, 0], p[sl, 1], p[sl, 2] = k0[i0], k1[i1], last
    p[m + 240: m + 440, :2] = p[sl, :2]
    p[m + 240: m + 440, 2] = last - 1e-7
    p[m + 440: m + 450, 2] = k2[-1] + 0.5  # off the grid
    p[m + 450, 0], p[m + 451, 1], p[m + 452, 2] = np.nan, np.nan, np.nan
    return p


def _autograd_slope(grid, pts, icol):
    x = torch.as_tensor(pts)
    with torch.enable_grad():
        e = x[:, 2].clone().requires_grad_(True)
        v = interp_nd(grid.values, grid.knots, torch.stack([x[:, 0], x[:, 1], e], -1), icols=(icol,),
                      axis_maps=grid.axis_maps)[:, 0]
        (g,) = torch.autograd.grad(v.sum(), e)
    return v.detach().numpy(), g.numpy()


def _jax_slope(jgrid, pts, icol):
    def f(e, a, b):
        return jax_interp_nd(jgrid.values, jgrid.knots, jnp.stack([a, b, e])[None], icols=(icol,),
                             axis_maps=jgrid.axis_maps)[0, 0]

    p = jnp.asarray(pts)
    return np.asarray(jax.vmap(jax.grad(f))(p[:, 2], p[:, 0], p[:, 1]))


def _assert_slopes(got, ref, name):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=name)
    fin = ~np.isnan(ref)
    scale = max(1.0, float(np.abs(ref[fin]).max()))
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL_SLOPE, atol=RTOL_SLOPE * scale, err_msg=name)
    return int(fin.sum())


@pytest.mark.parametrize("icol", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_newton_slope_matches_autograd_and_jax_grad(kind, icol):
    tgrid, jgrid, knots, ends = _grids(kind, seed=KINDS.index(kind))
    pts = _points(knots, ends, seed=icol)
    value, slope = teep.newton_slope(tgrid, torch.as_tensor(pts), icol)
    v_ref, g_ref = _autograd_slope(tgrid, pts, icol)
    np.testing.assert_array_equal(value.numpy(), v_ref)  # the value is interp_nd's, bitwise
    nan_v = np.isnan(v_ref)
    n_fin = _assert_slopes(slope.numpy()[~nan_v], g_ref[~nan_v], f"{kind} autograd")
    assert not np.isnan(slope.numpy()[~nan_v]).any()
    # a NaN value passes no gradient through interp_nd; the closed form keeps jax.grad's NaN
    assert (g_ref[nan_v] == 0.0).all()
    assert (np.isnan(slope.numpy()[nan_v]) | (slope.numpy()[nan_v] == 0.0)).all()
    assert n_fin > 1500 and np.isnan(slope.numpy()).sum() > 20  # NaN-padded corners give NaN slopes
    on = ~np.isnan(pts).any(axis=1) & (pts[:, 2] <= knots[2][-1])
    _assert_slopes(slope.numpy()[on], _jax_slope(jgrid, pts[on], icol), f"{kind} jax.grad")
    # t is a constant at the top knot (and at every knot on the searchsorted path): slope 0
    top = np.flatnonzero(pts[:, 2] == knots[2][-1])
    assert (slope.numpy()[top] == 0.0).all() and (g_ref[top] == 0.0).all()
    if kind == "searchsorted":
        at_knot = np.isin(pts[:, 2], knots[2])
        assert (slope.numpy()[at_knot] == 0.0).all()
    else:
        inner = np.flatnonzero(np.isin(pts[:, 2], knots[2][1:-1]) & np.isfinite(g_ref))
        assert len(inner) > 10 and (slope.numpy()[inner] != 0.0).any()


def test_newton_slope_batch_shape():
    tgrid, _, knots, ends = _grids("exact_affine")
    pts = torch.as_tensor(_points(knots, ends, n=600)[:600].reshape(20, 30, 3))
    value, slope = teep.newton_slope(tgrid, pts, 0)
    flat_v, flat_s = teep.newton_slope(tgrid, pts.reshape(-1, 3), 0)
    assert value.shape == slope.shape == (20, 30)
    np.testing.assert_array_equal(slope.reshape(-1).numpy(), flat_s.numpy())
    np.testing.assert_array_equal(value.reshape(-1).numpy(), flat_v.numpy())


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _queries(jtrack, n=1500, seed=3):
    rng = np.random.default_rng(seed)
    masses, fehs = jtrack.masses, jtrack.fehs
    mass = np.exp(rng.uniform(np.log(0.08), np.log(11.0), n))
    age = rng.uniform(5.5, 10.6, n)
    feh = rng.uniform(-2.2, 0.7, n)
    mass[: len(masses)] = masses
    feh[len(masses): len(masses) + len(fehs)] = fehs
    age[101:110] = 10.55  # past the end of every track: the fast seed is NaN, the scan runs
    mass[120], age[121], feh[122] = np.nan, np.nan, np.nan
    return mass, age, feh


def _same(got, ref, atol=ATOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=atol)
    return int(fin.sum())


@pytest.mark.parametrize("grid", ["track", "iso"])
def test_get_eep_newton_closed_slope_matches_jax(ics, grid):
    jiso, tiso = ics
    mass, age, feh = _queries(jiso.track)
    if grid == "track":
        jic, tic = jiso.track, tiso.track
        seed = np.array(jic.get_eep(mass, age, feh))
        seed[::7] = np.nan
        args, icol = (age, feh, mass), jic.model.column_index["age"]
    else:
        jic, tic = jiso, tiso
        seed = np.full(len(mass), 300.0)
        seed[::5] = np.nan
        seed[1::5] = np.random.default_rng(0).uniform(1.0, 100.0, len(seed[1::5]))
        args, icol = (mass, age, feh), jic.model.column_index["initial_mass"]
    jeep_, jres = jeep.get_eep_newton(jic.model, jnp.asarray(seed), *(jnp.asarray(a) for a in args), icol)
    t = [torch.as_tensor(np.asarray(a)) for a in (seed,) + args]
    teep_, tres = teep.get_eep_newton(tic.model, *t, icol, closed_slope=True)
    assert _same(teep_.numpy(), jeep_) > 300
    _same(tres.numpy(), jres)
    # and the autograd slope's iteration, which the plain path keeps
    auto, _ = teep.get_eep_newton(tic.model, *t, icol)
    _same(teep_.numpy(), auto.numpy(), atol=1e-11)


def test_accurate_dispatchers_take_the_plain_version_on_the_cpu(ics):
    _, tiso = ics
    tr = tiso.track
    mass, age, feh = (torch.as_tensor(x) for x in _queries(tr, n=800, seed=8))
    want = tr.get_eep_batch(mass, age, feh, accurate=True)
    np.testing.assert_array_equal(get_eep_accurate(tr._forward_model, mass, age, feh).numpy(), want.numpy())
    seed = torch.full_like(mass, 300.0)
    eep, r = teep.get_eep_newton(tiso.model, seed, mass, age, feh, tiso.model.column_index["initial_mass"])
    cut = torch.where(r.abs() < 0.02, eep, torch.full_like(eep, float("nan")))
    got = eep_newton(tiso._newton_grid, seed, mass, age, feh)
    np.testing.assert_array_equal(got.numpy(), cut.numpy())
    np.testing.assert_array_equal(got.numpy(), tiso.get_eep_batch(mass, age, feh, accurate=True).numpy())
    # broadcast shapes are kept
    assert eep_newton(tiso._newton_grid, seed.reshape(20, 40), *(x.reshape(20, 40) for x in (mass, age, feh))).shape \
        == (20, 40)


def test_accurate_cuda_wrappers_refuse_cpu_and_name_caps(ics):
    _, tiso = ics
    fm, ng = tiso.track._forward_model, tiso._newton_grid
    x = torch.ones(4, dtype=torch.float64)
    for fn in (lambda: generate_accurate_cuda(fm, x, x, x, x, x, (0,), (0,)),
               lambda: get_eep_accurate_cuda(fm, x, x, x),
               lambda: eep_newton_cuda(ng, x, x, x, x)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn()
    with pytest.raises(ValueError, match=f"at most {MAX_PROPS} model columns"):
        generate_accurate_cuda(fm, x, x, x, x, x, (0,) * (MAX_PROPS + 1), (0,))
    with pytest.raises(ValueError, match=f"at most {MAX_BANDS} bands"):
        generate_accurate_cuda(fm, x, x, x, x, x, (0,), (0,) * (MAX_BANDS + 1))
    huge = torch.zeros(1, dtype=torch.float64).expand(1 << 31)  # no memory: one element, stride 0
    for fn in (lambda: get_eep_accurate_cuda(fm, huge, huge, huge), lambda: eep_newton_cuda(ng, huge, huge, huge, huge),
               lambda: generate_accurate_cuda(fm, huge, huge, huge, huge, huge, (0,), (0,))):
        with pytest.raises(ValueError, match=r"N < 2\*\*31"):
            fn()
    with pytest.raises(ValueError, match="cpu or cuda"):
        get_eep_accurate(fm, x.to("meta"), x, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        eep_newton(ng, x, x.to("meta"), x, x)
