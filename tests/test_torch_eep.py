"""Port parity of EEP inversion and root finding on the CPU, float64:
``isochrones_torch.ops.eep``, ``isochrones_torch.ops.rootfind`` and the
interpolators' ``get_eep``/``max_eep`` against the JAX package on a small
synthetic grid, inputs from a numpy seed.

Tolerances: ``searchsorted_rows`` exact; ``interp_eep`` and the fast
``get_eep`` 1e-10 absolute (the same arithmetic on integer EEPs, sums in the
same order); ``get_eep_newton`` and the accurate ``get_eep`` 1e-10 absolute
in the EEP and in the residual (both iterate to the same fixed point of a
piecewise-linear residual; the derivative is the located cell's slope in
both); the root finders to their own stopping tolerance, stated at the test.
NaN patterns are identical throughout.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_tpu.ops.eep as jeep
import isochrones_tpu.ops.rootfind as jroot
import isochrones_torch.ops.eep as teep
import isochrones_torch.ops.rootfind as troot
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.ops.interp import GridData as JaxGridData
from isochrones_tpu.ops.interp import compute_axis_maps as jax_axis_maps
from isochrones_torch import get_ichrone
from isochrones_torch.convert import grid_from_numpy

DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
ATOL = 1e-10


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _assert_same(got, ref, atol=ATOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=atol)
    return int(fin.sum())


def _queries(jtrack, n=4000, seed=0):
    """(mass, age, feh) spread past the grid on every side, with exact mass
    and feh knots (the top ones too), ages past short and full-length tracks,
    NaN in each coordinate."""
    rng = np.random.default_rng(seed)
    masses, fehs = jtrack.masses, jtrack.fehs
    mass = np.exp(rng.uniform(np.log(0.08), np.log(11.0), n))
    age = rng.uniform(5.5, 10.6, n)
    feh = rng.uniform(-2.2, 0.7, n)
    mass[: len(masses)] = masses
    feh[len(masses): len(masses) + len(fehs)] = fehs
    mass[100], feh[100] = masses[-1], fehs[-1]
    age[101:110] = 10.55  # past the end of every track
    age[110:120] = 5.0  # before the start
    mass[120], age[121], feh[122] = np.nan, np.nan, np.nan
    mass[123], feh[124] = 0.05, 0.9  # out of bounds
    return mass, age, feh


@pytest.mark.parametrize("n_cols", [1, 2, 7, 64, 100])
def test_searchsorted_rows_matches_jax(n_cols):
    rng = np.random.default_rng(n_cols)
    n_rows = 13
    rows = np.sort(rng.normal(0, 1, (n_rows, n_cols)), axis=1)
    lengths = rng.integers(1, n_cols + 1, n_rows)
    rows[np.arange(n_cols)[None, :] >= lengths[:, None]] = np.inf
    idx = rng.integers(0, n_rows, 500)
    x = rng.normal(0, 1.5, 500)
    x[:50] = rows[idx[:50], rng.integers(0, n_cols, 50)]  # exact entries (some +inf)
    ref = np.asarray(jeep.searchsorted_rows(jnp.asarray(rows.reshape(-1)), jnp.asarray(idx), jnp.asarray(x), n_cols))
    got = teep.searchsorted_rows(_t(rows.reshape(-1)), _t(idx), _t(x), n_cols)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    finite = np.isfinite(x)
    want = np.array([np.searchsorted(rows[i], v, side="left") for i, v in zip(idx[finite], x[finite])])
    # past a full row the fixed-step search may say n_cols + 1 (see its docstring)
    np.testing.assert_array_equal(np.minimum(got.numpy(), n_cols)[finite], want)


def test_interp_eep_matches_jax(ics):
    jiso, tiso = ics
    mass, age, feh = _queries(jiso.track)
    jf, jm, ja, jl = jiso.track.eep_support
    tf, tm, ta, tl = tiso.track.eep_support
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    ref = jeep.interp_eep(jnp.asarray(age), jnp.asarray(feh), jnp.asarray(mass), jf, jm, ja, jl, eep0=1.0)
    got = teep.interp_eep(_t(age), _t(feh), _t(mass), tf, tm, ta, tl, eep0=1.0)
    n_fin = _assert_same(got.numpy(), ref)
    assert 1000 < n_fin < len(mass)
    # every track of this grid ends early (+inf padding), so a query past an
    # end takes the neighbour substitution
    assert np.asarray(jl).max() < DIMS["n_eep"]


def test_interp_eep_full_and_short_tracks_match_jax():
    """Hand-made support arrays: full-length tracks beside short ones, so
    that queries land past a full track (NaN), past a short one (its
    neighbour's EEP, substituted in sequence) and on exact entries."""
    rng = np.random.default_rng(11)
    n_feh, n_mass, n_eep = 4, 5, 16
    fehs = np.array([-1.0, -0.5, 0.0, 0.5])
    masses = np.array([0.5, 0.8, 1.0, 1.5, 3.0])
    ages = np.sort(rng.uniform(6.0, 10.0, (n_feh * n_mass, n_eep)), axis=1)
    lengths = rng.integers(3, n_eep + 1, n_feh * n_mass)
    lengths[[0, 1, 6, 7, 12, 19]] = n_eep  # full-length tracks, two of them neighbours
    ages[np.arange(n_eep)[None, :] >= lengths[:, None]] = np.inf
    n = 3000
    age = rng.uniform(5.8, 10.2, n)
    feh = rng.choice(np.concatenate([fehs, rng.uniform(-1.1, 0.6, 40)]), n)
    mass = rng.choice(np.concatenate([masses, rng.uniform(0.4, 3.2, 40)]), n)
    age[:200] = ages[rng.integers(0, n_feh * n_mass, 200), rng.integers(0, n_eep, 200)]  # exact entries and +inf
    age[200], feh[201], mass[202] = np.nan, np.nan, np.nan
    ref = jeep.interp_eep(jnp.asarray(age), jnp.asarray(feh), jnp.asarray(mass), jnp.asarray(fehs),
                          jnp.asarray(masses), jnp.asarray(ages), jnp.asarray(lengths), eep0=5.0)
    got = teep.interp_eep(_t(age), _t(feh), _t(mass), _t(fehs), _t(masses), _t(ages), _t(lengths), eep0=5.0)
    n_fin = _assert_same(got.numpy(), ref)
    assert 500 < n_fin < n - 500


@pytest.mark.parametrize("grid", ["track", "iso"])
def test_get_eep_newton_matches_jax(ics, grid):
    jiso, tiso = ics
    mass, age, feh = _queries(jiso.track, n=1500, seed=3)
    if grid == "track":
        jic, tic = jiso.track, tiso.track
        seed = np.array(jic.get_eep(mass, age, feh))
        seed[::7] = np.nan  # the scan seed takes over
        args = (age, feh, mass)
        icol = jic.model.column_index["age"]
    else:
        jic, tic = jiso, tiso
        seed = np.full(len(mass), 300.0)  # past this grid's top EEP: clamped
        seed[::5] = np.nan
        args = (mass, age, feh)
        icol = jic.model.column_index["initial_mass"]
    jeep_, jres = jeep.get_eep_newton(jic.model, jnp.asarray(seed), *(jnp.asarray(a) for a in args), icol)
    teep_, tres = teep.get_eep_newton(tic.model, _t(seed), *(_t(a) for a in args), icol)
    assert not teep_.requires_grad and not tres.requires_grad
    n_fin = _assert_same(teep_.numpy(), jeep_)
    _assert_same(tres.numpy(), jres)
    assert n_fin > 300
    with torch.no_grad():  # the derivative is taken inside, whatever the caller's mode
        again, _ = teep.get_eep_newton(tic.model, _t(seed), *(_t(a) for a in args), icol)
    np.testing.assert_array_equal(again.numpy(), teep_.numpy())


@pytest.mark.parametrize("accurate", [False, True], ids=["fast", "accurate"])
def test_track_get_eep_matches_jax(ics, accurate):
    jiso, tiso = ics
    mass, age, feh = _queries(jiso.track)
    ref = jiso.track.get_eep(mass, age, feh, accurate=accurate)
    got = tiso.track.get_eep(mass, age, feh, accurate=accurate)
    assert _assert_same(got, ref) > 1000
    # scalars give a float, broadcasting follows numpy
    assert tiso.track.get_eep(1.0, 9.0, 0.0, accurate=accurate) == pytest.approx(
        jiso.track.get_eep(1.0, 9.0, 0.0, accurate=accurate), abs=ATOL)
    got2 = tiso.track.get_eep(mass[:6].reshape(2, 3), 9.2, 0.1, accurate=accurate)
    assert got2.shape == (2, 3)
    _assert_same(got2, jiso.track.get_eep(mass[:6].reshape(2, 3), 9.2, 0.1, accurate=accurate))
    if accurate:
        _assert_same(tiso.track.get_eep_accurate(mass[:50], age[:50], feh[:50]), ref[:50])


def test_iso_get_eep_matches_jax(ics):
    jiso, tiso = ics
    mass, age, feh = _queries(jiso.track, seed=5)
    ref = jiso.get_eep(mass, age, feh, accurate=True)
    got = tiso.get_eep(mass, age, feh, accurate=True)
    assert _assert_same(got, ref) > 1000
    with pytest.raises(NotImplementedError, match="isochrone grids"):
        tiso.get_eep(1.0, 9.0, 0.0)
    # a mass -> EEP -> mass round trip on the isochrone grid
    ok = np.isfinite(got)
    back = tiso.interp_value([got[ok], age[ok], feh[ok]], ["initial_mass"])[:, 0]
    np.testing.assert_allclose(back, mass[ok], atol=0.02)


def test_get_eep_chunks_equal_one_call(ics, monkeypatch):
    _, tiso = ics
    import isochrones_torch.models.interpolator as mod

    mass, age, feh = _queries(tiso.track, n=700, seed=9)
    whole = tiso.track.get_eep(mass, age, feh, accurate=True)
    monkeypatch.setattr(mod, "HOST_CHUNK", 256)
    monkeypatch.setattr(teep, "_SCAN_POINTS", 1000)
    np.testing.assert_array_equal(tiso.track.get_eep(mass, age, feh, accurate=True), whole)


def test_max_eep_and_mass_age_resid_match_jax(ics):
    jiso, tiso = ics
    rng = np.random.default_rng(2)
    masses, fehs = jiso.track.masses, jiso.track.fehs
    np.testing.assert_array_equal(tiso.track.masses, masses)
    np.testing.assert_array_equal(tiso.track.fehs, fehs)
    np.testing.assert_array_equal(tiso.ages, jiso.ages)
    with pytest.raises(AttributeError):
        tiso.masses
    with pytest.raises(AttributeError):
        tiso.track.ages
    pairs = [(m, f) for m in masses[::5] for f in fehs[::3]]  # exact knots
    pairs += list(zip(rng.uniform(0.05, 12.0, 40), rng.uniform(-2.5, 0.8, 40)))  # inside and outside
    for m, f in pairs:
        assert tiso.track.max_eep(m, f) == jiso.track.max_eep(m, f)
    assert tiso.max_eep(1.0, 0.0) == jiso.max_eep(1.0, 0.0) == tiso.maxeep  # no support arrays on the iso grid
    # (the JAX methods convert a 1-element array with float(), which numpy deprecates)
    want = (9.0 - float(jiso.track.interp_value([1.0, 40.0, 0.0], ["age"])[0])) ** 2
    assert tiso.track.mass_age_resid(40.0, 1.0, 9.0, 0.0) == pytest.approx(want, rel=1e-12)
    want = (1.0 - float(jiso.interp_value([40.0, 9.0, 0.0], ["initial_mass"])[0])) ** 2
    assert tiso.mass_age_resid(40.0, 1.0, 9.0, 0.0) == pytest.approx(want, rel=1e-12)
    with pytest.raises(NotImplementedError):
        type(tiso).__mro__[1].mass_age_resid(tiso)


def test_forward_model_names_its_item(ics):
    """The forward model's item has landed: each method runs on the CPU
    (its parity is ``tests/test_torch_generate.py``'s)."""
    _, tiso = ics
    for fn in (tiso.generate, tiso.track.generate):
        df = fn(1.0, 9.0, 0.0)
        assert len(df["J_mag"]) == 1 and np.isfinite(df["J_mag"]).all()
    assert len(tiso.generate_binary(1.0, 0.8, 9.0, 0.0)["J_mag"]) == 1
    eeps, values, mags = tiso.generate_device(1.0, 9.0, 0.0)
    assert eeps.shape == (1,) and values.shape == (1, len(tiso.model.columns)) and mags.shape == (1, len(tiso.bands))
    assert len(tiso.isochrone(9.0, 0.0)["eep"]) > 10
    assert np.isfinite(tiso.model_value(1.0, 9.0, 0.0, "radius")) and np.isfinite(tiso.model_mag(1.0, 9.0, 0.0)).all()


# ------------------------------------------------------------------ root finder
def _monotone_grid():
    """The grid of ``tests/test_oracle_parity.py::test_find_closest_vs_reference``:
    a column strictly monotone along the last axis."""
    k0 = np.linspace(-1.0, 1.0, 5)
    k1 = np.linspace(0.5, 2.0, 6)
    k2 = np.linspace(0.0, 100.0, 40)
    A, B, C = np.meshgrid(k0, k1, k2, indexing="ij")
    col = 0.5 * A + 0.3 * B + 0.04 * C + 0.0005 * C ** 2
    values = np.stack([col, col * 0 + 1.0], axis=-1)
    knots = [k0, k1, k2]
    jgrid = JaxGridData(values=jnp.asarray(values), knots=tuple(jnp.asarray(k) for k in knots),
                        columns=("m", "one"), axis_maps=jax_axis_maps(knots))
    tgrid = grid_from_numpy(values, knots, ("m", "one"), device="cpu", dtype=torch.float64)
    return jgrid, tgrid, values, knots


def test_find_closest_grid_matches_jax_and_oracle():
    """Both packages walk the same bisection and secant path in float64, so
    they agree far inside the solver's own tolerance (|residual| <= 0.01):
    1e-9 in x. The oracle (the reference's scalar loop) is held as the JAX
    test holds it: residual within newton_tol, x within 0.5."""
    import reference_oracle as ref

    jgrid, tgrid, values, knots = _monotone_grid()
    rng = np.random.default_rng(42)
    newton_tol = 0.01
    cases = []
    for _ in range(25):
        v1, v2, x_true = rng.uniform(-0.9, 0.9), rng.uniform(0.6, 1.9), rng.uniform(5.0, 95.0)
        val = float(ref.ref_interp_value((v1, v2, x_true), values, [0], knots)[0])
        cases.append((val, 0.0, 100.0, v1, v2))
        got = troot.find_closest_grid(tgrid, val, 0.0, 100.0, v1, v2, 0)
        assert got.shape == ()
        want_jax = float(jroot.find_closest_grid(jgrid, val, 0.0, 100.0, v1, v2, 0))
        assert float(got) == pytest.approx(want_jax, abs=1e-9)
        want = ref.ref_find_closest3(val, 0.0, 100.0, v1, v2, values, 0, knots)
        resid = float(ref.ref_interp_value((v1, v2, float(got)), values, [0], knots)[0]) - val
        assert abs(resid) <= newton_tol + 1e-9 and abs(float(got) - want) < 0.5
    # same-sign bracket -> NaN in all three
    got = float(troot.find_closest_grid(tgrid, -100.0, 0.0, 100.0, 0.0, 1.0, 0))
    assert math.isnan(got) and math.isnan(float(jroot.find_closest_grid(jgrid, -100.0, 0.0, 100.0, 0.0, 1.0, 0)))
    assert math.isnan(ref.ref_find_closest3(-100.0, 0.0, 100.0, 0.0, 1.0, values, 0, knots))

    # the batch: the cases above plus every precedence rule of the bracket
    col = lambda v1, v2, x: float(ref.ref_interp_value((v1, v2, x), values, [0], knots)[0])  # noqa: E731
    cases += [
        (-100.0, 0.0, 100.0, 0.0, 1.0),  # same sign -> NaN
        (col(0.0, 1.0, 0.0) + 0.005, 0.0, 100.0, 0.0, 1.0),  # |y(a)| < tol -> a, though the signs agree
        (col(0.0, 1.0, 100.0) - 0.005, 0.0, 100.0, 0.0, 1.0),  # |y(b)| < tol -> b
        (1.0, -5.0, 100.0, 0.0, 1.0),  # a off the grid: NaN bracket -> NaN
        (col(0.0, 1.0, 100.0) - 0.005, -5.0, 100.0, 0.0, 1.0),  # NaN bracket wins over the shortcut
        (np.nan, 0.0, 100.0, 0.0, 1.0),
    ]
    arr = np.array(cases).T
    ref_b = np.asarray(jroot.find_closest_grid_batch(jgrid, *(jnp.asarray(a) for a in arr), 0))
    got_b = troot.find_closest_grid_batch(tgrid, *(_t(a) for a in arr), 0).numpy()
    _assert_same(got_b, ref_b, atol=1e-9)
    assert np.isnan(got_b[25]) and got_b[26] == 0.0 and got_b[27] == 100.0 and np.isnan(got_b[28:30]).all()
    for c, x in zip(cases, got_b):
        assert float(troot.find_closest_grid(tgrid, *c, 0)) == pytest.approx(x, abs=1e-12, nan_ok=True)
    # the root at the first midpoint: whether the residual there is exactly 0
    # hangs on the last bit, so only the solver's own tolerance holds
    x = float(troot.find_closest_grid(tgrid, col(0.3, 1.2, 50.0), 0.0, 100.0, 0.3, 1.2, 0))
    assert abs(col(0.3, 1.2, x) - col(0.3, 1.2, 50.0)) <= newton_tol


def test_find_closest_stalled_secant_ends_as_nan():
    """A flat stretch stalls the secant (y1 == y0): the division gives inf,
    the residual there is NaN and the lane ends as NaN, in both packages."""
    k0, k1 = np.array([0.0, 1.0]), np.array([0.0, 1.0])
    k2 = np.linspace(0.0, 64.0, 65)
    col = np.where(k2 < 16.0, -1.0, np.where(k2 > 48.0, 1.0, 0.5))  # a plateau at 0.5 around the midpoint
    values = np.broadcast_to(col[None, None, :, None], (2, 2, 65, 1)).copy()
    knots = [k0, k1, k2]
    jgrid = JaxGridData(values=jnp.asarray(values), knots=tuple(jnp.asarray(k) for k in knots),
                        columns=("m",), axis_maps=jax_axis_maps(knots))
    tgrid = grid_from_numpy(values, knots, ("m",), device="cpu", dtype=torch.float64)
    args = (0.0, 0.0, 64.0, 0.5, 0.5)
    got = float(troot.find_closest_grid(tgrid, *args, 0, bisect_tol=8.0))
    want = float(jroot.find_closest_grid(jgrid, *args, 0, bisect_tol=8.0))
    assert math.isnan(want) and math.isnan(got)


def test_find_closest_on_the_isochrone_grid(ics):
    """Mass -> EEP on the isochrone grid by the root finder, against JAX and
    against the Newton inversion: the secant stops at |residual| < 0.01 solar
    masses, so the two inversions agree only that far."""
    jiso, tiso = ics
    icol = jiso.model.column_index["initial_mass"]
    rng = np.random.default_rng(4)
    n = 60
    age, feh = rng.uniform(8.5, 9.8, n), rng.uniform(-1.0, 0.3, n)
    eep = rng.uniform(5.0, 60.0, n)
    mass = tiso.interp_value([eep, age, feh], ["initial_mass"])[:, 0]
    lo, hi = eep - 2.3, eep + 3.9  # the root away from every bisection midpoint
    ref = np.asarray(jroot.find_closest_grid_batch(
        jiso.model, jnp.asarray(mass), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(age), jnp.asarray(feh), icol))
    got = troot.find_closest_grid_batch(tiso.model, mass, lo, hi, age, feh, icol).numpy()
    assert _assert_same(got, ref, atol=1e-8) > n // 2
    ok = np.isfinite(got)
    back = tiso.interp_value([got[ok], age[ok], feh[ok]], ["initial_mass"])[:, 0]
    assert np.abs(back - mass[ok]).max() < 0.01
