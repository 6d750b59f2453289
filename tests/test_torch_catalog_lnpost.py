"""The catalog posterior's plain version, reading the packed prior constants
(``isochrones_torch.ops.catalog.pack_catalog_priors``), against the JAX
package's ``BatchStarFitter._build_lnpost_data`` on the CPU, float64, small
synthetic grid.

Tolerance: 1e-10 + 1e-15 |ref| on the finite entries (the relative part is
a few ulps where |lnpost| passes 1e5), with identical NaN, +inf and
-inf patterns: the same operations in the same order, XLA's and torch's
exp/log differing in the last bits. The cases pin the semantics the CUDA
kernel keeps: stars with a NaN Teff, band or parallax; EEPs outside
``eep_bounds`` and on them (inclusive); distances at and past 0 and the
star's bound (strict on both sides); AV past ``maxAV``; EEP-prior
quantities outside the Chabrier bounds and past the power law's 100; a
non-default halo fraction; the unit-cube form (bitwise the box map followed
by the parameter form); replaced priors, which take the composition route.
The float32 test pins the floors: ``clamp(x, min=1e-300)`` is 0 in float32,
in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu import priors as jax_priors
from isochrones_tpu.batch import BatchStarFitter as JaxBatchStarFitter
from isochrones_tpu.catalog import StarCatalog as JaxStarCatalog
from isochrones_torch import StarCatalog, get_ichrone
from isochrones_torch import priors as torch_priors
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.ops.catalog import (
    CONST_NAMES, _feh_lnpdf, _mass_lnpdf, catalog_lnpost, catalog_lnpost_plain, pack_catalog_priors, unit_box,
)
from isochrones_torch.ops.catalog_cuda import compact_bc

BANDS = ("J", "H", "K")
SMALL = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
PARAMS = ("eep", "age", "feh", "distance", "AV")
#: truths on the small grid; star 6 lacks H, star 7 its parallax, star 8 its
#: Teff, star 9 its logg and [Fe/H]
TRUTHS = np.array([
    [40.0, 8.6, -0.3, 150.0, 0.05], [55.0, 9.0, 0.0, 200.0, 0.1], [70.0, 9.3, 0.2, 300.0, 0.2],
    [60.0, 8.8, -0.1, 250.0, 0.15], [50.0, 9.1, 0.1, 180.0, 0.08], [65.0, 8.7, -0.2, 220.0, 0.12],
    [45.0, 9.0, 0.0, 190.0, 0.1], [52.0, 8.9, 0.1, 210.0, 0.1], [58.0, 9.2, -0.1, 230.0, 0.1],
    [48.0, 9.0, 0.05, 170.0, 0.3],
])
S = len(TRUTHS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these small tensors run faster without a pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grids():
    jiso = jax_get_ichrone("synthetic", **SMALL)
    Teff, logg, _, mags = jiso.interp_mag([TRUTHS[:, i] for i in range(5)], list(BANDS))
    rng = np.random.default_rng(0)
    cols = {}
    for i, b in enumerate(BANDS):
        cols[f"{b}_mag"] = np.asarray(mags)[:, i] + rng.normal(0, 0.02, S)
        cols[f"{b}_mag_unc"] = np.full(S, 0.02)
    cols["Teff"], cols["Teff_unc"] = np.asarray(Teff) + rng.normal(0, 50, S), np.full(S, 80.0)
    cols["logg"], cols["logg_unc"] = np.asarray(logg) + rng.normal(0, 0.03, S), np.full(S, 0.05)
    cols["feh"], cols["feh_unc"] = TRUTHS[:, 2] + rng.normal(0, 0.05, S), np.full(S, 0.1)
    cols["parallax"], cols["parallax_unc"] = 1000.0 / TRUTHS[:, 3], np.full(S, 0.05)
    cols["H_mag"][6] = np.nan
    cols["parallax"][7] = np.nan
    cols["Teff"][8] = np.nan
    cols["logg"][9] = cols["feh"][9] = np.nan
    return jiso, get_ichrone("synthetic", device="cpu", **SMALL), pd.DataFrame(cols)


def _fitters(grids, edit=None, **kw):
    """The JAX and the torch fitter on the same catalog with the same
    settings; ``edit(priors, module)`` changes both fitters' priors."""
    jiso, tiso, df = grids
    props = ("Teff", "logg", "feh", "parallax")
    jf = JaxBatchStarFitter(jiso, JaxStarCatalog(df, bands=BANDS, props=props), **kw)
    tf = BatchStarFitter(tiso, StarCatalog({c: df[c].values for c in df}, bands=BANDS), bands=BANDS, **kw)
    if edit is not None:
        edit(jf.priors, jax_priors)
        edit(tf.priors, torch_priors)
    return jf, tf


def _points(B, seed, tweak=None):
    """(S, B, 5): truths, points about them, points over and past the grid,
    a NaN row; ``tweak(p, rng)`` sets more."""
    rng = np.random.default_rng(seed)
    p = TRUTHS[:, None, :] + rng.normal(0, [8.0, 0.2, 0.15, 30.0, 0.08], (S, B, 5))
    p[:, 0] = TRUTHS
    p[:, 1:9] = rng.uniform([1, 5.5, -2.5, -10, -0.1], [110, 10.5, 0.8, 3000, 1.2], (S, 8, 5))
    p[:, 9, 2] = np.nan
    if tweak is not None:
        tweak(p, rng)
    return p


def _assert_same(got, ref, atol=1e-10):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    for f in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(f(got), f(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-15, atol=atol)


def _jax_lnpost(jf, pars):
    return np.asarray(jf._build_lnpost_data()(jf.star_data, jnp.asarray(pars)))


def _plain(tf, pars, his=None):
    out, orig = catalog_lnpost_plain(torch.as_tensor(pars), tf._catalog_likelihood(), tf._catalog_priors(),
                                     None if his is None else torch.as_tensor(his))
    assert orig is None  # every default prior is packed
    return out.numpy()


def _case_holes(grids):
    jf, tf = _fitters(grids)
    pars = _points(40, seed=1)
    return _plain(tf, pars), _jax_lnpost(jf, pars)


def _case_eep_bounds(grids):
    def tweak(p, rng):
        p[:, 10:40, 0] = rng.uniform(20.0, 90.0, (S, 30))
        p[:, 10, 0], p[:, 11, 0], p[:, 12, 0], p[:, 13, 0] = 30.0, 80.0, 29.999999, 80.000001

    jf, tf = _fitters(grids, eep_bounds=(30, 80))
    pars = _points(40, seed=2, tweak=tweak)
    return _plain(tf, pars), _jax_lnpost(jf, pars)


def _case_distance(grids):
    jf, tf = _fitters(grids)
    d_hi = tf.max_distance

    def tweak(p, rng):
        for j, d in enumerate((-5.0, -0.0, 0.0, 1e-300, 1e-30)):
            p[:, 10 + j, 3] = d
        p[:, 15, 3] = d_hi
        p[:, 16, 3] = d_hi * (1 - 1e-12)
        p[:, 17, 3] = d_hi * (1 + 1e-12)
        p[:, 18:30, 3] = rng.uniform(0.5, 2.0, (S, 12)) * d_hi[:, None]

    pars = _points(30, seed=3, tweak=tweak)
    return _plain(tf, pars), _jax_lnpost(jf, pars)


def _case_av(grids):
    def tweak(p, rng):
        for j, av in enumerate((-0.01, 0.0, 0.25, 0.5, 0.5000001, 0.9)):
            p[:, 10 + j, 4] = av

    jf, tf = _fitters(grids, maxAV=0.5)
    pars = _points(24, seed=4, tweak=tweak)
    return _plain(tf, pars), _jax_lnpost(jf, pars)


def _case_mass_bounds(grids):
    def edit(priors, _):
        priors["mass"].bounds = (0.5, 2.0)

    def tweak(p, rng):
        p[:, 10:48, 0] = np.linspace(1.0, 100.0, 38)  # the EEP ladder: masses over the whole grid

    jf, tf = _fitters(grids, edit=edit)
    pars = _points(48, seed=5, tweak=tweak)
    got, ref = _plain(tf, pars), _jax_lnpost(jf, pars)
    assert np.isneginf(ref[:, 10:48]).sum() > 20 and np.isfinite(ref[:, 10:48]).sum() > 20
    return got, ref


def _case_mass_values(grids):
    """The packed Chabrier term alone, with the broken prior's bounds past
    the power law's (1, 100), so that its own bound decides above 100."""
    def edit(priors, _):
        priors["mass"].bounds = (0.1, 200.0)

    jf, tf = _fitters(grids, edit=edit)
    x = np.array([np.nan, -1.0, 0.0, 0.05, 0.1, 0.5, 1 - 1e-12, 1.0, 1 + 1e-12, 50.0, 100.0, 100.5, 150.0, 200.0,
                  250.0, np.inf])
    got = _mass_lnpdf(torch.as_tensor(x), tf._catalog_priors().consts).numpy()
    ref = np.asarray(jf.priors["mass"].lnpdf_jax(jnp.asarray(x)))
    assert np.isneginf(ref[11:13]).all() and np.isfinite(ref[[4, 7, 10]]).all()
    return got, ref


def _case_halo_fraction(grids):
    jf, tf = _fitters(grids, halo_fraction=0.3)
    assert tf._catalog_priors().consts["feh_halo"] == 0.3
    pars = _points(32, seed=6)
    return _plain(tf, pars), _jax_lnpost(jf, pars)


def _case_unit_cube(grids):
    """The unit-cube form against the JAX posterior at the box's parameters,
    and bitwise against the box map followed by the parameter form."""
    jf, tf = _fitters(grids)
    los, his = tf._bounds_arrays()
    rng = np.random.default_rng(7)
    u = rng.uniform(0, 1, (S, 40, 5))
    u[:, :5] = np.clip(TRUTHS[:, None, :] + rng.normal(0, [3.0, 0.05, 0.05, 10.0, 0.03], (S, 5, 5)) - los, 0,
                       None) / (his - los)[:, None, :]
    u[:, 5, :], u[:, 6, :], u[:, 7, 3] = 0.0, 1.0, 1.0
    ut, hist = torch.as_tensor(u), torch.as_tensor(his)
    got = _plain(tf, u, his)
    box = _plain(tf, unit_box(ut, tf._catalog_priors(), hist).numpy())
    np.testing.assert_array_equal(got, box)
    np.testing.assert_array_equal(got, tf._lnpost(ut, his=hist).numpy())
    np.testing.assert_array_equal(got, catalog_lnpost(ut, tf._catalog_likelihood(), tf._catalog_priors(),
                                                      hist)[0].numpy())
    pars = los[None, None] + (his[:, None] - los[None, None]) * u
    return got, _jax_lnpost(jf, pars)


def _case_replaced_priors(grids):
    """Priors of other classes: their flags are off and the fitter adds
    their own lnpdf after the posterior call (the composition route)."""
    def edit(priors, mod):
        priors["age"] = mod.GaussianPrior(9.0, 0.4, bounds=(6.5, 10.0))
        priors["mass"] = mod.SalpeterPrior(bounds=(0.2, 5.0))

    jf, tf = _fitters(grids, edit=edit)
    pri = tf._catalog_priors()
    assert pri.on == (False, True, True, False)
    pars = _points(40, seed=8)
    out, orig = catalog_lnpost_plain(torch.as_tensor(pars), tf._catalog_likelihood(), pri)
    assert orig is not None and orig.shape == out.shape
    got = tf.lnpost_batch(pars).numpy()
    ref = _jax_lnpost(jf, pars)
    assert np.isfinite(ref).sum() > 100 and np.isneginf(ref).sum() > 50
    return got, ref


CASES = {
    "nan_spectroscopy_band_parallax": _case_holes, "eep_outside_bounds": _case_eep_bounds,
    "distance_bounds": _case_distance, "av_beyond_max": _case_av, "orig_val_outside_chabrier": _case_mass_bounds,
    "orig_val_above_100": _case_mass_values, "halo_fraction": _case_halo_fraction, "unit_cube": _case_unit_cube,
    "replaced_priors": _case_replaced_priors,
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lnpost_matches_jax(grids, case):
    got, ref = CASES[case](grids)
    _assert_same(got, ref)
    assert np.isfinite(ref).any()


def test_packed_constants(grids):
    """Every name packed for the defaults; the pack is the fitter's until a
    prior object or its bounds change."""
    _, tf = _fitters(grids)
    pri = tf._catalog_priors()
    assert pri.on == (True, True, True, True) and list(pri.consts) == list(CONST_NAMES)
    assert [k for k, v in pri.consts.items() if not np.isfinite(v)] == ["ln_hi"]  # the log-normal's (0, inf)
    assert tf._catalog_priors() is pri
    np.testing.assert_array_equal(pri.dist[:, 0].numpy(), tf.max_distance)
    tf.priors["AV"].bounds = (0.0, 0.7)
    again = tf._catalog_priors()
    assert again is not pri and again.consts["av_hi"] == 0.7
    tf.priors["age"] = torch_priors.FlatPrior((8.0, 10.0))
    assert tf._catalog_priors().on == (False, True, True, True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        catalog_lnpost(torch.zeros((S, 2, 5), device="meta"), tf._catalog_likelihood(), tf._catalog_priors())


def test_float32_floors_flush_to_zero():
    """``clamp(pdf, min=1e-300)`` is 0 in float32, so where the [Fe/H]
    mixture underflows its log is -inf, as in the JAX package; in float64 the
    same points stay finite."""
    x = np.array([-12.0, -6.0, -1.0, 0.0, 0.5, np.nan])
    jfeh = jax_priors.FehPrior()
    pri = pack_catalog_priors(dict(age=torch_priors.AgePrior(), feh=torch_priors.FehPrior(),
                                   AV=torch_priors.AVPrior(), mass=torch_priors.ChabrierPrior()), (1, 100),
                              np.zeros(5), torch.ones(2))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        got = _feh_lnpdf(torch.as_tensor(x, dtype=dt), pri.consts).numpy()
        ref = np.asarray(jfeh.lnpdf_jax(jnp.asarray(x, dtype=jdt)))
        assert got.dtype == ref.dtype
        _assert_same(got, ref, atol=1e-10 if dt == torch.float64 else 1e-4)
        assert np.isneginf(got[0]) == (dt == torch.float32)


@pytest.mark.parametrize("n_bands,width", [(0, 4), (1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16), (16, 16),
                                           (17, None)])
def test_compact_bc_table(grids, n_bands, width):
    """The kernel's BC table: the wanted band columns in the likelihood's
    order, zero-padded to the narrowest of 4, 8 or 16 columns; past 16
    bands, and for a column outside the table, a ValueError."""
    _, tiso, df = grids
    tf = BatchStarFitter(tiso, StarCatalog({c: df[c].values for c in df}, bands=BANDS), bands=BANDS)
    lk = tf._catalog_likelihood()
    cols = tuple((lk.band_icols * 6)[:n_bands])
    wide = dataclasses.replace(lk, band_icols=cols)
    if width is None:
        with pytest.raises(ValueError, match="16 bands"):
            compact_bc(wide)
        return
    table = compact_bc(wide)
    assert table.shape == lk.bc.values.shape[:-1] + (width,) and table.is_contiguous()
    np.testing.assert_array_equal(table[..., :n_bands].numpy(), lk.bc.values[..., list(cols)].numpy())
    assert not table[..., n_bands:].any()
    with pytest.raises(ValueError, match="outside the BC table"):
        compact_bc(dataclasses.replace(lk, band_icols=(lk.bc.values.shape[-1],)))
