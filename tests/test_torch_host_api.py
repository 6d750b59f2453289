"""Port parity of the rest of the host API against the JAX package, float64.

- ``isochrones_torch.interp``, the reference-signature shims, on the cases
  of ``tests/test_interp_compat.py``: against ``isochrones_tpu.interp`` and
  the loop oracle ``tests/reference_oracle.py`` (index utilities exact,
  values rtol 1e-10 with identical NaN patterns);
- ``ops.cluster``'s ``cluster_lnlike``, ``integrate_over_eeps``,
  ``logaddexp`` and ``logsumexp``, ``ops.mags.interp_mags``,
  ``ops.interp.interp_grid``, ``utils.polyval`` and ``utils.trapz``:
  rtol 1e-12 (1e-10 for the cluster plane), identical NaN and inf patterns;
- ``SyntheticStellarGrids.astype``: the same arrays and dtypes;
- ``BasicStarModel``'s ``prior_transform``, ``mnest_prior``,
  ``mnest_loglike``, ``prior``, ``lnpost_polychord`` and ``maxlike`` from
  the same ``p0``: rtol 1e-10 (``maxlike``'s optimum 1e-8); the fit-state
  accessors raise before a fit, as the JAX ones do;
- ``StarCatalog``: ``df``, ``set_prior``, ``iter_models`` and ``write_ini``,
  whose ``star.ini`` files are byte for byte the JAX ones; ``ds`` and ``hr``
  raise ``ImportError`` without holoviews in both packages;
- the re-export modules hand out the objects of the modules they name.
"""

import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu as jtpu
import isochrones_tpu.samplers  # noqa: F401  (jtpu.samplers)
import isochrones_torch as ttorch
import reference_oracle as oracle
from chip_smoke import make_kernel_inputs
from isochrones_tpu import interp as jcompat
from isochrones_torch import interp as tcompat

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="module")
def ics():
    return ttorch.get_ichrone("synthetic", device="cpu", **_DIMS), jtpu.get_ichrone("synthetic", **_DIMS)


def _same(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isinf(got), np.isinf(ref)) and np.array_equal(got[np.isinf(got)], ref[np.isinf(ref)])
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=0)


# ------------------------------------------------------------ interp shims
def test_searchsorted(rng):
    for _ in range(200):
        arr = np.sort(rng.uniform(0, 1, int(rng.integers(3, 15))))
        x = float(rng.uniform(-0.1, 1.1))
        assert tcompat.searchsorted(arr, x) == jcompat.searchsorted(arr, x) == tuple(oracle.ref_searchsorted(arr, x))
    arr = np.sort(rng.uniform(0, 1, 9))
    for x in arr:
        assert tcompat.searchsorted(arr, float(x)) == tuple(oracle.ref_searchsorted(arr, float(x)))
    assert tcompat.searchsorted(arr, float(arr[5]), N=4) == jcompat.searchsorted(arr, float(arr[5]), N=4)


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_find_indices(rng, nd):
    iis = [np.sort(rng.uniform(0, 1, n)) for n in (6, 8, 5, 7)[:nd]]
    pts = [tuple(float(x) for x in rng.uniform(0, 1, nd)) for _ in range(100)]
    pts += [tuple(float(ii[2]) for ii in iis), (-1.0,) + (0.5,) * (nd - 1), (0.5,) * (nd - 1) + (2.0,)]
    fn = getattr(tcompat, f"find_indices_{nd}d")
    for pt in pts:
        gi, gn, goob = fn(*pt, *iis)
        ri, rn, roob = oracle.ref_find_indices(pt, iis)
        ji, jn, joob = jcompat.find_indices(pt, iis)
        assert goob == roob == joob
        np.testing.assert_array_equal(gi, ji)
        np.testing.assert_array_equal(gn, jn)
        for a, b in zip(tcompat.find_indices(pt, iis), (gi, gn, goob)):
            np.testing.assert_array_equal(a, b)
        if not roob:
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_allclose(gn, rn, rtol=1e-12)


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_interp_values(rng, nd):
    shape = (5, 7, 9, 6)[:nd]
    iis = [np.sort(rng.uniform(0, 1, n)) for n in shape]
    grid = rng.normal(size=shape + (3,))
    grid[(1,) * nd] = np.nan  # a NaN hole
    icols = np.array([0, 2])
    xs = [rng.uniform(-0.05, 1.05, 64) for _ in range(nd)]
    got = getattr(tcompat, f"interp_values_{nd}d")(*xs, grid, icols, *iis, device="cpu")
    _same(got, oracle.ref_interp_values(np.stack(xs, axis=-1), grid, icols, iis), rtol=1e-10)
    _same(got, getattr(jcompat, f"interp_values_{nd}d")(*xs, grid, icols, *iis))
    one = getattr(tcompat, f"interp_value_{nd}d")(*[float(x[0]) for x in xs], grid, icols, *iis, device="cpu")
    _same(one, got[0])


def test_interp_values_true_broadcast(rng):
    ii0, ii1 = np.sort(rng.uniform(0, 1, 5)), np.sort(rng.uniform(0, 1, 7))
    grid = rng.normal(size=(5, 7, 2))
    x0, x1 = rng.uniform(0.1, 0.9, (3, 1)), rng.uniform(0.1, 0.9, (1, 4))
    got = tcompat.interp_values_2d(x0, x1, grid, np.array([1]), ii0, ii1, device="cpu")
    _same(got, jcompat.interp_values_2d(x0, x1, grid, np.array([1]), ii0, ii1))
    x0f, x1f = np.broadcast_arrays(x0, x1)
    _same(got, tcompat.interp_values_2d(x0f.ravel(), x1f.ravel(), grid, np.array([1]), ii0, ii1, device="cpu"))


def test_interp_eeps(rng):
    n0, n1, ne = 4, 6, 20
    ii0, ii1 = np.sort(rng.uniform(-1, 1, n0)), np.sort(rng.uniform(0.2, 3, n1))
    lengths = rng.integers(8, ne + 1, n0 * n1)
    arrays = np.full((n0 * n1, ne), np.inf)
    for i in range(n0 * n1):
        arrays[i, : lengths[i]] = np.sort(rng.uniform(6, 10, lengths[i]))
    weights = rng.uniform(0.1, 1, (n0 * n1, ne))
    xs, x0s, x1s = rng.uniform(6, 10, 300), rng.uniform(-1, 1, 300), rng.uniform(0.2, 3, 300)
    args = (ii0, ii1, n1, arrays, weights, lengths)
    got = tcompat.interp_eeps(xs, x0s, x1s, *args, device="cpu")
    _same(got, oracle.ref_interp_eeps(xs, x0s, x1s, *args), rtol=1e-10)
    _same(got, jcompat.interp_eeps(xs, x0s, x1s, *args))
    one = tcompat.interp_eep(float(xs[0]), float(x0s[0]), float(x1s[0]), *args, device="cpu")
    assert one == pytest.approx(float(got[0]), rel=1e-12, nan_ok=True)


def test_find_closest3():
    ii0, ii1, ii2 = np.linspace(0, 1, 4), np.linspace(0, 1, 5), np.linspace(0, 10, 30)
    grid = np.zeros((4, 5, 30, 2))
    grid[..., 0] = ii2[None, None, :] * 2.0 + 1.0
    grid[..., 1] = np.sin(ii2)[None, None, :] + ii0[:, None, None]
    for val, icol in ((6.3 * 2.0 + 1.0, 0), (13.0, 0), (0.9, 1), (40.0, 0)):
        got = tcompat.find_closest3(val, 0.0, 10.0, 0.5, 0.5, grid, icol, ii0, ii1, ii2, device="cpu")
        ref = jcompat.find_closest3(val, 0.0, 10.0, 0.5, 0.5, grid, icol, ii0, ii1, ii2)
        assert got == pytest.approx(ref, rel=1e-12, nan_ok=True)
    assert abs(tcompat.find_closest3(13.6, 0.0, 10.0, 0.5, 0.5, grid, 0, ii0, ii1, ii2, device="cpu") - 6.3) < 0.02


def test_dfinterpolator_and_sign(rng):
    from isochrones_torch.grids.base import Index, Table

    a, b = np.repeat(np.arange(3.0), 4), np.tile(np.arange(4.0), 3)
    cols = {"x": rng.normal(size=12), "y": rng.normal(size=12)}
    tab = Table(cols, Index(["a", "b"], [a, b]))
    df = pd.DataFrame(cols, index=pd.MultiIndex.from_arrays([a, b], names=["a", "b"]))
    t, j = tcompat.DFInterpolator(tab, device="cpu"), jcompat.DFInterpolator(df)
    assert tcompat.DFInterpolator is ttorch.GridInterpolator and t.columns == j.columns == ["x", "y"]
    pts = [rng.uniform(-0.2, 2.2, 50), rng.uniform(-0.2, 3.2, 50)]
    _same(t(pts, ["x"]), j(pts, ["x"]))
    _same(t([1.5, 2.5]), j([1.5, 2.5]))
    assert [tcompat.sign(x) for x in (-3.0, 2.0, 0.0)] == [jcompat.sign(x) for x in (-3.0, 2.0, 0.0)] == [-1, 1, 1]


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("S", [2, 4])
def test_cluster_grid_path(S):
    from isochrones_tpu.ops import cluster as jcl
    from isochrones_torch.ops import cluster as tcl

    inp = make_kernel_inputs(S, 30, 3, 1, seed=S)
    one = {k: (v[0] if isinstance(v, np.ndarray) and v.ndim > 0 and k not in ("eeps", "mag_values", "mag_uncs")
               else v) for k, v in inp.items()}
    names = ("lnlike_prop", "model_mags", "masses", "ln_dm_deeps", "eeps", "mag_values", "mag_uncs")
    scal = [float(one[k]) for k in ("alpha", "gamma", "fB", "mass_lo", "mass_hi", "q_lo")]
    t = tcl.cluster_lnlike(*[torch.as_tensor(one[k]) for k in names], *scal, valid=torch.as_tensor(one["valid"]))
    j = jcl.cluster_lnlike(*[jnp.asarray(one[k]) for k in names], *scal, valid=jnp.asarray(one["valid"]))
    _same(t.numpy(), np.asarray(j), rtol=1e-10)
    assert np.isfinite(float(t)) == (S == 2)
    grid = np.array(jcl.calc_lnlike_grid(*[jnp.asarray(one[k]) for k in names if k != "eeps"], *scal,
                                           valid=jnp.asarray(one["valid"])))
    _same(tcl.integrate_over_eeps(torch.as_tensor(grid), torch.as_tensor(one["eeps"])).numpy(),
          np.asarray(jcl.integrate_over_eeps(jnp.asarray(grid), jnp.asarray(one["eeps"]))), rtol=1e-10)


def test_logaddexp_logsumexp(rng):
    from isochrones_tpu.ops import cluster as jcl
    from isochrones_torch.ops import cluster as tcl

    a, b = rng.normal(0, 30, (4, 9)), rng.normal(0, 30, (4, 9))
    a[0, :3], b[0, 1:4] = -np.inf, -np.inf
    a[1, 0] = np.nan
    _same(tcl.logaddexp(torch.as_tensor(a), torch.as_tensor(b)).numpy(), np.asarray(jcl.logaddexp(a, b)))
    for axis, keep in ((None, False), (1, False), (0, True), ((0, 1), False)):
        _same(tcl.logsumexp(a[2:], axis=axis, keepdims=keep).numpy(),
              np.asarray(jcl.logsumexp(a[2:], axis=axis, keepdims=keep)))
    _same(tcl.logsumexp(a[:1], axis=1).numpy(), np.asarray(jcl.logsumexp(a[:1], axis=1)))


def test_interp_mags_and_interp_grid(ics, rng):
    from isochrones_tpu.ops import interp_grid as j_interp_grid
    from isochrones_tpu.ops import interp_mags as j_interp_mags
    from isochrones_torch.ops import interp_grid, interp_mags

    tic, jic = ics
    pars = np.stack([rng.uniform(0, 110, 200), rng.uniform(6, 10.3, 200), rng.uniform(-2.2, 0.6, 200),
                     rng.uniform(10, 2000, 200), rng.uniform(0, 1, 200)], axis=-1)
    pars[:5, 0] = [1.0, 100.0, np.nan, 50.0, 50.0]
    bc_t, bc_j = tuple(tic.bc.column_index[b] for b in "JHK"), tuple(jic.bc.column_index[b] for b in "JHK")
    got = interp_mags(torch.as_tensor(pars), tic._param_index_order, tic.model_packed, tic._packed_icols, tic.bc,
                      bc_t)
    ref = j_interp_mags(jnp.asarray(pars), jic._param_index_order, jic.model_packed, jic._packed_icols, jic.bc, bc_j)
    for g, r in zip(got, ref):
        _same(g.numpy(), np.asarray(r))
    pts = pars[:, [1, 2, 0]]
    for cols in (None, ["Teff", "logg"], [3]):
        _same(interp_grid(tic.model, torch.as_tensor(pts), cols).numpy(),
              np.asarray(j_interp_grid(jic.model, jnp.asarray(pts), cols)))
    from isochrones_tpu.ops.interp import REFERENCE_DEVIATIONS as JDEV
    from isochrones_torch.ops.interp import REFERENCE_DEVIATIONS

    assert REFERENCE_DEVIATIONS == JDEV


def test_polyval_trapz(rng):
    from isochrones_tpu import utils as ju
    from isochrones_torch import utils as tu

    p, x = rng.normal(size=5), rng.normal(size=(3, 7))
    _same(tu.polyval(p, x).numpy(), np.asarray(ju.polyval(p, x)))
    _same(tu.polyval(torch.as_tensor(p), torch.as_tensor(x)).numpy(), oracle.ref_polyval(p, x), rtol=1e-12)
    y, xs = rng.normal(size=(4, 11)), np.sort(rng.uniform(0, 3, 11))
    _same(tu.trapz(y, xs).numpy(), np.asarray(ju.trapz(y, xs)))
    _same(tu.trapz(y[0], xs).numpy(), oracle.ref_trapz(y[0], xs), rtol=1e-12)


def test_synthetic_grids_astype():
    from isochrones_tpu.grids import make_synthetic_grids as jmake
    from isochrones_torch.grids import make_synthetic_grids as tmake

    dims = dict(n_feh=4, n_mass=10, n_eep=30, n_age=8)
    t = tmake(device="cpu", **dims).astype(torch.float32)
    j = jmake(**dims).astype(np.float32)
    for name in ("age_arrays", "dt_deep_arrays", "fehs", "masses", "eeps", "ages", "lengths"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    for name in ("track", "iso", "bc"):
        g, r = getattr(t, name), getattr(j, name)
        assert g.values.dtype == torch.float32 and all(k.dtype == torch.float32 for k in g.knots)
        np.testing.assert_array_equal(g.values.numpy(), np.asarray(r.values))


# ---------------------------------------------------------- star models
@pytest.fixture(scope="module")
def star_models(ics):
    from isochrones_tpu.starmodel import SingleStarModel as JaxSingle
    from isochrones_torch.starmodel import SingleStarModel

    tic, jic = ics
    Teff, logg, _, mags = jic.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05))
    obs.update({b: (float(m), 0.02) for b, m in zip("JHK", np.asarray(mags))})
    return SingleStarModel(tic, **obs), JaxSingle(jic, **obs)


def test_star_model_host_api(star_models, rng):
    tm, jm = star_models
    for u in rng.random((5, 5)):
        _same(tm.prior_transform(u), np.asarray(jm.prior_transform(u)))
        tc, jc = list(u), list(u)
        assert tm.mnest_prior(tc) is tc
        _same(tc, jm.mnest_prior(jc))
        _same(tm.mnest_loglike(tc), jm.mnest_loglike(jc), rtol=1e-10)
        lp, derived = tm.lnpost_polychord(tc)
        assert derived == [] and lp == pytest.approx(jm.lnpost_polychord(jc)[0], rel=1e-10, nan_ok=True)
    for prop, val, kw in (("mass", 1.1, {}), ("AV", 0.3, {}), ("feh", -0.2, {}), ("distance", 150.0, {}),
                          ("eep", 61.0, dict(age=9.0, feh=0.0))):
        assert float(tm.prior(prop, val, **kw)) == pytest.approx(float(jm.prior(prop, val, **kw)), rel=1e-10)
    p0 = [58.0, 8.95, 0.05, 210.0, 0.12]
    opts = dict(options=dict(maxiter=150))
    _same(tm.maxlike(p0, **opts), jm.maxlike(p0, **opts), rtol=1e-8)


def test_fit_state_accessors(star_models, caplog):
    tm, jm = star_models
    for m in (tm, jm):
        with pytest.raises(ValueError):
            m.mnest_analyzer
        with pytest.raises(AttributeError):
            m.sampler
    with caplog.at_level(logging.WARNING, logger="isochrones_torch"):
        s = tm.fit_mcmc_old(nwalkers=16, nburn=4, niter=4, seed=1)
    assert "fit_mcmc_old is deprecated" in caplog.text
    assert len(s["lnprob"]) == 64 and tm.sampler is tm.sampler_state


# -------------------------------------------------------------- catalogs
def _catalog_columns(jic, n, seed=0):
    rng = np.random.default_rng(seed)
    Teff, logg, _, mags = jic.interp_mag([rng.uniform(40, 80, n), rng.uniform(8.5, 9.5, n),
                                          rng.uniform(-0.3, 0.2, n), rng.uniform(100, 400, n),
                                          rng.uniform(0, 0.3, n)], ["J", "H", "K"])
    mags = np.asarray(mags)
    cols = {f"{b}_mag": np.round(mags[:, i], 4) for i, b in enumerate("JHK")}
    cols.update({f"{b}_mag_unc": np.full(n, 0.02) for b in "JHK"})
    cols.update(Teff=np.round(np.asarray(Teff), 1), Teff_unc=np.full(n, 100.0),
                parallax=np.round(rng.uniform(2.5, 10.0, n), 3), parallax_unc=np.full(n, 0.05))
    return cols


def test_star_catalog(ics, tmp_path, monkeypatch):
    from isochrones_tpu.catalog import StarCatalog as JaxCatalog
    from isochrones_tpu.priors import FehPrior as JaxFeh
    from isochrones_torch.catalog import StarCatalog
    from isochrones_torch.priors import FehPrior

    tic, jic = ics
    n = 100  # two digits: write_ini nests the folders by the name's first digit
    cols = _catalog_columns(jic, n)
    tc, jc = StarCatalog(dict(cols)), JaxCatalog(pd.DataFrame(cols))
    assert tc.df is tc.data and list(tc.df) == list(jc.df.columns)
    tc.set_prior(feh=FehPrior(halo_fraction=0.5))
    jc.set_prior(feh=JaxFeh(halo_fraction=0.5))
    p = np.array([[60.0, 9.0, 0.0, 200.0, 0.1], [55.0, 9.2, -0.6, 150.0, 0.2]])
    count = 0
    for tm, jm in zip(tc.iter_models(tic), jc.iter_models(jic)):
        assert tm.name == str(jm.name) and tm.kwargs == jm.kwargs
        assert type(tm._priors["feh"]).__name__ == "FehPrior" and tm._priors["feh"].halo_fraction == 0.5
        if count < 2:  # each JAX model compiles its own posterior
            _same(tm.lnprior_batch(p).numpy(), np.asarray(jm.lnprior_batch(jnp.asarray(p))), rtol=1e-10)
        count += 1
    assert count == n
    binaries = list(tc.iter_models(tic, N=2))
    assert len(binaries) == n and binaries[3].N == 2
    tdirs = tc.write_ini(tic, root=str(tmp_path / "torch"))
    jdirs = jc.write_ini(jic, root=str(tmp_path / "jax"))
    assert [os.path.relpath(d, str(tmp_path / "torch")) for d in tdirs] == \
        [os.path.relpath(d, str(tmp_path / "jax")) for d in jdirs]
    assert os.path.relpath(tdirs[42], str(tmp_path / "torch")) == os.path.join("4", "42")
    for a, b in zip(tdirs, jdirs):
        with open(os.path.join(a, "star.ini"), "rb") as f, open(os.path.join(b, "star.ini"), "rb") as g:
            assert f.read() == g.read()
    tc.df = {k: v[:10] for k, v in cols.items()}
    assert len(tc) == 10 and len(tc.write_ini(tic, root=str(tmp_path / "flat"), nest_directories=False)) == 10
    monkeypatch.setitem(sys.modules, "holoviews", None)  # as where holoviews is not installed
    for cat in (tc, jc):
        for attr in ("ds", "hr"):
            with pytest.raises(ImportError):
                getattr(cat, attr)


# ---------------------------------------------------- re-export modules
def test_reexport_modules():
    import isochrones_torch.bc as bc
    import isochrones_torch.cluster_utils as cu
    import isochrones_torch.eep as eep
    import isochrones_torch.eep_fit as eep_fit
    import isochrones_torch.grid as grid
    import isochrones_torch.likelihood as lk
    import isochrones_torch.mags as mags
    import isochrones_torch.version as version
    from isochrones_torch import ops, samplers
    from isochrones_torch.grids import base
    from isochrones_torch.samplers import ensemble, nested

    assert version.__version__ == ttorch.__version__ == jtpu.__version__
    assert bc.BolometricCorrectionGrid is base.BolometricCorrectionGrid and grid.Grid is base.Grid
    assert all(getattr(eep, n) is getattr(eep_fit, n) for n in eep.__all__)
    assert lk.LOG_ONE_OVER_ROOT_2PI == ops.LOG_ONE_OVER_ROOT_2PI == jtpu.ops.LOG_ONE_OVER_ROOT_2PI
    assert lk.star_lnlike is ops.star_lnlike and mags.interp_mags is ops.interp_mags is ops.interp_mag
    assert cu.integrate_over_eeps is ops.integrate_over_eeps and cu.logsumexp is ops.cluster.logsumexp
    assert samplers.run_ensemble_batch is ensemble.run_ensemble_batch and samplers.run_nested is nested.run_nested
    assert set(samplers.NestedResult._fields) == set(jtpu.samplers.NestedResult._fields)
    assert issubclass(samplers.CheckpointConfigError, ValueError)
