"""Port parity of the star likelihood: ``isochrones_torch.ops.likelihood``
(the composed path) and ``ops.star.star_lnlike_fused_plain`` (the plain
version of the fused kernel) against the JAX package, float64, on the small
synthetic grid.

Points are adversarial (``chip_smoke.star_points``): exact interior and top
knots, NaN-padded neighbours near each track's end, out-of-bounds and NaN
coordinates, AV past the BC grid, distance <= 0. Observations cover a full
set, a missing spectroscopy channel, zero bands and no parallax. Values agree
within rtol 1e-10 with identical NaN patterns, for N = 1, 2, 3 and for grids
whose axes take every axis-map kind.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import star_grid_variant, star_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.ops.interp import GridData as JaxGridData
from isochrones_tpu.ops.interp import interp_nd as jax_interp_nd
from isochrones_tpu.ops.likelihood import gauss_lnprob as jax_gauss_lnprob
from isochrones_tpu.ops.likelihood import stack_components as jax_stack_components
from isochrones_tpu.ops.likelihood import star_lnlike as jax_star_lnlike
from isochrones_torch import get_ichrone
from isochrones_torch.ops.likelihood import gauss_lnprob, stack_components, star_lnlike
from isochrones_torch.ops.star import StarLikelihood, star_lnlike_fused, star_lnlike_fused_plain

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
_BANDS = ("J", "H", "K", "G")
#: observed Teff, logg, feh and magnitudes near the small grid's EEP-60 star
_SPEC = np.array([6100.0, 4.2, 0.05])
_SPEC_UNC = np.array([100.0, 0.1, 0.1])
_MAGS = np.array([6.1, 5.8, 5.75, 7.2])
_MAG_UNCS = np.array([0.02, 0.02, 0.02, 0.01])
_OBS = {
    "full": dict(spec=_SPEC, bands=_BANDS, parallax=(5.0, 0.05)),
    "missing_logg": dict(spec=np.array([6100.0, np.nan, 0.05]), bands=_BANDS, parallax=(5.0, 0.05)),
    "zero_bands": dict(spec=_SPEC, bands=(), parallax=(5.0, 0.05)),
    "no_parallax": dict(spec=np.array([np.nan, 4.2, np.nan]), bands=_BANDS[:2], parallax=None),
}


@pytest.fixture(scope="module")
def ic():
    return get_ichrone("synthetic", device="cpu", **_DIMS)


def _as_jax(g):
    return JaxGridData(values=jnp.asarray(g.values.numpy()), knots=tuple(jnp.asarray(k.numpy()) for k in g.knots),
                       columns=g.columns, axis_maps=g.axis_maps)


def _assert_same(got, ref, rtol=1e-10):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=0)
    return m


def test_gauss_and_stack_components():
    rng = np.random.default_rng(0)
    val, unc, model = rng.normal(0, 1, 50), rng.uniform(0.01, 1, 50), rng.normal(0, 1, 50)
    _assert_same(gauss_lnprob(torch.as_tensor(val), torch.as_tensor(unc), torch.as_tensor(model)).numpy(),
                 jax_gauss_lnprob(jnp.asarray(val), jnp.asarray(unc), jnp.asarray(model)), rtol=1e-14)
    _assert_same(gauss_lnprob(2.0, 0.5, torch.as_tensor(model)).numpy(), jax_gauss_lnprob(2.0, 0.5, jnp.asarray(model)),
                 rtol=1e-14)
    pars = rng.normal(0, 1, (4, 3, 7))
    np.testing.assert_array_equal(stack_components(torch.as_tensor(pars), 3).numpy(),
                                  np.asarray(jax_stack_components(jnp.asarray(pars), 3)))


def _case(ic, N, kind, obs):
    """The port's StarLikelihood on the grid variant ``kind`` and its JAX
    counterparts (grids, observation arrays)."""
    o = _OBS[obs]
    pack6, bc = star_grid_variant(ic.model_packed6, ic.bc, kind)
    band_icols = tuple(ic.bc.column_index[b] for b in o["bands"])
    nb = len(o["bands"])
    lk = StarLikelihood(n_stars=N, index_order=tuple(ic._param_index_order), pack6=pack6, bc=bc,
                        band_icols=band_icols, spec_vals=o["spec"], spec_uncs=_SPEC_UNC, mag_vals=_MAGS[:nb],
                        mag_uncs=_MAG_UNCS[:nb], parallax=o["parallax"], dist_idx=N + 2)
    return lk, _as_jax(pack6), _as_jax(bc)


@pytest.mark.parametrize("obs", list(_OBS))
@pytest.mark.parametrize("N", [1, 2, 3])
def test_star_lnlike_matches_jax(ic, N, obs):
    """The composed likelihood on the interpolator's own 4-column pack."""
    lk, _, _ = _case(ic, N, "default", obs)
    pts = star_points(ic.model.knots, N, 2048, seed=10 + N)
    args = (tuple(ic._param_index_order),)
    got = star_lnlike(torch.as_tensor(pts), *args, lk.spec_vals, lk.spec_uncs, torch.as_tensor(lk.mag_vals),
                      torch.as_tensor(lk.mag_uncs), ic.model_packed, ic._packed_icols, ic.bc, lk.band_icols,
                      n_stars=N).numpy()
    jic = _JAX_IC()
    ref = jax_star_lnlike(jnp.asarray(pts), *args, jnp.asarray(lk.spec_vals), jnp.asarray(lk.spec_uncs),
                          jnp.asarray(lk.mag_vals), jnp.asarray(lk.mag_uncs), jic.model_packed, jic._packed_icols,
                          jic.bc, lk.band_icols, n_stars=N)
    m = _assert_same(got, ref)
    assert m.sum() > 200 and (~m).sum() > 200


@pytest.mark.parametrize("kind", ["default", "log", "compare", "searchsorted"])
@pytest.mark.parametrize("obs", list(_OBS))
@pytest.mark.parametrize("N", [1, 2, 3])
def test_fused_plain_matches_jax(ic, N, obs, kind):
    """ll against JAX ``star_lnlike`` plus the parallax term, orig_val and
    deriv against JAX ``interp_nd`` of the EEP-prior columns, on grids whose
    axes take every axis-map kind."""
    lk, jpack, jbc = _case(ic, N, kind, obs)
    pts = star_points(lk.pack6.knots, N, 1024, seed=20 + N)
    ll, orig, deriv = (x.numpy() for x in star_lnlike_fused_plain(torch.as_tensor(pts), lk))
    ll_d, orig_d, deriv_d = (x.numpy() for x in star_lnlike_fused(torch.as_tensor(pts), lk))  # CPU: plain
    np.testing.assert_array_equal(ll_d, ll)

    jp = jnp.asarray(pts)
    io = lk.index_order
    ref = jax_star_lnlike(jp, io, jnp.asarray(lk.spec_vals), jnp.asarray(lk.spec_uncs), jnp.asarray(lk.mag_vals),
                          jnp.asarray(lk.mag_uncs), jpack, (0, 1, 2, 3), jbc, lk.band_icols, n_stars=N)
    if lk.parallax is not None:
        ref = ref + jax_gauss_lnprob(lk.parallax[0], lk.parallax[1], 1000.0 / jp[..., N + 2])
    m = _assert_same(ll, ref)
    assert m.sum() > 50 and (~m).sum() > 50

    comp = jax_stack_components(jp, N)
    gp = jnp.stack([comp[..., io[0]], comp[..., io[1]], comp[..., io[2]]], axis=-1)
    vals = np.asarray(jax_interp_nd(jpack.values, jpack.knots, gp, icols=(4, 5), axis_maps=jpack.axis_maps))
    _assert_same(orig, vals[..., 0])
    _assert_same(deriv, vals[..., 1])
    assert orig.shape == deriv.shape == (len(pts), N)


_JAX_ICS = {}


def _JAX_IC():
    if "ic" not in _JAX_ICS:
        _JAX_ICS["ic"] = jax_get_ichrone("synthetic", **_DIMS)
    return _JAX_ICS["ic"]


def test_fused_plain_float32_flushes_like_float64(ic):
    """The float32 plain version on the float32 tables: same NaN pattern as
    float64 on the rounded inputs, values within float32 rounding."""
    lk64, _, _ = _case(ic, 2, "default", "full")
    ic32 = get_ichrone("synthetic", device="cpu", dtype=torch.float32, **_DIMS)
    lk32 = dataclasses.replace(lk64, pack6=ic32.model_packed6, bc=ic32.bc)
    pts = star_points(ic.model.knots, 2, 1024, seed=5).astype(np.float32)
    got = star_lnlike_fused_plain(torch.as_tensor(pts), lk32)[0].numpy()
    ref = star_lnlike_fused_plain(torch.as_tensor(pts, dtype=torch.float64), lk64)[0].numpy()
    assert got.dtype == np.float32
    fin = np.isfinite(ref) & np.isfinite(got)
    assert fin.sum() > 100
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-3, atol=0.5)
