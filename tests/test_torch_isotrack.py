"""Port parity of the joint isochrone + track model,
``isochrones_torch.starmodel.IsoTrackModel``, against the JAX package,
float64, on two grid pairs: the small synthetic pair (n_feh=5, n_mass=20,
n_eep=60, n_age=20) and ``get_ichrone("mist")`` on the MIST-format files of
``tests/mist_fixtures.py``.

- layout (parameter names, bounds, ``ic``/``iso``/``track``, the EEP prior
  on the track grid, the prior transform): exact;
- ``lnlike_batch``, ``lnprior_batch`` and ``lnpost_batch`` with parallax,
  without it and with a NaN spectroscopy channel, at 480 seeded points
  (inside the box, on knots, past either grid, past the bounds, NaN):
  rtol 1e-10 with identical NaN and -inf patterns;
- the fused posterior (two calls of the fused star likelihood) against the
  composed one: rtol 1e-10, identical patterns; with a prior of a
  subclass's own or an EEP prior on another grid object, the same two
  calls and the JAX posterior with that prior; a grid without the 6-column
  pack takes the composed path on the CPU;
- the fits: ``tests/test_torch_isotrack_fit.py``;
- a ``SingleStarModel`` on an evolution-track grid saved and reloaded in
  both packages under an empty ``$ISOCHRONES``: back on the synthetic track
  grid, with its samples.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.config as jconfig
import isochrones_tpu.grids.mist as jmist
import isochrones_torch.config as tconfig
import isochrones_torch.grids.mist as tmist
from chip_smoke import isotrack_points, isotrack_reference
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu import starmodel as jsm
from isochrones_torch import get_ichrone
from isochrones_torch import isochrone as tiso_mod
from isochrones_torch import starmodel as tsm
from mist_fixtures import make_full_mist_fixture

_DIMS = dict(n_feh=5, n_mass=20, n_eep=60, n_age=20)
_BANDS = ["J", "H", "K", "G"]
#: (eep, age, feh, distance, AV) of the observed star on each grid pair
_TRUTH = {"synthetic": [30.0, 9.0, 0.0, 200.0, 0.1], "mist": [40.0, 8.5, -0.1, 200.0, 0.1]}
_MIST_EEP = 60


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mist_root(tmp_path_factory):
    """A MIST-format tree, both packages pointed at it and at its [Fe/H]s and
    track length (as ``tests/test_torch_mist.py`` does)."""
    root = str(tmp_path_factory.mktemp("isochrones_data"))
    make_full_mist_fixture(root)
    with pytest.MonkeyPatch.context() as mp:
        for config, mod in ((jconfig, jmist), (tconfig, tmist)):
            mp.setattr(config, "ISOCHRONES", root)
            mp.setattr(mod.MISTModelGrid, "max_eep", lambda self, m, feh: _MIST_EEP)
            mp.setattr(mod.MISTModelGrid, "fehs", np.array([-0.5, 0.0]))
            mp.setattr(mod.MISTModelGrid, "n_eep", _MIST_EEP)
        yield root


@pytest.fixture(scope="module")
def pairs(request):
    """name -> (port iso, port track, JAX iso, JAX track)."""
    out = {"synthetic": (get_ichrone("synthetic", device="cpu", **_DIMS),
                         get_ichrone("synthetic", tracks=True, device="cpu", **_DIMS),
                         jax_get_ichrone("synthetic", **_DIMS), jax_get_ichrone("synthetic", tracks=True, **_DIMS))}
    request.getfixturevalue("mist_root")
    bands = _BANDS + ["W1"]
    out["mist"] = (get_ichrone("mist", bands=bands, device="cpu"),
                   get_ichrone("mist", bands=bands, tracks=True, device="cpu"),
                   jax_get_ichrone("mist", bands=bands), jax_get_ichrone("mist", bands=bands, tracks=True))
    return out


def _observations(jiso, grid, kind="parallax"):
    truth = _TRUTH[grid]
    Teff, logg, _, mags = jiso.interp_mag(truth, _BANDS)
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1))
    obs.update({b: (float(m), 0.02) for b, m in zip(_BANDS, np.asarray(mags))})
    if kind != "no_parallax":
        obs["parallax"] = (1000.0 / truth[3], 0.05)
    if kind == "nan_channel":
        obs["feh"] = (np.nan, 0.1)  # dropped: the [Fe/H] channel stays NaN
        obs["logg"] = (float(logg), np.nan)
    return obs


def _models(pairs, grid, kind="parallax", cls=None):
    ti, tt, ji, jt = pairs[grid]
    obs = _observations(ji, grid, kind)
    return (cls or tsm.IsoTrackModel)(ti, tt, **obs), jsm.IsoTrackModel(ji, jt, **obs)


class _OwnPrior(tsm.IsoTrackModel):
    """A prior of a subclass's own (the same one): the posterior then adds it
    to the two fused likelihoods."""

    def _build_lnprior_batch(self):
        return super()._build_lnprior_batch()


def _points(tm, seed=0):
    """``chip_smoke.isotrack_points``: inside the box, on knots, past either
    grid, past the bounds, NaN."""
    return isotrack_points(tm, 480, seed=seed)


def _assert_same(got, ref, rtol=1e-10):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.array_equal(np.isposinf(got), np.isposinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=0)
    return m


@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_layout_matches_jax(pairs, grid):
    tm, jm = _models(pairs, grid)
    ti, tt = pairs[grid][:2]
    assert tm.param_names == tuple(jm.param_names) == ("eep", "mass", "age", "feh", "distance", "AV")
    assert tm.ic is tt and tm.track is tt and tm.iso is ti
    assert list(tm.bands) == list(jm.bands) == _BANDS
    assert tm._priors["eep"].ic is tt and tm._priors["eep"].orig_prior is tm._priors["age"]
    for p in tm.param_names:
        assert tuple(float(x) for x in tm.bounds(p)) == tuple(float(x) for x in jm.bounds(p)), p
    for g, r in zip(tm._bounds_arrays(), jm._bounds_arrays()):
        np.testing.assert_array_equal(g, r)
    u = np.random.default_rng(1).random((64, 6))
    np.testing.assert_array_equal(tm.prior_transform_batch(torch.as_tensor(u)).numpy(),
                                  np.asarray(jm.prior_transform_batch(jnp.asarray(u))))


@pytest.mark.parametrize("kind", ["parallax", "no_parallax", "nan_channel"])
@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_batches_match_jax(pairs, grid, kind):
    tm, jm = _models(pairs, grid, kind)
    assert tm._build_lnpost_fused() is not None
    p = _points(tm, seed=len(kind))
    for name in ("lnlike_batch", "lnprior_batch", "lnpost_batch"):
        m = _assert_same(getattr(tm, name)(p).numpy(), getattr(jm, name)(jnp.asarray(p)))
        assert m.sum() > 30 and (~m).sum() > 30, name
    lp = tm.lnpost_batch(p).numpy()
    i = int(np.argmax(lp))
    assert tm.lnpost(p[i]) == pytest.approx(float(lp[i]), rel=1e-12)


def _count_fused(monkeypatch):
    """Record (index order, parallax, shape) of each fused-likelihood call."""
    calls = []
    real = tsm.star_lnlike_fused

    def counted(pars, lk):
        calls.append((tuple(lk.index_order), lk.parallax is not None, tuple(pars.shape)))
        return real(pars, lk)

    monkeypatch.setattr(tsm, "star_lnlike_fused", counted)
    return calls


@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_fused_matches_composed(pairs, grid, monkeypatch):
    """The fused posterior: two calls of the fused star likelihood, the
    iso's without the parallax and the track's with it (the distance the
    fourth of each call's five columns); the same values as the composed
    posterior (``chip_smoke.isotrack_reference``)."""
    tm, _ = _models(pairs, grid)
    lk_iso, lk_track = tm._star_likelihoods()
    assert lk_iso.dist_idx == tm._ISO_COLUMNS.index(4) == 3 and lk_track.dist_idx == tm._TRACK_COLUMNS.index(4) == 3
    p = _points(tm, seed=7)
    ref = isotrack_reference(tm, torch.as_tensor(p)).numpy()
    calls = _count_fused(monkeypatch)
    m = _assert_same(tm.lnpost_batch(p).numpy(), ref)
    assert m.sum() > 30
    assert calls == [((1, 2, 0, 3, 4), False, (len(p), 5)), ((2, 0, 1, 3, 4), True, (len(p), 5))]


@pytest.mark.parametrize("prior", ["subclass", "eep_on_another_grid"])
@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_other_prior_keeps_the_fused_likelihood(pairs, grid, prior, monkeypatch):
    """A prior of a subclass's own, or an EEP prior on another grid object
    than the track: ``lnpost_batch`` still takes both likelihoods from the
    two fused calls and adds that prior; the JAX model's ``lnpost_batch``
    with the same prior, rtol 1e-10, identical NaN and -inf patterns."""
    from isochrones_tpu.priors import EEP_prior as JEEP_prior
    from isochrones_torch.priors import EEP_prior

    tm, jm = _models(pairs, grid, cls=_OwnPrior if prior == "subclass" else None)
    if prior == "eep_on_another_grid":
        tm.set_prior(eep=EEP_prior(copy.copy(tm.track), tm._priors["age"], bounds=tm.eep_bounds))
        jm.set_prior(eep=JEEP_prior(copy.copy(jm.track), jm._priors["age"], bounds=jm.eep_bounds))
    p = _points(tm, seed=11)
    calls = _count_fused(monkeypatch)
    m = _assert_same(tm.lnpost_batch(p).numpy(), jm.lnpost_batch(jnp.asarray(p)))
    assert m.sum() > 30
    assert [c[:2] for c in calls] == [((1, 2, 0, 3, 4), False), ((2, 0, 1, 3, 4), True)]


def test_grid_without_pack6_takes_the_composed_path_on_cpu(pairs):
    """On the CPU a grid without the 6-column pack takes the composed path
    (both plain); the same values."""
    tm, jm = _models(pairs, "synthetic")
    track = copy.copy(tm.track)
    track.model_packed6 = None
    tn = tsm.IsoTrackModel(tm.iso, track, **tm.kwargs)
    assert tn._build_lnpost_fused() is None
    p = _points(tm, seed=3)
    _assert_same(tn.lnpost_batch(p).numpy(), jm.lnpost_batch(jnp.asarray(p)))


def test_track_grid_results_file_reloads(tmp_path, monkeypatch):
    """A ``SingleStarModel`` on an evolution-track grid: saved with samples
    and reloaded in each package with no interpolator given and nothing
    under ``$ISOCHRONES``, it comes back on the synthetic track grid."""
    empty = str(tmp_path / "no_isochrones")
    os.makedirs(empty)
    for config in (jconfig, tconfig):
        monkeypatch.setattr(config, "ISOCHRONES", empty)
        monkeypatch.setattr(config, "OFFLINE", True)
    monkeypatch.setattr(tiso_mod, "_mist_cache", {})
    tt = get_ichrone("synthetic", tracks=True, device="cpu")
    jt = jax_get_ichrone("synthetic", tracks=True)
    obs = dict(Teff=(5700.0, 100.0), J=(8.5, 0.02), H=(8.2, 0.02), K=(8.1, 0.02), parallax=(5.0, 0.05))
    rng = np.random.default_rng(3)
    n = 64
    draws = {"mass": rng.uniform(0.9, 1.1, n), "eep": rng.uniform(60, 90, n), "feh": rng.uniform(-0.2, 0.2, n),
             "distance": rng.uniform(180, 220, n), "AV": rng.uniform(0.0, 0.2, n), "lnprob": rng.normal(size=n)}
    tm = tsm.SingleStarModel(tt, name="star", **obs)
    jm = jsm.SingleStarModel(jt, name="star", **obs)
    tm._samples, jm._samples = dict(draws), pd.DataFrame(draws)
    tm._evidence = jm._evidence = (-12.5, 0.3)
    tfile, jfile = str(tmp_path / "track.h5"), str(tmp_path / "jax_track.h5")
    tm.save_hdf(tfile)
    jm.save_hdf(jfile)
    tback = tsm.SingleStarModel.load_hdf(tfile, device="cpu")
    jback = jsm.SingleStarModel.load_hdf(jfile)
    for back, ic in ((tback, tt), (jback, jt)):
        assert type(back.ic).__name__ == "EvolutionTrackInterpolator"
        assert tuple(back.param_names) == ("mass", "eep", "feh", "distance", "AV")
        assert back.ic.model.values.shape == ic.model.values.shape
        assert back.evidence == (-12.5, 0.3) and back.name == "star"
    assert tback.ic.device.type == "cpu" and list(tback.ic.bands) == list(tt.bands)
    for c in draws:
        np.testing.assert_array_equal(tback.samples[c], jback.samples[c].values)
    for c in ("Teff", "radius", "J_mag", "parallax"):
        np.testing.assert_allclose(tback.derived_samples[c], jback.derived_samples[c].values, rtol=1e-10)
    p = np.array([[1.0, 75.0, 0.0, 200.0, 0.1], [0.95, 65.0, 0.1, 190.0, 0.05]])
    np.testing.assert_allclose(tback.lnpost_batch(p).numpy(), np.asarray(jback.lnpost_batch(p)), rtol=1e-10)
