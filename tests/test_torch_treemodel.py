"""Port parity of the tree model, ``isochrones_torch.treemodel.StarModel``,
against the JAX package on the CPU in float64, small synthetic grid.

Prior, posterior and prior transform agree with the JAX package at rtol 1e-10
on seeded points; tree models of one and two unresolved stars agree with the
port's flat models at atol 1e-8 (the oracle of ``tests/test_observation.py``).
One seeded fit (dynamic by default, as the tree model's fits are) is held to
the JAX fit of the same model at the bars of ``tests/test_sampler_parity.py``:
ln Z within 3 sqrt(logzerr1^2 + logzerr2^2), the 16/50/84% quantiles within
0.35 posterior sigma. The two fits draw other random numbers.
"""

import json
import os
import re

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_tpu.starmodel as jsm
import isochrones_torch.starmodel as tsm
from chip_smoke import tree_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.treemodel import StarModel as JaxStarModel
from isochrones_tpu.treemodel import StarModelGroup as JaxStarModelGroup
from isochrones_torch import BasicStarModel, SingleStarModel, get_ichrone
from isochrones_torch.treemodel import StarModel, StarModelGroup

HERE = os.path.dirname(os.path.abspath(__file__))
DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
CASES = [("star1", {}), ("star3", {}), ("star4", dict(index=[0, 0, 1])), ("star4", dict(index=[0, 1, 1]))]
CASE_IDS = ["star1", "star3", "star4-001", "star4-011"]
TOL_SIGMA = 0.35
QUANTILES = (0.16, 0.50, 0.84)


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _true_star(tic, eep=60.0, bands=("J", "H", "K")):
    Teff, logg, _, mags = tic.interp_mag([eep, 9.0, 0.0, 200.0, 0.1], list(bands))
    return Teff, logg, dict(zip(bands, np.asarray(mags)))


@pytest.mark.parametrize("folder, kw", CASES, ids=CASE_IDS)
def test_prior_posterior_transform_match_jax(ics, folder, kw):
    jic, tic = ics
    path = os.path.join(HERE, folder)
    jm, tm = JaxStarModel.from_ini(jic, path, **kw), StarModel.from_ini(tic, path, **kw)
    assert tm._bounds["AV"] == jm._bounds["AV"]  # the ini's maxAV, where it has one
    u = np.random.default_rng(1).random((384, tm.n_params))
    pt = tm.prior_transform_batch(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(pt, np.asarray(jm.prior_transform_batch(jnp.asarray(u))), rtol=1e-12)
    i = 0
    for s in tm.obs.systems:  # EEPs descend within each system, offsets and all
        n = tm.obs.Nstars[s]
        assert (np.diff(pt[:, i:i + n], axis=1) <= 0).all()
        i += n + 4
    knots = tic.model.knots
    pts = np.concatenate([pt, tree_points(tm.param_names, knots, 128, seed=2),
                          tree_points(tm.param_names, knots, 128, seed=3, narrow=True)])
    for name in ("lnprior_batch", "lnpost_batch"):
        got = getattr(tm, name)(pts).numpy()
        ref = np.asarray(getattr(jm, name)(jnp.asarray(pts)))
        fin = np.isfinite(ref)
        assert np.array_equal(np.isfinite(got), fin), name
        assert fin.sum() > 20 and (~fin).sum() > 20
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10, err_msg=name)
    p = pts[np.isfinite(tm.lnpost_batch(pts).numpy())][0]
    assert tm.lnprior(p) == pytest.approx(jm.lnprior(p), rel=1e-10)
    assert tm.lnpost(p) == pytest.approx(jm.lnpost(p), rel=1e-10)


@pytest.mark.parametrize("props", ["spec_only", "phot_only", "both"])
def test_single_consistency_with_flat_model(ics, props):
    """Tree model of one unresolved star == the flat single model."""
    _, tic = ics
    Teff, logg, mags = _true_star(tic)
    kw = {}
    if props in ("spec_only", "both"):
        kw.update(Teff=(Teff, 100.0), logg=(logg, 0.1))
    if props in ("phot_only", "both"):
        kw.update(J=(mags["J"], 0.02), H=(mags["H"], 0.02))
    kw["parallax"] = (5.0, 0.05)
    tree_mod, flat_mod = StarModel(tic, **kw), SingleStarModel(tic, **kw)
    for k in ["mass", "feh", "age", "distance", "AV", "eep"]:
        flat_mod.set_prior(**{k: tree_mod._priors[k]})
    p = [60.0, 9.0, 0.0, 200.0, 0.1]
    assert np.isclose(tree_mod.lnlike(p), flat_mod.lnlike(p), atol=1e-8)
    assert np.isclose(tree_mod.lnprior(p), flat_mod.lnprior(p), atol=1e-8)
    assert np.isclose(tree_mod.lnpost(p), flat_mod.lnpost(p), atol=1e-8)
    assert np.isfinite(tree_mod.lnpost(p)) and tree_mod.labelstring == "single"


def test_binary_consistency_with_flat_model(ics):
    _, tic = ics
    _, _, mags = _true_star(tic)
    kw = dict(J=(mags["J"], 0.02), H=(mags["H"], 0.02), parallax=(5.0, 0.05))
    tree_mod, flat_mod = StarModel(tic, N=2, **kw), BasicStarModel(tic, N=2, **kw)
    for k in ["mass", "feh", "age", "distance", "AV", "eep"]:
        flat_mod.set_prior(**{k: tree_mod._priors[k]})
    p = [60.0, 50.0, 9.0, 0.0, 200.0, 0.1]
    assert np.isclose(tree_mod.lnlike(p), flat_mod.lnlike(p), atol=1e-8)
    assert np.isclose(tree_mod.lnpost(p), flat_mod.lnpost(p), atol=1e-8)
    assert tree_mod.labelstring == "binary" and tree_mod.mnest_basename.endswith("chains/iso-binary-")
    assert tree_mod.lnpost([50.0, 60.0, 9.0, 0.0, 200.0, 0.1]) == -np.inf  # ascending EEPs


def test_sample_from_prior_and_group(ics):
    jic, tic = ics
    path = os.path.join(HERE, "star4")
    tm = StarModel.from_ini(tic, path, index=[0, 0, 1])
    arr = tm.sample_from_prior(40, values=True, rng=0)
    assert arr.shape == (40, 11) and np.isfinite(tm.lnpost_batch(arr).numpy()).all()
    assert (arr[:, 0] >= arr[:, 1]).all()
    cols = tm.sample_from_prior(5, rng=1)
    assert tuple(cols) == tm.param_names and tm.sample_from_prior(0, values=True).shape == (0, 11)

    for n in (1, 2, 3):
        assert [tuple(map(int, x)) for x in tsm.N_options(n, 1, 2)] == [tuple(map(int, x)) for x in jsm.N_options(n, 1, 2)]
        assert tsm.index_options(n) == jsm.index_options(n)
    base_t = StarModel.from_ini(tic, os.path.join(HERE, "star2"))
    base_j = JaxStarModel.from_ini(jic, os.path.join(HERE, "star2"))
    gt, gj = StarModelGroup(base_t, max_multiples=1, max_stars=2), JaxStarModelGroup(base_j, max_multiples=1, max_stars=2)
    assert [m.labelstring for m in gt.models] == [m.labelstring for m in gj.models]
    assert [m.n_params for m in gt.models] == [m.n_params for m in gj.models]
    assert len(base_t.obs.get_model_nodes()) > 0  # the base model keeps its stars


def test_unported_and_default_device(ics, tmp_path, monkeypatch):
    import isochrones_torch.config as tconfig
    from isochrones_torch.grids.base import MissingGridError

    jic, tic = ics
    tm = StarModel.from_ini(tic, os.path.join(HERE, "star1"))
    # ported with the EEP inversion: mass-based parameters become EEP-based ones
    jm = JaxStarModel.from_ini(jic, os.path.join(HERE, "star1"))
    np.testing.assert_allclose(tm.convert_pars_to_eep([1.0, 9.0, 0.0, 200.0, 0.1]),
                               jm.convert_pars_to_eep([1.0, 9.0, 0.0, 200.0, 0.1]), rtol=0, atol=1e-9)
    # the MIST grids without their files: the error names the missing path
    monkeypatch.setattr(tconfig, "ISOCHRONES", str(tmp_path))
    with pytest.raises(MissingGridError, match=re.escape(str(tmp_path))):
        StarModel.from_ini("mist", os.path.join(HERE, "star1"), device="cpu")
    on_cpu = StarModel.from_ini("synthetic", os.path.join(HERE, "star1"), device="cpu")
    assert on_cpu.device.type == "cpu" and sorted(on_cpu.ic.bands) == sorted(StarModel.get_bands(os.path.join(HERE, "star1", "star.ini")))
    if not torch.cuda.is_available():
        # given a grid name and no device, the model is built on the card
        with pytest.raises((RuntimeError, AssertionError)):
            StarModel.from_ini("synthetic", os.path.join(HERE, "star1"))


def test_config_hash_covers_tree_data(ics):
    """The checkpoint's problem hash changes with the tree's data, which
    lives outside ``self.kwargs`` (``tests/test_checkpoint.py:253``)."""
    _, tic = ics
    t1 = StarModel(tic, Teff=(6000.0, 100.0), J=(7.0, 0.02), parallax=(5.0, 0.05))
    t2 = StarModel(tic, Teff=(5500.0, 100.0), J=(8.3, 0.02), parallax=(2.0, 0.05))
    t1b = StarModel(tic, Teff=(6000.0, 100.0), J=(7.0, 0.02), parallax=(5.0, 0.05))
    assert t1._fit_config_hash(0) != t2._fit_config_hash(0)
    assert t1._fit_config_hash(0) == t1b._fit_config_hash(0)
    assert t1._fit_config_hash(0) != t1._fit_config_hash(1)
    t1b.set_bounds(AV=(0, 0.3))
    assert t1._fit_config_hash(0) != t1b._fit_config_hash(0)
    flat = SingleStarModel(tic, Teff=(6000.0, 100.0), J=(7.0, 0.02))
    assert flat._fit_config_hash(0) != SingleStarModel(tic, Teff=(6000.0, 100.0), J=(7.1, 0.02))._fit_config_hash(0)


@pytest.fixture(scope="module")
def tree_fits(ics):
    """One seeded fit in each package of a single star made from the grid,
    as a tree model (dynamic nested sampling by default), one torch thread."""
    jic, tic = ics
    Teff, logg, mags = _true_star(tic)
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05))
    obs.update({b: (float(m), 0.02) for b, m in mags.items()})
    fit = dict(n_live_points=200, n_batch=16, n_chains=8, seed=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tm = StarModel(tic, **obs)
        tres = tm.fit(**fit)
    finally:
        torch.set_num_threads(threads)
    jm = JaxStarModel(jic, **obs)
    return tm, tres, jm, jm.fit(**fit)


def test_tree_fit_matches_jax(tree_fits):
    tm, tres, jm, jres = tree_fits
    assert not tres.truncated and tres.ess >= 100 and tres.dynamic_rounds == jres.dynamic_rounds >= 0
    assert tm.evidence == (tres.logz, tres.logzerr)
    bar = 3 * np.hypot(tres.logzerr, jres.logzerr)
    assert abs(tres.logz - jres.logz) < bar, (tres.logz, jres.logz, bar)
    assert set(tm.samples) == set(jm.samples.columns)
    for c in tm.param_names:
        ref = np.quantile(jm.samples[c].values, QUANTILES)
        sigma = 0.5 * (ref[2] - ref[0])
        got = np.quantile(tm.samples[c], QUANTILES)
        np.testing.assert_array_less(np.abs(got - ref), TOL_SIGMA * sigma, err_msg=c)
    np.testing.assert_array_equal(tm.map_pars(), [tm.samples[c][np.argmax(tm.samples["lnprob"])] for c in tm.param_names])
    sub = tm.random_samples(7, rng=0)
    assert set(sub) == set(tm.samples) and len(sub["lnprob"]) == 7


def test_tree_derived_samples_and_results_file(tree_fits, tmp_path):
    """Derived samples carry the JAX package's columns; ``save_hdf`` ->
    ``load_hdf`` restores samples, derived samples, bounds (a non-default
    ``maxAV``) and evidence; the file's keys are those of the JAX package's
    HDF5 file, plus the bounds and the evidence, with the same values."""
    tm, _, jm, _ = tree_fits
    assert list(tm.derived_samples) == list(jm.derived_samples.columns)
    assert np.isfinite(tm.derived_samples["J_mag"]).all()
    assert abs(np.median(tm.derived_samples["distance_0"]) - 200.0) < 3 * np.std(tm.derived_samples["distance_0"])
    tm.set_bounds(AV=(0, 0.6))
    path, jpath = str(tmp_path / "tree.h5"), str(tmp_path / "jax_tree.h5")
    tm.save_hdf(path)
    jm.save_hdf(jpath)
    back = StarModel.load_hdf(path, ic=tm.ic)
    for name in ("samples", "derived_samples"):
        a, b = getattr(tm, name), getattr(back, name)
        assert list(a) == list(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])
    assert back.evidence == tm.evidence and back.bounds("AV_0") == (0, 0.6) and back._priors["AV"].bounds == (0, 0.6)
    assert back.param_names == tm.param_names and back.name == (tm.name or "root") and back.use_emcee is False
    assert np.isclose(back.lnpost(tm.map_pars()), tm.lnpost(tm.map_pars()), rtol=1e-12)
    rebuilt = StarModel.load_hdf(path, device="cpu")  # no ic: the synthetic grids with the stored bands
    assert rebuilt.ic.bands == tm.ic.bands and rebuilt.device.type == "cpu"

    def items(p):
        out = {}
        with h5py.File(p, "r") as f:
            f.visititems(lambda name, obj: out.update({name: obj[()] if isinstance(obj, h5py.Dataset) else None,
                                                       **{f"{name}@{k}": v for k, v in obj.attrs.items()}}))
            out.update({f"@{k}": v for k, v in f.attrs.items()})
        return out

    got, ref = items(path), items(jpath)
    assert set(got) - set(ref) == {"@bounds", "@evidence"} and set(ref) <= set(got)
    for g in ("samples", "derived_samples"):
        assert json.loads(got[f"{g}@columns"]) == list(getattr(tm, g))
    np.testing.assert_array_equal(got["obs/values"], ref["obs/values"])
    assert got["obs/values"].dtype == ref["obs/values"].dtype
    for k in ("@ic_type", "@ic_bands", "@use_emcee", "@name", "@directory") + tuple(
            f"obs@{a}" for a in ("spectroscopy", "limits", "parallax", "AV", "N", "index")):
        assert type(got[k]) is type(ref[k]) and got[k] == ref[k], k
    with pytest.raises(IOError):
        StarModel.load_hdf(str(tmp_path / "missing.h5"))
