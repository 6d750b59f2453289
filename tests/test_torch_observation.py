"""Port parity of the observation tree, ``isochrones_torch.observation`` and
``isochrones_torch.ops.tree``, against the JAX package on the CPU in float64.

The host side (ini parsing, tree building, ``compile_plan``) is the JAX
package's code on numpy, so it must agree exactly: integers equal, floats
``array_equal``. The tree likelihood's plain version is held to the JAX
``lnlike_batch`` of the same plan on seeded points (knots, top knots, one
star off the grid, NaN) at rtol 1e-10 with identical -inf patterns, and to the
port's own host per-node walk at atol 1e-8 (the bar of
``tests/test_observation.py``). The small grid is that file's
(``n_feh=7, n_mass=30, n_eep=100, n_age=30``).
"""

import contextlib
import dataclasses
import io
import json
import os
import re

import h5py
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.iniparse as jini
import isochrones_tpu.observation as jobs
import isochrones_torch.iniparse as tini
import isochrones_torch.observation as tobs
from chip_smoke import tree_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.treemodel import StarModel as JaxStarModel
from isochrones_tpu.treemodel import ini_photometry_rows as jax_rows
from isochrones_torch import get_ichrone
from isochrones_torch.convert import plan_from_reference
from isochrones_torch.ops.tree import TreeLikelihood, tree_lnlike, tree_lnlike_plain
from isochrones_torch.treemodel import StarModel, ini_photometry_rows

HERE = os.path.dirname(os.path.abspath(__file__))
DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
STARS = ("star1", "star2", "star3", "star4")
#: (folder, keywords of from_ini): every fixture, and star4 as two systems
CASES = [("star1", {}), ("star2", {}), ("star3", {}), ("star4", {}), ("star4", dict(index=[0, 0, 1])),
         ("star4", dict(index=[0, 1, 1]))]
CASE_IDS = ["star1", "star2", "star3", "star4", "star4-001", "star4-011"]


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _models(ics, folder, kw):
    jic, tic = ics
    path = os.path.join(HERE, folder)
    return JaxStarModel.from_ini(jic, path, **kw), StarModel.from_ini(tic, path, **kw)


def _points(tm, n=320, seed=0):
    """Seeded points: half over the grid's whole box with the adversarial
    blocks of ``tree_points``, half in the narrow box where most are finite."""
    knots = tm.ic.model.knots
    pts = tree_points(tm.param_names, knots, n, seed=seed)
    pts[n // 2:] = tree_points(tm.param_names, knots, n - n // 2, seed=seed + 1, narrow=True)
    return pts


# ------------------------------------------------------------------ ini files
@pytest.mark.parametrize("star", STARS)
def test_ini_parsing_matches_jax(star):
    path = os.path.join(HERE, star, "star.ini")
    got, ref = tini.parse_ini(path), jini.parse_ini(path)
    assert got == ref and list(got) == list(ref)
    assert [type(v).__name__ for v in got.values()] == [type(v).__name__ for v in ref.values()]
    assert sorted(StarModel.get_bands(path)) == sorted(JaxStarModel.get_bands(path))
    scal_t, scal_j = {}, {}
    assert ini_photometry_rows(got, scal_t) == jax_rows(ref, scal_j)
    assert scal_t == scal_j
    for raw in ("5800, 110", "0.9", "True", ["1", "x"]):
        v = tini._split_value(raw) if isinstance(raw, str) else raw
        assert tini.parse_value(v) == jini.parse_value(v)


# -------------------------------------------------------------- tree building
@pytest.mark.parametrize("folder, kw", CASES, ids=CASE_IDS)
def test_compile_plan_matches_jax(ics, folder, kw):
    jm, tm = _models(ics, folder, kw)
    jp, tp = jm.obs.plan(ics[0]), tm.obs.plan(ics[1])
    for f in dataclasses.fields(tp):
        if f.name == "ic":
            continue
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tm.obs.systems == jm.obs.systems and tm.obs.Nstars == jm.obs.Nstars
    assert tm.obs.param_description == jm.obs.param_description
    assert tm.param_names == jm.param_names and tm.n_params == jm.n_params
    assert tm.labelstring == jm.labelstring
    assert tm.obs.leaf_labels == jm.obs.leaf_labels
    assert sorted(tm.bands) == sorted(jm.bands) and tm.mags == jm.mags
    # the plan of the JAX package, carried across as numpy, is the same plan
    carried = plan_from_reference(jp, ics[1])
    for f in dataclasses.fields(tp):
        if f.name != "ic":
            np.testing.assert_array_equal(np.asarray(getattr(carried, f.name)), np.asarray(getattr(tp, f.name)))


@pytest.mark.parametrize("folder, kw", CASES[2:5], ids=CASE_IDS[2:5])
def test_print_ascii_matches_jax(ics, folder, kw):
    jm, tm = _models(ics, folder, kw)
    texts = []
    for m in (jm, tm):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            m.print_ascii()
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "└─" in texts[1]
    p = [60.0, 50.0, 40.0, 9.0, 0.0, 200.0, 0.1] if tm.n_params == 7 else None
    if p is not None:
        out = io.StringIO()
        tm.obs.print_ascii(out, p=p)
        assert "model=" in out.getvalue() and "parallax" not in texts[1].split("\n")[0]


def test_tables_rows_dicts_and_frames(ics):
    """``from_df`` takes a list of row dicts, a dict of columns or a
    DataFrame and builds the same tree; ``to_df`` returns the rows that the
    JAX package's DataFrame holds; a rows file (CSV) builds the model."""
    _, tic = ics
    rows = ini_photometry_rows(tini.parse_ini(os.path.join(HERE, "star3", "star.ini")))
    frame = pd.DataFrame(rows)
    cols = {c: frame[c].values for c in frame.columns}
    ref = jobs.ObservationTree.from_df(frame)
    labels = [n.label for n in ref]
    for table in (rows, cols, frame):
        tree = tobs.ObservationTree.from_df(table)
        assert [n.label for n in tree] == labels
        assert tree.to_df() == ref.to_df().to_dict("records")
    assert tobs.table_rows(cols) == tobs.table_rows(frame)


def test_rows_file_builds_the_model(ics, tmp_path):
    jic, tic = ics
    rows = ini_photometry_rows(tini.parse_ini(os.path.join(HERE, "star4", "star.ini")))
    path = str(tmp_path / "obs.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    tm = StarModel(tic, obs=path, Teff=(5650, 120), parallax=(4.0, 0.1))
    jm = JaxStarModel(jic, obs=path, Teff=(5650, 120), parallax=(4.0, 0.1))
    assert tm.labelstring == jm.labelstring and tm.param_names == jm.param_names
    p = _points(tm, 64, seed=4)
    np.testing.assert_allclose(tm.lnlike_batch(p).numpy(), np.asarray(jm.lnlike_batch(jnp.asarray(p))), rtol=1e-10)


def test_tree_structure_and_parameter_maps(ics, tmp_path, monkeypatch):
    """The cases of ``tests/test_observation.py`` on the port's classes:
    resolution order, separate systems, the parameter maps' round trip."""
    import isochrones_torch.config as tconfig
    from isochrones_torch.grids.base import MissingGridError

    _, tic = ics
    t = tobs.ObservationTree()
    coarse, fine = tobs.Observation("coarse", "J", 10.0), tobs.Observation("fine", "K", 0.1)
    coarse.add_source(tobs.Source(9.0, 0.02))
    fine.add_source(tobs.Source(9.1, 0.02))
    t.add_observation(fine)
    t.add_observation(coarse)
    assert [o.name for o in t.observations] == ["coarse", "fine"]
    nodes = {n.instrument: n for n in t.get_obs_nodes()}
    assert nodes["fine"].parent is nodes["coarse"]

    t = tobs.ObservationTree()
    o = tobs.Observation("cam", "J", 1.0)
    o.add_source(tobs.Source(9.0, 0.02, separation=0.0, pa=0.0))
    o.add_source(tobs.Source(10.0, 0.02, separation=20.0, pa=90.0))
    t.add_observation(o)
    t.define_models(tic, N=1, index=[0, 1])
    assert t.Nstars == {0: 1, 1: 1} and t.systems == [0, 1]
    assert t.param_description == ["eep_0_0", "age_0", "feh_0", "distance_0", "AV_0",
                                   "eep_1_0", "age_1", "feh_1", "distance_1", "AV_1"]
    t = tobs.ObservationTree()
    o = tobs.Observation("cam", "J", 1.0)
    o.add_source(tobs.Source(9.0, 0.02))
    t.add_observation(o)
    t.define_models(tic, N=2, index=0)
    p = [60.0, 50.0, 9.0, 0.0, 200.0, 0.1]
    d = t.p2pardict(p)
    assert d["0_0"] == [60.0, 9.0, 0.0, 200.0, 0.1] and d["0_1"] == [50.0, 9.0, 0.0, 200.0, 0.1]
    assert t.pardict2p(d) == p
    with pytest.raises(ValueError):
        t.add_spectroscopy(label="9_9", Teff=(5000, 100))
    with pytest.raises(ValueError):
        t.add_parallax((5.0, 0.1), system=7)
    # without an interpolator observe() builds the MIST grids: no files, an error naming the path
    monkeypatch.setattr(tconfig, "ISOCHRONES", str(tmp_path))
    with pytest.raises(MissingGridError, match=re.escape(str(tmp_path))):
        tobs.Observation("cam", "J", 1.0).observe([tobs.Star(p[:5], 0, 0), tobs.Star(p[:5], 1, 0)], 0.02)


def test_tree_container_round_trip(ics, tmp_path):
    """``ObservationTree.save_hdf`` -> ``load_hdf`` through the HDF5 results
    file: the same plan, with limits' open ends restored; groups kept or
    replaced as the JAX package's ``save_hdf`` keeps or replaces them."""
    _, tic = ics
    tm = StarModel.from_ini(tic, os.path.join(HERE, "star4"), index=[0, 0, 1])
    tm.obs.add_limit(logg=(3.5, None))
    tm.obs.add_AV((0.1, 0.05), system=1)
    path = str(tmp_path / "tree.h5")
    tm.obs.save_hdf(path, path="a/b")
    with pytest.raises(IOError):
        tm.obs.save_hdf(path, path="a/b")
    tm.obs.save_hdf(path, path="a/b", append=True)
    tm.obs.save_hdf(path, path="other", append=True)
    back = tobs.ObservationTree.load_hdf(path, path="a/b", ic=tic)
    p0, p1 = tm.obs.plan(tic), back.plan(tic)
    for f in dataclasses.fields(p0):
        if f.name != "ic":
            np.testing.assert_array_equal(np.asarray(getattr(p0, f.name)), np.asarray(getattr(p1, f.name)), err_msg=f.name)
    assert back.limits == {"0_0": {"logg": (3.5, np.inf)}}
    with h5py.File(path, "r") as f:
        assert "a/b/obs/values" in f and "other/obs/values" in f
        assert json.loads(f["a/b/obs"].attrs["limits"]) == {"0_0": {"logg": [3.5, None]}}
    tm.obs.save_hdf(path, path="a/b", overwrite=True)
    with h5py.File(path, "r") as f:
        assert "other" not in f and "a/b/obs/values" in f


# ------------------------------------------------------------- the likelihood
@pytest.mark.parametrize("folder, kw", CASES, ids=CASE_IDS)
def test_tree_lnlike_plain_matches_jax(ics, folder, kw):
    jm, tm = _models(ics, folder, kw)
    pts = _points(tm)
    ref = np.asarray(jm.lnlike_batch(jnp.asarray(pts)))
    lk = TreeLikelihood.from_plan(tm.obs.plan(ics[1]))
    got = tree_lnlike_plain(torch.as_tensor(pts), lk).numpy()
    assert not np.isnan(got).any() and not np.isnan(ref).any()
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin) and (got[~fin] == -np.inf).all()
    assert 32 < fin.sum() < len(pts) - 32
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)
    # the dispatcher takes the plain version for a CPU tensor, the model too
    np.testing.assert_array_equal(tree_lnlike(torch.as_tensor(pts), lk).numpy(), got)
    np.testing.assert_array_equal(tm.lnlike_batch(pts).numpy(), got)
    np.testing.assert_array_equal(tobs.tree_lnlike_batch(tm.obs, ics[1], pts).numpy(), got)


def _host_walk(tm, p):
    pardict = tm.obs.p2pardict(list(p))
    model_values = {}
    for star, pars in pardict.items():
        T, g, f, mg = tm.ic.interp_mag(pars, tm.bands)
        vals = {"Teff": T, "logg": g, "feh": f, "density": float(tm.ic.density(*pars[:3]))}
        vals.update({b: float(v) for b, v in zip(tm.bands, mg)})
        model_values[star] = vals
    return tm.obs.lnlike(pardict, model_values)


@pytest.mark.parametrize("folder, kw", [CASES[0], CASES[2], CASES[4]], ids=[CASE_IDS[0], CASE_IDS[2], CASE_IDS[4]])
def test_tree_lnlike_plain_matches_host_walk(ics, folder, kw):
    """The batched likelihood against the port's own per-node walk of the
    tree (the reference's semantics), atol 1e-8."""
    _, tm = _models(ics, folder, kw)
    tm.obs.add_limit(logg=(3.0, None))
    pts = tree_points(tm.param_names, tm.ic.model.knots, 48, seed=7, narrow=True)[24:]  # no adversarial block
    batch = tm.lnlike_batch(pts).numpy()
    n_fin = 0
    for p, b in zip(pts, batch):
        host = _host_walk(tm, p)
        if np.isfinite(b):
            n_fin += 1
            assert np.isclose(host, b, atol=1e-8), (host, b)
        else:
            assert host == -np.inf
    assert n_fin >= 8


def test_tree_lnlike_row_rules(ics):
    """The -inf rules of the likelihood: an off-grid star spoils only the
    rows that hold it; a broken limit, a non-finite spectroscopy value and a
    NaN parameter give -inf; density rows use the full model table."""
    jic, tic = ics
    tm = StarModel.from_ini(tic, os.path.join(HERE, "star3"))
    lk = TreeLikelihood.from_plan(tm.obs.plan(tic))
    eeps = tic.model.knots[2]
    on = torch.tensor([[60.0, 50.0, 40.0, 9.0, 0.0, 200.0, 0.1]], dtype=torch.float64)
    off = on.clone()
    off[0, 2] = float(eeps[0]) - 0.5  # the third star below the grid
    assert torch.isfinite(tree_lnlike_plain(on, lk)).all()
    assert (tree_lnlike_plain(off, lk) == float("-inf")).all()
    quiet = dataclasses.replace(lk, obs_active=torch.where(lk.member[:, 2] > 0, 0, lk.obs_active).to(torch.int32))
    assert torch.isfinite(tree_lnlike_plain(off, quiet)).all()
    # ... unless a relative row's reference row holds it
    ref_rows = torch.unique(lk.obs_ref[lk.obs_ref >= 0])
    assert (lk.member[ref_rows.long(), 0] > 0).all()
    off0 = on.clone()
    off0[0, 0] = float(eeps[0]) - 0.5
    quiet0 = dataclasses.replace(lk, obs_active=torch.where(lk.member[:, 0] > 0, 0, lk.obs_active).to(torch.int32))
    assert int(quiet0.obs_active.sum()) > 0 and (tree_lnlike_plain(off0, quiet0) == float("-inf")).all()

    kw = dict(J=(9.5, 0.02), H=(9.2, 0.02), Teff=(5800, 100), density=(1.4, 0.3), AV=(0.1, 0.05), parallax=(5.0, 0.05))
    td, jd = StarModel(tic, N=2, **kw), JaxStarModel(jic, N=2, **kw)
    for m in (td, jd):
        m.obs.add_limit(logg=(4.0, None))
        m.obs.add_limit(label="0_1", density=(None, 50.0))
    assert TreeLikelihood.from_plan(td.obs.plan(tic)).full_model is not None
    pts = _points(td, 256, seed=9)
    pts[-1, 0] = np.nan
    got, ref = td.lnlike_batch(pts).numpy(), np.asarray(jd.lnlike_batch(jnp.asarray(pts)))
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin) and got[-1] == -np.inf and 16 < fin.sum() < 240
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)
    free = StarModel(tic, N=2, **kw)  # without the limits more points are finite
    assert np.isfinite(free.lnlike_batch(pts).numpy()).sum() > fin.sum()
