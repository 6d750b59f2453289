"""Port parity of the MIST grid pipeline, ``isochrones_torch.grids.mist`` and
``get_ichrone("mist")``, against the JAX package, float64, on one tree of
MIST-format files written by ``tests/mist_fixtures.py`` (two [Fe/H]s, three
track masses with one short track, three isochrone ages, the UBVRIplus and
WISE tables).

- parsed tables, index levels, the densified grids with their NaN patterns,
  ``dm_deep``, ``dt_deep``, the array grids of the EEP inversion and the BC
  grid: bitwise;
- band resolution over every band of the 14 systems and the shortcuts, and
  ``max_eep`` over a mass x [Fe/H] sweep: exact;
- the eep(age) fits: 1e-10;
- the interpolators (``interp_value``, ``interp_mag``, ``get_eep`` fast and
  accurate, ``generate``, ``isochrone``): 1e-10 with identical NaN patterns;
- ``BinaryStarModel`` and the tree ``StarModel`` ``lnpost_batch``: 1e-9;
- the caches (a second build bitwise the first, under names of the port's
  own), the error naming a missing path, a run with pandas unavailable, and
  the MIST-format writer of ``chip_smoke.py`` against the fixture's files.
"""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import isochrones_tpu.config as jconfig
import isochrones_tpu.grids.mist as jmist
import isochrones_torch.config as tconfig
import isochrones_torch.grids.mist as tmist
from mist_fixtures import make_full_mist_fixture

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE_EEP = 60
FEHS = np.array([-0.5, 0.0])
BANDS = ["J", "H", "K", "G", "W1"]


def _patch(mp, root):
    """Point both packages at ``root`` and at the fixture's [Fe/H]s and
    track length, as ``tests/test_mist_pipeline.py`` does."""
    for config, mod in ((jconfig, jmist), (tconfig, tmist)):
        mp.setattr(config, "ISOCHRONES", root)
        mp.setattr(mod.MISTModelGrid, "max_eep", lambda self, m, feh: FIXTURE_EEP)
        mp.setattr(mod.MISTModelGrid, "fehs", FEHS)
        mp.setattr(mod.MISTModelGrid, "n_eep", FIXTURE_EEP)


@pytest.fixture(scope="module")
def mist_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("isochrones_data"))
    make_full_mist_fixture(root)
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, root)
        yield root


@pytest.fixture(scope="module")
def grids(mist_root):
    """Each package's iso, track and BC grid objects, the port's built
    first (from the files: no cache of its own exists yet)."""
    t = (tmist.MISTIsochroneGrid(device="cpu"), tmist.MISTEvolutionTrackGrid(device="cpu"),
         tmist.MISTBolometricCorrectionGrid(bands=BANDS, device="cpu"))
    for g in t:
        g.grid_data
    j = (jmist.MISTIsochroneGrid(), jmist.MISTEvolutionTrackGrid(), jmist.MISTBolometricCorrectionGrid(bands=BANDS))
    for g in j:
        g.grid_data
    return dict(zip(("iso", "track", "bc"), zip(t, j)))


@pytest.fixture(scope="module")
def ics(mist_root):
    from isochrones_tpu import get_ichrone as jax_get_ichrone
    from isochrones_torch import get_ichrone

    return (get_ichrone("mist", bands=BANDS, device="cpu"), get_ichrone("mist", bands=BANDS, tracks=True, device="cpu"),
            jax_get_ichrone("mist", bands=BANDS), jax_get_ichrone("mist", bands=BANDS, tracks=True))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), np.nanmax(np.abs(a - b)) if a.dtype.kind == "f" else ""


def _same_table(tdf, jdf):
    """A port table bitwise the JAX DataFrame: columns in order with their
    dtypes, index names, arrays and levels."""
    assert tdf.columns == list(jdf.columns)
    for c in tdf.columns:
        _same(tdf[c], jdf[c].values)
    if not tdf.index.names:  # a table of rows with no index: the DataFrame has its RangeIndex
        assert type(jdf.index).__name__ == "RangeIndex" and len(tdf) == len(jdf)
        return
    assert tdf.index.names == list(jdf.index.names)
    for i, name in enumerate(tdf.index.names):
        _same(tdf.index.arrays[i], jdf.index.get_level_values(i).values)
        _same(tdf.index.levels[i], jdf.index.levels[i].values)


# ------------------------------------------------------------------ parsing
def test_parse_bitwise(mist_root, tmp_path):
    """Every fixture file and a table with comments and blank lines: the
    numpy parse is bitwise the JAX package's native parse."""
    from isochrones_tpu.grids.parse import parse_numeric_table as jparse
    from isochrones_torch.grids.parse import parse_numeric_table

    fn = str(tmp_path / "table.txt")
    rng = np.random.default_rng(0)
    with open(fn, "w") as f:
        f.write("# header comment\n# another\n")
        for i, row in enumerate(rng.normal(size=(200, 7)) * 10.0 ** rng.integers(-30, 30, size=(200, 7))):
            if i == 50:
                f.write("# mid-file comment\n\n")
            f.write(" ".join(f"{v:.17g}" for v in row) + "\n")
    files = [fn] + sorted(glob.glob(os.path.join(mist_root, "**", "*.*"), recursive=True))
    files = [f for f in files if f.endswith((".iso", ".eep", ".UBVRIplus", ".WISE", ".txt"))]
    assert len(files) == 1 + 6 + 2 + 4
    for f in files:
        _same(parse_numeric_table(f), jparse(f))
    with open(str(tmp_path / "ragged.txt"), "w") as f:
        f.write("1 2 3\n4 5\n")
    with pytest.raises(ValueError, match="ragged.txt"):
        parse_numeric_table(str(tmp_path / "ragged.txt"))
    open(str(tmp_path / "empty.txt"), "w").close()
    assert parse_numeric_table(str(tmp_path / "empty.txt")).shape == (0, 0)


@pytest.mark.parametrize("what", ["iso_file", "track_file", "track_feh", "track_completed", "iso_orig", "track_orig",
                                  "iso", "track", "bc", "bc_orig"])
def test_tables_bitwise(grids, what):
    """The parsed, completed and standardized tables: columns, dtypes,
    index arrays and levels bitwise (the iso grid's index level ``feh`` is
    the file name's [Fe/H], its column ``feh`` the surface value)."""
    (ti, ji), (tt, jt), (tb, jb) = grids["iso"], grids["track"], grids["bc"]
    if what == "iso_file":
        f = sorted(glob.glob(os.path.join(ti.get_directory_path(), "*.iso")))[0]
        _same_table(ti.to_df(f), ji.to_df(f))
    elif what == "track_file":
        f = tt.get_feh_filenames(0.0)[1]
        _same_table(tt.to_df(f), jt.to_df(f))
    elif what == "track_feh":
        _same_table(tt.df_all_feh(0.0), jt.df_all_feh(0.0))
    elif what == "track_completed":
        _same_table(tt.df_all_feh_interpolated(0.0), jt.df_all_feh_interpolated(0.0))
    elif what.endswith("_orig"):
        t, j = {"iso": (ti, ji), "track": (tt, jt), "bc": (tb, jb)}[what[:-5]]
        _same_table(t.get_df(orig=True), j.get_df(orig=True))
    else:
        t, j = {"iso": (ti, ji), "track": (tt, jt), "bc": (tb, jb)}[what]
        _same_table(t.df, j.df)
    if what == "iso":
        df = ti.df
        assert not np.array_equal(df["feh"], df.index.arrays[1])  # surface [Fe/H] against the file's
        assert set(np.unique(df.index.arrays[1])) == {-0.5, 0.0}


@pytest.mark.parametrize("what", ["iso", "track", "bc"])
def test_densified_grids_bitwise(grids, what):
    """The dense grids on the product of the levels, with their NaN padding,
    the knots and the axis maps."""
    t, j = grids[what]
    tg, jg = t.grid_data, j.grid_data
    assert tg.columns == jg.columns
    _same(tg.host_values, jg.host_values)
    _same(tg.values.numpy(), np.asarray(jg.values))
    for a, b in zip(tg.knots, jg.knots):
        _same(a.numpy(), np.asarray(b))
    assert tg.axis_maps == tuple(jg.axis_maps)
    if what == "iso":
        assert np.isnan(tg.host_values).any()  # a partial product, NaN-padded
    if what == "track":
        assert "interpolated" in tg.columns and len(tg.columns) == 18


def test_basic_isochrones_bitwise(mist_root, tmp_path):
    """The ``basic_isos`` grid (no surface abundances: the column ``feh`` is
    the file name's) from the same files under its own directory name."""
    import shutil

    root = str(tmp_path)
    shutil.copytree(os.path.join(mist_root, "mist", "MIST_v1.2_vvcrit0.4_full_isos"),
                    os.path.join(root, "mist", "MIST_v1.2_vvcrit0.4_basic_isos"))
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, root)
        t, j = tmist.MISTBasicIsochroneGrid(device="cpu"), jmist.MISTBasicIsochroneGrid()
        _same_table(t.df, j.df)
        _same(t.grid_data.host_values, j.grid_data.host_values)
        assert "delta_nu" not in t.df.columns and np.array_equal(t.df["feh"], t.df.index.arrays[1])


def test_derivative_columns_and_array_grids(grids):
    (ti, ji), (tt, jt) = grids["iso"], grids["track"]
    for prop in ("Teff", "logg", "mass", "age", "eep", "feh", "radius"):
        assert ti.get_limits(prop) == ji.get_limits(prop) and tt.get_limits(prop) == jt.get_limits(prop), prop
    _same(ti.get_dm_deep(), ji.get_dm_deep().values)
    _same(tt.get_dt_deep(), jt.get_dt_deep().values)
    for a, b in zip(tt.get_array_grids(), jt.get_array_grids()):
        _same(a, b)
    with pytest.raises(NotImplementedError):
        ti.get_array_grids()
    assert tt.n_masses == jt.n_masses == 3
    _same(tt.masses, jt.masses)


def test_one_row_isochrone_raises(tmp_path):
    """A group of one row makes ``np.gradient`` raise in both packages."""
    from mist_fixtures import make_iso_tree

    root = str(tmp_path)
    make_iso_tree(root, ages=(8.0, 9.0), masses=(0.3, 0.31))  # some isochrones hold one EEP
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, root)
        for mod in (tmist, jmist):
            with pytest.raises(ValueError):
                mod.MISTIsochroneGrid(**({"device": "cpu"} if mod is tmist else {})).get_dm_deep()


def test_ragged_completion_needs_both_neighbours(tmp_path):
    """The lightest track short: no complete lighter neighbour, both
    packages raise ``ValueError``."""
    from mist_fixtures import make_track_tree

    root = str(tmp_path)
    make_track_tree(root, short={(0.0, 0.7): 40})
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, root)
        for grid in (tmist.MISTEvolutionTrackGrid(device="cpu"), jmist.MISTEvolutionTrackGrid()):
            with pytest.raises(ValueError, match="mlo"):
                grid.df_all_feh_interpolated(0.0)


def test_track_header_warning_path(tmp_path, caplog):
    """A '# EEPs:' line that disagrees with the rows: numbered from the
    first EEP, in both packages."""
    from mist_fixtures import write_track_file

    fn = write_track_file(str(tmp_path), 0.8, 0.0, 20)
    with open(fn) as f:
        text = f.read().replace("# EEPs: 1 ", "# EEPs: 3 ", 1)
    with open(fn, "w", encoding="latin-1") as f:
        f.write(text.replace("(test fixture)", "(test fixture, é)"))
    _same_table(tmist.MISTEvolutionTrackGrid.to_df(fn), jmist.MISTEvolutionTrackGrid.to_df(fn))
    assert tmist.MISTEvolutionTrackGrid.to_df(fn)["EEP"][0] == 3


# ------------------------------------------------------------- bands, EEPs
def test_band_resolution_matches():
    names = [b for bands in jmist.MISTBolometricCorrectionGrid.phot_bands.values() for b in bands]
    shortcuts = ["u", "g", "r", "i", "z", "U", "B", "V", "R", "I", "J", "H", "Ks", "K", "kep", "Kepler", "Kp",
                 "TESS", "W1", "W2", "W3", "W4", "G", "BP", "RP", "Bp", "Rp", "PanSTARRS_g", "LSST_u", "UK_J",
                 "UKIRT_K", "SDSS_g", "JWST_F200W"]
    assert len(names) == 106 and len(jmist.MISTBolometricCorrectionGrid.phot_bands) == 14
    for b in names + shortcuts:
        assert tmist.MISTBolometricCorrectionGrid.get_band(b) == jmist.MISTBolometricCorrectionGrid.get_band(b), b
    for b in ("notaband", "F999W", "HST_WFC3_x"):
        for mod in (tmist, jmist):
            with pytest.raises(ValueError, match="cannot resolve"):
                mod.MISTBolometricCorrectionGrid.get_band(b)


def test_max_eep_sweep():
    from isochrones_tpu.grids.mist_eep import default_max_eep as jdef, max_eep as jmax
    from isochrones_torch.grids.mist_eep import default_max_eep, max_eep, max_eep_vectorized

    masses = np.concatenate([np.round(np.arange(0.1, 25.0, 0.01), 2), [0.6, 0.65, 0.94, 1.78, 2.48, 2.5, 4.4, 19.0]])
    for feh in list(tmist.MISTModelGrid.fehs) + [0.1]:
        assert [max_eep(float(m), feh) for m in masses] == [jmax(float(m), feh) for m in masses]
        _same(max_eep_vectorized(masses, feh), np.array([jmax(float(m), feh) for m in masses]))
    assert [default_max_eep(float(m)) for m in masses] == [jdef(float(m)) for m in masses]


def test_eep_fits(grids, monkeypatch):
    """The section polynomials, the approximate fit and ``get_eep_fit``:
    1e-10."""
    for mod in (tmist, jmist):
        monkeypatch.setattr(mod.MISTEvolutionTrackGrid, "primary_eeps", (1, 20, 40, 60))
    t = tmist.MISTEvolutionTrackGrid(device="cpu")
    j = jmist.MISTEvolutionTrackGrid()
    for a, b in ((1, 20), (20, 40), (40, 60)):
        ts, js = t.fit_eep_section(a, b, order=3), j.fit_eep_section(a, b, order=3)
        assert ts.shape == js.shape == (6, 4)
        np.testing.assert_allclose(ts.values, js.values.astype(float), rtol=1e-10, atol=0)
    ta, ja = t.fit_approx_eep(max_fit_eep=60), j.fit_approx_eep(max_fit_eep=60)
    assert ta.columns == list(ja.columns)
    np.testing.assert_allclose(ta.values, ja.values, rtol=1e-10, atol=1e-10)
    t.write_eep_params(orders=[3, 3, 3])
    j.write_eep_params(orders=[3, 3, 3])
    assert t.eep_param_filename != j.eep_param_filename
    for mass, age, feh in ((0.8, 8.8, 0.0), (0.75, 9.2, -0.25), (0.9, 8.1, -0.5)):
        for approx in (True, False):
            np.testing.assert_allclose(t.get_eep_fit(mass, age, feh, approx=approx),
                                       j.get_eep_fit(mass, age, feh, approx=approx), rtol=1e-10)
    assert np.array_equal(t.primary_eeps_arr, j.primary_eeps_arr)


def test_view_eep_fit(grids, monkeypatch):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.setattr(tmist.MISTEvolutionTrackGrid, "primary_eeps", (1, 20, 40, 60))
    t = tmist.MISTEvolutionTrackGrid(device="cpu")
    ax = t.view_eep_fit(0.7, 0.0, plot_p0=True)
    assert ax.get_title() == "mass=0.7, feh=0.0" and len(ax.lines) >= 4


# ----------------------------------------------------------- interpolators
def _close(a, b, tol=1e-10):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _iso_points(n, seed):
    rng = np.random.default_rng(seed)
    eep = rng.uniform(0, 62, n)
    eep[:8] = [1, 60, 30, 59.5, 0.5, 61, np.nan, 20]
    age = rng.uniform(7.9, 9.1, n)
    age[8:12] = [8.0, 9.0, 8.5, np.nan]
    feh = rng.uniform(-0.6, 0.1, n)
    feh[12:15] = [-0.5, 0.0, -0.25]
    return eep, age, feh


def _track_points(n, seed):
    rng = np.random.default_rng(seed)
    mass = rng.uniform(0.65, 0.95, n)
    mass[:4] = [0.7, 0.8, 0.9, np.nan]
    eep = rng.uniform(0, 62, n)
    eep[4:8] = [1, 60, 41, 40]
    feh = rng.uniform(-0.6, 0.1, n)
    feh[8:10] = [-0.5, 0.0]
    return mass, eep, feh


def test_interp_value_and_mag(ics):
    tiso, ttrack, jiso, jtrack = ics
    for (t, j), pts in (((tiso, jiso), _iso_points(400, 0)), ((ttrack, jtrack), _track_points(400, 1))):
        cols = list(j.model.columns)
        _close(t.interp_value(list(pts), cols), j.interp_value(list(pts), cols))
        full = list(pts) + [np.full(400, 150.0), np.linspace(0, 1, 400)]
        for a, b in zip(t.interp_mag(full, BANDS), j.interp_mag(full, BANDS)):
            _close(a, b)
    assert list(tiso.model.columns) == list(jiso.model.columns)
    assert tiso.grid_type is tmist.MISTIsochroneGrid and ttrack.grid_type is tmist.MISTEvolutionTrackGrid
    assert tiso.bc_type is ttrack.bc_type is tmist.MISTBolometricCorrectionGrid


@pytest.mark.parametrize("accurate", [False, True])
def test_get_eep(ics, accurate):
    tiso, ttrack, jiso, jtrack = ics
    rng = np.random.default_rng(3)
    mass = rng.uniform(0.6, 1.0, 300)
    age = rng.uniform(7.5, 9.5, 300)
    feh = rng.uniform(-0.6, 0.1, 300)
    mass[:3], age[3:5], feh[5:7] = [0.7, 0.8, np.nan], [np.nan, 9.0], [-0.5, 0.0]
    _close(ttrack.get_eep(mass, age, feh, accurate=accurate), jtrack.get_eep(mass, age, feh, accurate=accurate))
    if accurate:
        _close(tiso.get_eep(mass, age, feh, accurate=True), jiso.get_eep(mass, age, feh, accurate=True))


def test_generate_and_isochrone(ics):
    tiso, ttrack, jiso, jtrack = ics
    rng = np.random.default_rng(4)
    mass, age, feh = rng.uniform(0.7, 0.9, 200), rng.uniform(8.0, 9.2, 200), rng.uniform(-0.5, 0.0, 200)
    for accurate in (False, True):
        tg = ttrack.generate(mass, age, feh, distance=200.0, AV=0.1, accurate=accurate)
        jg = jtrack.generate(mass, age, feh, distance=200.0, AV=0.1, accurate=accurate)
        assert sorted(tg.columns) == sorted(jg.columns)
        for c in jg.columns:
            _close(tg[c], jg[c].values)
    rows = 0
    for age in (8.0, 8.5, 9.0):
        # at [Fe/H] -0.5 the surface [Fe/H] falls an ulp below the BC grid: no row in either package
        for feh in (0.0, -0.5, -0.2):
            ti, ji = tiso.isochrone(age, feh=feh), jiso.isochrone(age, feh=feh)
            assert len(ti["eep"]) == len(ji)
            rows += len(ji)
            for c in ji.columns:
                _close(ti[c], ji[c].values)
        _close(tiso.isochrone(age, feh=-0.5, dropna=False)["eep"], jiso.isochrone(age, feh=-0.5, dropna=False)["eep"])
    assert rows > 200


def test_lnpost_batch(ics):
    """The binary model and a tree model of two stars from a ``star.ini``
    on ``get_ichrone("mist")``: 1e-9 with identical finite patterns."""
    from isochrones_tpu import starmodel as jsm
    from isochrones_tpu.treemodel import StarModel as JaxStarModel
    from isochrones_torch import starmodel as tsm
    from isochrones_torch.treemodel import StarModel

    tiso, _, jiso, _ = ics
    truth = [40.0, 8.5, -0.1, 200.0, 0.1]
    Teff, logg, _, mags = jiso.interp_mag(truth, ["J", "H", "K", "G"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05))
    obs.update({b: (float(m), 0.02) for b, m in zip("JHKG", np.asarray(mags))})
    rng = np.random.default_rng(5)
    n = 512
    pts = np.empty((n, 6))
    pts[:, :2] = np.sort(rng.uniform(1, 61, (n, 2)), axis=1)[:, ::-1]
    pts[:, 2:] = np.asarray(truth[1:]) + rng.normal(0, [0.4, 0.3, 30.0, 0.05], (n, 4))
    pts[:, 5] = np.abs(pts[:, 5])
    pts[:4, 0] = [1.0, 60.0, 61.0, np.nan]
    tm, jm = tsm.BinaryStarModel(tiso, **obs), jsm.BinaryStarModel(jiso, **obs)
    t = tm.lnpost_batch(torch.as_tensor(pts)).numpy()
    j = np.asarray(jm.lnpost_batch(pts))
    assert np.array_equal(np.isfinite(t), np.isfinite(j)) and np.isfinite(t).sum() > 20
    np.testing.assert_allclose(t[np.isfinite(t)], j[np.isfinite(j)], rtol=1e-9, atol=1e-9)

    folder = os.path.join(tconfig.ISOCHRONES, "star_tree")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "star.ini"), "w") as f:
        f.write(f"Teff = {float(Teff):.1f}, 100\nlogg = {float(logg):.3f}, 0.1\nparallax = 5.0, 0.05\n\n[twomass]\n"
                + "".join(f"{b} = {float(m):.4f}, 0.02\n" for b, m in zip("JHK", np.asarray(mags))) + "\n[WISE]\n"
                + f"W1 = {float(mags[2]) - 0.05:.4f}, 0.05\n")
    tt = StarModel.from_ini(tiso, folder, N=2)
    jt = JaxStarModel.from_ini(jiso, folder, N=2)
    assert list(tt.param_names) == list(jt.param_names)
    k = len(tt.param_names)
    tp = np.empty((n, k))
    tp[:, :2] = pts[:, :2]
    tp[:, 2:] = pts[:, 2:6][:, :k - 2]
    t = tt.lnpost_batch(torch.as_tensor(tp)).numpy()
    j = np.asarray(jt.lnpost_batch(tp))
    assert np.array_equal(np.isfinite(t), np.isfinite(j)) and np.isfinite(t).any()
    np.testing.assert_allclose(t[np.isfinite(t)], j[np.isfinite(j)], rtol=1e-9, atol=1e-9)


# ----------------------------------------------------------------- caches
def test_cache_round_trip(grids, ics):
    """New grid objects read the port's caches and give bitwise the first
    build; the port's cache files carry names of their own."""
    tiso = ics[0]
    (ti, _), (tt, _), (tb, _) = grids["iso"], grids["track"], grids["bc"]
    for first, again in ((ti, tmist.MISTIsochroneGrid(device="cpu")), (tt, tmist.MISTEvolutionTrackGrid(device="cpu")),
                         (tb, tmist.MISTBolometricCorrectionGrid(bands=BANDS, device="cpu"))):
        _same(again.grid_data.host_values, first.grid_data.host_values)
        _same_table_t(again.df, first.df)
    _same(tiso.model.host_values, ti.grid_data.host_values)
    ours = glob.glob(os.path.join(tconfig.ISOCHRONES, "**", "*.torch.npz"), recursive=True)
    theirs = glob.glob(os.path.join(tconfig.ISOCHRONES, "**", "*.parquet"), recursive=True)
    assert len(ours) >= 9 and len(theirs) >= 7
    assert not {os.path.splitext(p)[0] for p in ours} & {os.path.splitext(p)[0] for p in theirs}
    assert tt.get_feh_cache_filename(0.0, interpolated=True).endswith("all_masses_interpolated.torch.npz")


def _same_table_t(a, b):
    assert a.columns == b.columns and a.index.names == b.index.names
    for c in a.columns:
        _same(a[c], b[c])
    for x, y in zip(a.index.arrays, b.index.arrays):
        _same(x, y)


def test_get_ichrone_mist_cache_and_links(ics, mist_root):
    from isochrones_torch import get_ichrone

    tiso, ttrack = ics[:2]
    assert get_ichrone("mist", bands=BANDS, device="cpu") is tiso
    assert get_ichrone(bands=BANDS, tracks=True, device="cpu") is ttrack
    assert tiso.track is ttrack and ttrack.iso is tiso
    assert tiso.eep_replaces == "mass" and ttrack.eep_replaces == "age"
    f32 = get_ichrone("mist", bands=BANDS, device="cpu", dtype=torch.float32)
    assert f32.dtype == torch.float32 and f32 is not tiso
    np.testing.assert_array_equal(f32.model.values.numpy(), tiso.model.values.numpy().astype(np.float32))
    tiso.initialize([30.0, 8.5, -0.2, 100.0, 0.1])
    ttrack.initialize([0.8, 30.0, -0.2, 100.0, 0.1])


def test_initialize_cli_and_tarball(tmp_path, capsys):
    """``mist-initialize-torch`` (its default check points need EEP 150 and
    log age 9.7: a tree of 200-EEP tracks from the port's writer); a track
    directory removed and its tarball left: extracted, not fetched."""
    import shutil
    import tarfile

    from isochrones_torch.cli.initialize import main
    from isochrones_torch.grids.mist_files import make_full_mist_tree

    root = str(tmp_path)
    make_full_mist_tree(root, track_kwargs=dict(masses=(0.9, 1.0, 1.1), short={}, n_eep=200),
                        iso_kwargs=dict(ages=(9.5, 9.7, 9.9), n_eep=200))
    grid = tmist.MISTEvolutionTrackGrid(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp, root)
        for mod in (tmist, jmist):
            mp.setattr(mod.MISTModelGrid, "max_eep", lambda self, m, feh: 200)
            mp.setattr(mod.MISTModelGrid, "n_eep", 200)
        d = grid.get_directory_path(0.0)
        with tarfile.open(grid.get_tarball_file(0.0), "w:xz") as tar:
            tar.add(d, arcname=os.path.basename(d))
        shutil.rmtree(d)
        with pytest.raises(SystemExit):
            main(["--help"])
        assert main(["--bands", "J", "K", "--device", "cpu"]) == 0
        assert os.path.isdir(d) and len(grid.get_feh_filenames(0.0)) == 3
    assert "Grids initialized." in capsys.readouterr().out


@pytest.mark.parametrize("offline", [False, True])
def test_missing_files_name_the_path(tmp_path, offline):
    """An empty ``$ISOCHRONES``: the error names the missing tarball and
    the URL, and nothing is fetched or created."""
    from isochrones_torch import get_ichrone
    from isochrones_torch.grids.base import MissingGridError

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "ISOCHRONES", str(tmp_path))
        mp.setattr(tconfig, "OFFLINE", offline)
        with pytest.raises(MissingGridError, match=re.escape(str(tmp_path))) as e:
            get_ichrone("mist", device="cpu")
        assert "BC" in str(e.value) and "http://waps.cfa.harvard.edu/MIST/BC_tables/UBVRIplus.txz" in str(e.value)
        assert ("offline" in str(e.value)) == offline
        for grid in (tmist.MISTEvolutionTrackGrid(device="cpu"), tmist.MISTIsochroneGrid(device="cpu")):
            with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path))):
                grid.df
    assert os.listdir(tmp_path) == []


def test_pandas_free_run(mist_root):
    """``get_ichrone("mist", device="cpu")`` and ``isochrone`` in a process
    where pandas cannot be imported."""
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "import numpy as np\n"
        "import isochrones_torch.config as c; c.ISOCHRONES = sys.argv[1]\n"
        "import isochrones_torch.grids.mist as m\n"
        "m.MISTModelGrid.max_eep = lambda self, mass, feh: 60\n"
        "m.MISTModelGrid.fehs = np.array([-0.5, 0.0]); m.MISTModelGrid.n_eep = 60\n"
        "from isochrones_torch import get_ichrone\n"
        "iso = get_ichrone('mist', bands=['J', 'K'], device='cpu')\n"
        "df = iso.isochrone(8.5, feh=0.0)\n"
        "assert len(df['eep']) > 10 and np.isfinite(df['J_mag']).all()\n"
        "assert 'pandas' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok', len(df['eep']))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, mist_root], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_grid_interpolator(grids):
    """``GridInterpolator`` from a table: ``__call__``, ``index_columns``,
    ``add_column`` and ``find_closest`` against the JAX class (1e-10)."""
    from isochrones_tpu.ops.interp import GridInterpolator as JaxGridInterpolator
    from isochrones_torch.ops.interp import GridInterpolator

    (ti, ji) = grids["iso"]
    t, j = GridInterpolator(ti.df, device="cpu"), JaxGridInterpolator(ji.df)
    assert t.index_names == j.index_names and t.columns == j.columns and t.ndim == j.ndim == 3
    for a, b in zip(t.index_columns, j.index_columns):
        _same(a, b)
    eep, age, feh = _iso_points(200, 7)
    _close(t([age, feh, eep]), j([age, feh, eep]))
    _close(t([8.5, 0.0, 30.0], ["Teff", "logg"]), j([8.5, 0.0, 30.0], ["Teff", "logg"]))
    extra = np.arange(t.grid.size // t.n_columns, dtype=float).reshape(t.grid.shape[:-1])
    t.add_column(extra, "extra")
    j.add_column(extra, "extra")
    _same(t.grid, j.grid)
    _close(t([age, feh, eep], ["extra", "mass"]), j([age, feh, eep], ["extra", "mass"]))
    for val in (0.8, 1.2, 2.0):
        _close(float(t.find_closest(val, 1.0, 60.0, 8.5, 0.0)), float(j.find_closest(val, 1.0, 60.0, 8.5, 0.0)))


def test_writer_matches_fixture(tmp_path):
    """``isochrones_torch.grids.mist_files`` (the writer of ``chip_smoke.py``)
    at the fixture's sizes: every file byte for byte ``tests/mist_fixtures``'s,
    but the BC columns of bands whose coefficients the fixture draws from
    ``hash``."""
    from isochrones_torch.grids.mist_files import make_full_mist_tree
    from isochrones_torch.grids.synthetic import _BAND_ZP

    a, b = str(tmp_path / "fixture"), str(tmp_path / "writer")
    make_full_mist_fixture(a)
    make_full_mist_tree(b)
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    assert len(files) == 12
    compared = 0
    for rel in files:
        with open(os.path.join(a, rel), "rb") as f:
            fa = f.read()
        with open(os.path.join(b, rel), "rb") as f:
            fb = f.read()
        if "BC" not in rel:
            assert fa == fb, rel
            continue
        la, lb = fa.decode().splitlines(), fb.decode().splitlines()
        assert la[:6] == lb[:6] and len(la) == len(lb) == 6 + 45
        names = la[5][1:].split()
        keep = [i for i, n in enumerate(names) if i < 5 or n.split("_")[-1] in _BAND_ZP]
        assert 8 <= len(keep) < len(names)
        for x, y in zip(la[6:], lb[6:]):
            x, y = x.split(), y.split()
            assert [x[i] for i in keep] == [y[i] for i in keep]
            compared += len(keep)
    assert compared == 2 * 45 * 13 + 2 * 45 * 8  # UBVRIplus: 5 + 8 columns, WISE: 5 + 3


def test_writer_digest_is_stable():
    """The writer's BC of a band outside the synthetic tables is the same in
    a process of another hash seed (CRC-32 of its name), unlike the
    fixture's ``hash``."""
    from isochrones_torch.grids.mist_files import bc_value

    code = ("from isochrones_torch.grids.mist_files import bc_value; "
            "print(repr(float(bc_value('Gaia_G_DR2Rev', 3.76, 4.4, 0.0, 0.3))))")
    seed = "1" if os.environ.get("PYTHONHASHSEED") != "1" else "2"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONHASHSEED=seed)).stdout
    assert float(out) == float(bc_value("Gaia_G_DR2Rev", 3.76, 4.4, 0.0, 0.3)) != 0.0
