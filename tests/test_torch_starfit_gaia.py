"""The port's ``starfit`` with the Gaia query, the corner plots and the
summarize and select CLIs, against the JAX package on the CPU (the default
synthetic grid, copies of ``tests/star1`` and ``tests/star3``, short fits).

The JAX side builds its model from the same ``star.ini`` and injected Gaia
table and stops at its fit (``fit`` patched to raise): the ini files must be
byte-identical and the models' observables equal. For the CLIs, the JAX
results files are written from the port's own draws (the JAX model's
samples set to them, its derived samples computed by the JAX interpolator),
so both CLIs read one posterior: the same columns, the values to 1e-6, the
same multiplicity order and evidence differences."""

import filecmp
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.isochrone as jiso
import isochrones_tpu.query as jq
import isochrones_tpu.starfit as jsf
import isochrones_torch.isochrone as tiso
import isochrones_torch.query as tq
from isochrones_tpu import config as jconfig
from isochrones_tpu.cli.select import main as jax_select
from isochrones_tpu.cli.summarize import main as jax_summarize
from isochrones_tpu.starmodel import BasicStarModel as JaxBasicStarModel
from isochrones_tpu.treemodel import StarModel as JaxStarModel
from isochrones_torch import config as tconfig
from isochrones_torch.cli.select import main as select
from isochrones_torch.cli.summarize import main as summarize
from isochrones_torch.starfit import starfit
from isochrones_torch.treemodel import StarModel

HERE = os.path.dirname(os.path.abspath(__file__))
SHORT = dict(n_live_points=60, n_batch=8, n_chains=4, n_repeat=8, max_iter=240, seed=0)
GAIA_BANDS = ("G", "BP", "RP")


def _gaia_table(ra, dec, radius, name):
    """Three sources: the closest passes the quality cuts, the second fails
    them (RPlx), the third passes and lies farther out."""
    dec_off = np.array([0.5, 1.5, 3.0]) / 3600
    return {
        "_RAJ2000": np.full(3, ra), "_DEJ2000": dec + dec_off,
        "Gmag": [10.21, 9.8, 11.0], "e_Gmag": [0.001, 0.001, 0.002],
        "BPmag": [10.52, 10.1, 11.3], "e_BPmag": [0.002, 0.002, 0.003],
        "RPmag": [9.74, 9.3, 10.5], "e_RPmag": [0.002, 0.002, 0.003],
        "Plx": [4.2, 3.0, 1.0], "e_Plx": [0.05, 0.1, 0.2],
        "RPlx": [80.0, 5.0, 20.0], "RFG": [100.0] * 3, "RFRP": [50.0] * 3, "RFBP": [50.0] * 3,
        "Nper": [12] * 3, "chi2AL": [100.0] * 3, "NgAL": [105] * 3, "Source": [11, 22, 33],
    }


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def gaia(monkeypatch, tmp_path):
    """The injected Gaia table in both packages, MIST's files absent (the JAX
    package offline), so that a reloaded model comes back on the synthetic
    grids."""
    monkeypatch.setattr(jq.Gaia, "table_provider", staticmethod(lambda *a: pd.DataFrame(_gaia_table(*a))))
    monkeypatch.setattr(tq.Gaia, "table_provider", staticmethod(_gaia_table))
    for cfg in (tconfig, jconfig):
        monkeypatch.setattr(cfg, "ISOCHRONES", str(tmp_path / "no_mist"))
    monkeypatch.setattr(jconfig, "OFFLINE", True)


class _Stop(Exception):
    pass


def _jax_model(folder, **kw):
    """The model the JAX ``starfit`` builds for ``folder``, stopped at its fit."""
    built = []

    def fit(self, **fit_kw):
        built.append(self)
        raise _Stop

    failures = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBasicStarModel, "fit", fit)
        jsf.starfit(folder, models="synthetic", failures=failures, no_plots=True, **kw)
    assert len(built) == 1 and len(failures) == 1
    return built[0]


def _copies(tmp_path, star="star1"):
    out = []
    for pkg in ("port", "jax"):
        dst = tmp_path / pkg / star
        shutil.copytree(os.path.join(HERE, star), dst)
        out.append(str(dst))
    return out


def _log(folder):
    with open(os.path.join(folder, "starfit.log")) as f:
        return f.read()


@pytest.mark.parametrize("write_ini_file", [True, False])
def test_gaia_flat_fit_matches_jax(tmp_path, gaia, write_ini_file):
    tdir, jdir = _copies(tmp_path)
    failures = []
    kw = dict(gaia=True, write_ini_file=write_ini_file, gaia_radius=4.0, multiplicities=("binary",))
    mod, _ = starfit(tdir, models="synthetic", no_plots=True, device="cpu", failures=failures, **kw, **SHORT)
    jm = _jax_model(jdir, **kw)
    assert failures == [] and "binary starfit successful" in _log(tdir)
    assert filecmp.cmp(os.path.join(tdir, "star.ini"), os.path.join(jdir, "star.ini"), shallow=False)
    with open(os.path.join(tdir, "star.ini")) as f:
        ini = f.read()
    assert ("[gaia]" in ini and "parallax = 4.2, 0.05" in ini) == write_ini_file
    assert mod.kwargs == jm.kwargs and mod.N == jm.N == 2
    assert mod.kwargs["parallax"] == (4.2, 0.05) and all(b in mod.kwargs for b in GAIA_BANDS)
    assert os.path.exists(os.path.join(tdir, "synthetic_starmodel_binary.npz"))


def test_gaia_tree_model_matches_jax(tmp_path, gaia):
    """The tree reads its Gaia photometry from the written ini; without
    write_ini_file it takes the parallax alone."""
    for write_ini_file in (True, False):
        tdir, jdir = _copies(tmp_path / str(write_ini_file), "star3")
        kw = dict(gaia=True, write_ini_file=write_ini_file)
        failures = []
        mod, _ = starfit(tdir, models="synthetic", no_plots=True, device="cpu", failures=failures,
                         starmodel_type=StarModel, **kw, **{**SHORT, "max_iter": 120})
        jm = _jax_model(jdir, starmodel_type=JaxStarModel, **kw)
        assert failures == []
        assert filecmp.cmp(os.path.join(tdir, "star.ini"), os.path.join(jdir, "star.ini"), shallow=False)
        assert mod.obs.parallax == jm.obs.parallax and mod.obs.parallax[0] == (4.2, 0.05)
        assert sorted(mod.bands) == sorted(jm.bands)
        assert all(b in mod.bands for b in GAIA_BANDS) == write_ini_file


def test_parallax_only_fallback(tmp_path, gaia, monkeypatch):
    """A grid without Gaia's bands: the fit is conditioned on the parallax
    alone and the written ini loses its [gaia] section again."""
    tdir, jdir = _copies(tmp_path)
    for mod in (tiso, jiso):
        real = mod.get_ichrone

        def no_gaia(models, bands=None, _real=real, **kw):
            if bands and any(b in GAIA_BANDS for b in bands):
                raise ValueError("grid lacks the Gaia system")
            return _real(models, bands, **kw)

        monkeypatch.setattr(mod, "get_ichrone", no_gaia)
    failures = []
    mod, _ = starfit(tdir, models="synthetic", no_plots=True, device="cpu", failures=failures, gaia=True,
                     write_ini_file=True, **SHORT)
    jm = _jax_model(jdir, gaia=True, write_ini_file=True)
    assert failures == [] and "conditioning on parallax only" in _log(tdir)
    assert filecmp.cmp(os.path.join(tdir, "star.ini"), os.path.join(jdir, "star.ini"), shallow=False)
    with open(os.path.join(tdir, "star.ini")) as f:
        ini = f.read()
    assert "parallax = 4.2, 0.05" in ini and "[gaia]" not in ini
    assert mod.kwargs == jm.kwargs and not any(b in mod.kwargs for b in GAIA_BANDS)
    assert not any(b in mod.ic.bands for b in GAIA_BANDS)


def test_plots_and_freshness(tmp_path, gaia):
    (folder,) = _copies(tmp_path)[:1]
    failures = []
    kw = dict(models="synthetic", device="cpu", failures=failures, gaia=True, **SHORT)
    starfit(folder, **kw)
    pngs = [os.path.join(folder, f"synthetic_corner_single_{x}.png") for x in ("physical", "observed")]
    assert failures == [] and all(os.path.exists(p) for p in pngs)
    mtimes = [os.path.getmtime(p) for p in pngs]
    starfit(folder, **kw)  # fresh: neither the fit nor the plots are redone
    assert [os.path.getmtime(p) for p in pngs] == mtimes and "exists. Use overwrite" in _log(folder)
    results = os.path.join(folder, "synthetic_starmodel_single.npz")
    os.utime(results, (mtimes[0] + 10, mtimes[0] + 10))  # the results file newer than the plots
    starfit(folder, **kw)
    assert all(os.path.getmtime(p) > m for p, m in zip(pngs, mtimes))
    mtimes = [os.path.getmtime(p) for p in pngs]
    os.utime(results, (mtimes[0] - 10, mtimes[0] - 10))
    starfit(folder, plot_only=True, **kw)  # plot_only redraws whatever their age
    assert all(os.path.getmtime(p) > m for p, m in zip(pngs, mtimes)) and failures == []


def _jax_results(tdir, jdir, mult):
    """The JAX results file of ``jdir`` for ``mult`` from the port's fit in
    ``tdir``: the same draws and evidence, the derived samples from the JAX
    interpolator."""
    from isochrones_tpu import get_ichrone as jax_get_ichrone
    from isochrones_torch import BasicStarModel

    tm = BasicStarModel.load_hdf(os.path.join(tdir, f"synthetic_starmodel_{mult}.npz"), device="cpu")
    jm = JaxBasicStarModel(jax_get_ichrone("synthetic", bands=list(tm.ic.bands)), N=tm.N, name=tm.name,
                           directory=jdir, **tm.kwargs)
    jm._samples = pd.DataFrame({c: np.asarray(v) for c, v in tm.samples.items()})
    jm._evidence = tm.evidence
    jm.save_hdf(os.path.join(jdir, f"synthetic_starmodel_{mult}.h5"))


def test_summarize_and_select_clis(tmp_path, gaia, capsys):
    tdir, jdir = _copies(tmp_path)
    failures = []
    starfit(tdir, models="synthetic", no_plots=True, device="cpu", failures=failures, gaia=True,
            multiplicities=("single", "binary"), **SHORT)
    assert failures == []
    for mult in ("single", "binary"):
        _jax_results(tdir, jdir, mult)

    capsys.readouterr()
    assert select([tdir, "--models", "synthetic", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.replace(tdir, "FOLDER").splitlines()
    assert jax_select([jdir, "--models", "synthetic"]) == 0
    want = capsys.readouterr().out.replace(jdir, "FOLDER").splitlines()
    assert got == want and len(got) == 2 and [ln.split()[1] for ln in got] in (["single", "binary"],
                                                                                 ["binary", "single"])
    assert all("delta_lnZ = " in ln for ln in got)

    for mult in ("single", "binary"):
        out, jout = str(tmp_path / f"port_{mult}.csv"), str(tmp_path / f"jax_{mult}.csv")
        common = ["star1", "--modelname", f"synthetic_starmodel_{mult}", "--columns", "eep", "mass", "radius", "age",
                  "feh", "distance", "AV", "_mag$"]
        assert summarize(common + ["--rootdir", os.path.dirname(tdir), "-O", out, "--device", "cpu"]) == 0
        assert jax_summarize(common + ["--rootdir", os.path.dirname(jdir), "-O", jout]) == 0
        got, want = pd.read_csv(out, index_col=0), pd.read_csv(jout, index_col=0)
        assert list(got.columns) == list(want.columns) and list(got.index) == list(want.index) == ["star1"]
        assert any(c.startswith("G_mag") for c in got.columns)
        assert np.isfinite(got.values).all()
        np.testing.assert_allclose(got.values, want.values, rtol=1e-6)

    for flag in ([], ["--binary"]):
        args = ["star1", "--models", "synthetic", "--results-txt"] + flag
        assert summarize(args + ["--rootdir", os.path.dirname(tdir)]) == 0
        assert jax_summarize(args + ["--rootdir", os.path.dirname(jdir)]) == 0
        name = f"synthetic_{'binary' if flag else 'single'}_results.txt"
        assert filecmp.cmp(os.path.join(tdir, name), os.path.join(jdir, name), shallow=False)
