"""The port's per-folder summaries against the JAX package's: the same seeded
derived-samples table stored in each package's results file (``.h5`` for the
JAX package, the port's ``.npz``), then ``write_results_txt`` (byte-identical
files), ``get_quantiles`` and ``get_summary_df`` (the same frames to 1e-12),
and an ``.h5`` summary name (the same ``.csv`` in both: no PyTables here, and
none on the card's machine)."""

import json
import os

import h5py
import numpy as np
import pandas as pd
import pytest

import isochrones_tpu.summary as jsum
import isochrones_torch.summary as tsum
from isochrones_tpu import config as jconfig, get_ichrone as jax_get_ichrone
from isochrones_tpu.starmodel import BasicStarModel as JaxBasicStarModel
from isochrones_torch import BasicStarModel, config as tconfig, get_ichrone
from isochrones_torch.summary import Frame
from isochrones_torch.utils import npz_save

FLAT = ["eep", "age", "feh", "mass", "radius", "Teff", "logg", "J_mag", "H_mag", "K_mag", "parallax", "distance",
        "AV"]
TREE = ["eep_0_0", "mass_0_0", "radius_0_0", "Teff_0_0", "logg_0_0", "feh_0_0", "J_mag_0_0", "age_0", "feh_0",
        "distance_0", "AV_0", "J_mag", "lnprob"]
SAMPLES = ["eep", "age", "feh", "distance", "AV", "lnprob"]


def _table(cols, n=500, seed=0):
    """Seeded columns with a few NaN holes (a column of them where asked)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, c in enumerate(cols):
        v = rng.normal(1.0 + i, 0.1 + 0.05 * i, n)
        v[rng.choice(n, 7, replace=False)] = np.nan
        out[c] = v
    return out


def _write_h5(path, samples, derived):
    with h5py.File(path, "w") as f:
        for key, table in (("samples", samples), ("derived_samples", derived)):
            g = f.create_group(key)
            g.create_dataset("values", data=np.stack([table[c] for c in table], axis=1))
            g.attrs["columns"] = json.dumps(list(table))


def _write_npz(path, samples, derived):
    entries = {}
    for key, table in (("samples", samples), ("derived_samples", derived)):
        entries[f"{key}/values"] = np.stack([table[c] for c in table], axis=1)
        entries[f"{key}/columns"] = np.array(json.dumps(list(table)))
    npz_save(path, entries)


@pytest.mark.parametrize("case", ["flat", "tree", "missing"])
def test_results_txt_byte_identical(tmp_path, case):
    cols = {"flat": FLAT, "tree": TREE, "missing": [c for c in FLAT if c not in ("AV", "Teff")]}[case]
    derived, samples = _table(cols, seed=1), _table(SAMPLES, seed=2)
    if case == "missing":
        derived["radius"][:] = np.nan  # a column of NaN: nan nan nan from its quantiles in both
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    _write_h5(str(jdir / "mist_starmodel_binary.h5"), samples, derived)
    _write_npz(str(tdir / "mist_starmodel_binary.npz"), samples, derived)
    jpath = jsum.write_results_txt(str(jdir), mult="binary")
    tpath = tsum.write_results_txt(str(tdir), mult="binary")
    assert os.path.basename(tpath) == os.path.basename(jpath) == "mist_binary_results.txt"
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        text = f.read()
        assert g.read() == text
    assert (b"nan nan nan" in text) == (case == "missing")
    with pytest.raises((IOError, OSError)):
        tsum.write_results_txt(str(tdir), mult="single")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Two fitted folders a package (the same seeded tables in each package's
    results file) and the grids' roots, MIST's empty so that ``load_hdf``
    comes back on the synthetic grids in both."""
    root = tmp_path_factory.mktemp("summaries")
    tic, jic = get_ichrone("synthetic", device="cpu"), jax_get_ichrone("synthetic")
    obs = dict(J=(9.5, 0.02), H=(9.2, 0.02), K=(9.1, 0.02), parallax=(4.0, 0.1))
    for i, name in enumerate(("a", "b")):
        samples, derived = _table(SAMPLES, seed=10 + i), _table(FLAT + ["Mbol"], seed=20 + i)
        for pkg, cls, ic, ext in (("jax", JaxBasicStarModel, jic, "h5"), ("port", BasicStarModel, tic, "npz")):
            folder = root / pkg / name
            folder.mkdir(parents=True)
            m = cls(ic, name=name, directory=str(folder), **obs)
            m._samples = pd.DataFrame(samples) if pkg == "jax" else Frame(samples)
            m._derived_samples = pd.DataFrame(derived) if pkg == "jax" else Frame(derived)
            m._evidence = (-10.0 - i, 0.2)
            m.save_hdf(str(folder / f"synthetic_starmodel_single.{ext}"))
    (root / "empty").mkdir()
    return root


@pytest.fixture()
def no_mist(monkeypatch, folders):
    monkeypatch.setattr(tconfig, "ISOCHRONES", str(folders / "empty"))
    monkeypatch.setattr(jconfig, "ISOCHRONES", str(folders / "empty"))
    monkeypatch.setattr(jconfig, "OFFLINE", True)


def _same_frames(got, ref):
    assert got.columns == list(ref.columns)
    np.testing.assert_array_equal(got._labels(), ref.index.values)
    for c in ref.columns:
        np.testing.assert_allclose(got[c], ref[c].values, rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.parametrize("qs,columns", [(tsum.DEFAULT_QS, tsum.DEFAULT_COLUMNS), ((0.5,), ("mass", "_mag$"))])
def test_get_quantiles_and_summary_df(folders, no_mist, qs, columns, capsys):
    kw = dict(modelname="synthetic_starmodel_single", qs=qs, columns=columns)
    for name in ("a", "b"):
        got = tsum.get_quantiles(name, rootdir=str(folders / "port"), device="cpu", **kw)
        ref = jsum.get_quantiles(name, rootdir=str(folders / "jax"), **kw)
        _same_frames(got, ref)
    names = ["a", "missing", "b"]
    got = tsum.get_summary_df(names, rootdir=str(folders / "port"), device="cpu", verbose=True, **kw)
    ref = jsum.get_summary_df(names, rootdir=str(folders / "jax"), verbose=True, **kw)
    _same_frames(got, ref)
    assert got._labels().tolist() == ["a", "b"]
    assert capsys.readouterr().out.count("cannot load starmodel!") == 2
    empty = tsum.get_quantiles("missing", rootdir=str(folders / "port"), device="cpu", **kw)
    assert isinstance(empty, Frame) and not empty and len(jsum.get_quantiles("missing", **kw)) == 0
    with pytest.raises(IOError):
        tsum.get_quantiles("missing", rootdir=str(folders / "port"), raise_exceptions=True, device="cpu", **kw)
    worker = tsum.quantile_worker(rootdir=str(folders / "port"), device="cpu", **kw)
    _same_frames(worker("a"), jsum.quantile_worker(rootdir=str(folders / "jax"), **kw)("a"))


@pytest.mark.parametrize("name", ["summary.h5", "summary.hdf5", "summary.csv"])
def test_summary_file_names(folders, no_mist, tmp_path, name, capsys):
    kw = dict(modelname="synthetic_starmodel_single")
    tpath, jpath = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    tsum.get_summary_df(["a", "b"], rootdir=str(folders / "port"), filename=tpath, device="cpu", **kw)
    jsum.get_summary_df(["a", "b"], rootdir=str(folders / "jax"), filename=jpath, **kw)
    suffix = "" if name.endswith(".csv") else ".csv"
    with open(tpath + suffix) as f, open(jpath + suffix) as g:
        assert f.read() == g.read()
    out = capsys.readouterr().out
    assert f"Summary dataframe written to {tpath + suffix}" in out and f"written to {jpath + suffix}" in out
