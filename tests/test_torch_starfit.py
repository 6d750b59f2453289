"""The port's ``starfit`` entry point (``isochrones_torch.starfit`` and
``python -m isochrones_torch.cli.starfit``) on the CPU: a copy of
``tests/star1`` in a temporary folder, the default synthetic grid, short
fits. ``starfit`` swallows a folder's errors into ``starfit.log``, so every
test checks the results file and ``failures``, not the return value alone.
"""

import filecmp
import json
import os
import shutil

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.starfit as jsf
import isochrones_torch.starfit as tsf
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.starmodel import BasicStarModel as JaxBasicStarModel
from isochrones_torch import BasicStarModel, get_ichrone
from isochrones_torch.cli.starfit import build_parser, main
from isochrones_torch.samplers.nested import CheckpointConfigError
from isochrones_torch.starfit import starfit
from isochrones_torch.treemodel import StarModel

HERE = os.path.dirname(os.path.abspath(__file__))
#: a short fit: stopped by max_iter (ESS-truncated, which is logged), enough
#: to write a results file
SHORT = dict(n_live_points=60, n_batch=8, n_chains=4, n_repeat=8, max_iter=240, seed=0)
CLI = ["--device", "cpu", "--models", "synthetic", "--no_plots", "--n_live_points", "60", "--max_iter", "240",
       "--seed", "0"]


def _folder(tmp_path, star="star1", name=None):
    dst = tmp_path / (name or star)
    shutil.copytree(os.path.join(HERE, star), dst)
    return str(dst)


def _log(folder):
    with open(os.path.join(folder, "starfit.log")) as f:
        return f.read()


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_starfit_flat_results_file_and_freshness(tmp_path, one_thread):
    folder = _folder(tmp_path)
    failures = []
    mod, _ = starfit(folder, models="synthetic", no_plots=True, device="cpu", failures=failures, **SHORT)
    path = os.path.join(folder, "synthetic_starmodel_single.npz")
    assert failures == [] and os.path.exists(path) and "single starfit successful" in _log(folder)
    assert mod.name == "star1" and mod.directory == folder and sorted(mod.bands) == ["H", "J", "K", "W1", "W2"]
    back = BasicStarModel.load_hdf(path, device="cpu")
    assert back.N == 1 and back.kwargs == mod.kwargs and back.evidence == mod.evidence
    for c in mod.samples:
        np.testing.assert_array_equal(back.samples[c], mod.samples[c])
    assert list(back.derived_samples) == list(mod.derived_samples)

    mtime = os.path.getmtime(path)
    again, _ = starfit(folder, models="synthetic", no_plots=True, device="cpu", failures=failures, **SHORT)
    assert os.path.getmtime(path) == mtime and "exists. Use overwrite to refit." in _log(folder)
    np.testing.assert_array_equal(again.samples["lnprob"], mod.samples["lnprob"])  # the stored fit, loaded
    starfit(folder, models="synthetic", no_plots=True, device="cpu", failures=failures, overwrite=True,
            feh_prior="flat", **{**SHORT, "seed": 1})
    assert os.path.getmtime(path) > mtime and failures == []

    with open(path, "wb") as f:  # a damaged results file is replaced by a new fit
        f.write(b"not a container")
    starfit(folder, models="synthetic", no_plots=True, device="cpu", failures=failures, **SHORT)
    assert failures == [] and BasicStarModel.load_hdf(path, device="cpu").evidence is not None


def test_results_file_keys_match_jax(tmp_path, one_thread):
    """The flat model's container holds the keys and columns of the HDF5 file
    that the JAX package writes for the same model and samples, and restores
    bounds (a non-default ``maxAV``) through ``set_bounds``."""
    tic = get_ichrone("synthetic", device="cpu")
    jic = jax_get_ichrone("synthetic")
    obs = tsf._flat_obs_kwargs(os.path.join(HERE, "star1", "star.ini"))
    obs["maxAV"] = 0.7
    tm = BasicStarModel(tic, N=2, name="s", directory=str(tmp_path), **obs)
    jm = JaxBasicStarModel(jic, N=2, name="s", directory=str(tmp_path), **obs)
    tm.fit_multinest(**{**SHORT, "max_iter": 80})
    jm._samples = pd.DataFrame(tm.samples)
    jm._evidence = tm.evidence
    path, jpath = str(tmp_path / "m.npz"), str(tmp_path / "m.h5")
    tm.save_hdf(path, path="fits/a")
    jm.save_hdf(jpath, path="fits/a")
    with h5py.File(jpath, "r") as f:
        g = f["fits/a"]
        ref = {f"fits/a/attrs/{k}" for k in g.attrs}
        for t in ("samples", "derived_samples"):
            ref |= {f"fits/a/{t}/values", f"fits/a/{t}/columns"}
            assert list(getattr(tm, t)) == json.loads(g[t].attrs["columns"])
            np.testing.assert_allclose(np.asarray(g[t]["values"]), np.load(path)[f"fits/a/{t}/values"], rtol=1e-9, equal_nan=True)
    assert set(np.load(path).files) == ref
    back = BasicStarModel.load_hdf(path, path="fits/a", ic=tic)
    assert back.bounds("AV") == (0, 0.7) and back._priors["AV"].bounds == (0, 0.7) and back.N == 2
    assert back.evidence == tm.evidence and np.isfinite(back.lnpost(tm.map_pars()))
    with pytest.raises(IOError):
        tm.save_hdf(path, path="fits/a")
    tm.save_hdf(path, path="fits/b", append=True)
    assert {"fits/a/samples/values", "fits/b/samples/values"} <= set(np.load(path).files)
    tm.save_hdf(path, path="fits/b", overwrite=True)
    assert "fits/a/samples/values" not in np.load(path).files


def test_cli_flat_tree_and_failures(tmp_path, one_thread, capsys, monkeypatch):
    flat, tree, empty = _folder(tmp_path), _folder(tmp_path, "star3"), str(tmp_path / "empty")
    os.makedirs(empty)
    assert main(CLI + ["--binary", flat]) == 0
    assert main(CLI + ["--tree", tree]) == 0
    m_flat = BasicStarModel.load_hdf(os.path.join(flat, "synthetic_starmodel_binary.npz"), device="cpu")
    m_tree = StarModel.load_hdf(os.path.join(tree, "synthetic_starmodel_single.npz"), device="cpu")
    assert m_flat.N == 2 and m_flat.param_names[:2] == ("eep_0", "eep_1") and len(m_flat.samples["lnprob"]) == 4000
    assert m_tree.labelstring == "0_0--0_1--0_2" and m_tree.n_params == 7 and m_tree.bounds("AV_0") == (0, 0.9)
    assert "delta-K" in capsys.readouterr().out  # the tree is printed before its fit
    for folder in (flat, tree):
        assert "starfit successful" in _log(folder)

    # a folder without a star.ini fails, is logged, and turns the exit code
    assert main(CLI + ["--rootdir", str(tmp_path), "empty", "star1"]) == 1
    assert "single starfit failed" in _log(empty) and "empty [single]" in capsys.readouterr().err
    assert os.path.exists(os.path.join(flat, "synthetic_starmodel_single.npz"))  # the good folder was still fitted
    # the default grid is MIST's: without its files (an empty $ISOCHRONES) the error naming the
    # missing path is a failed fit of that folder
    import isochrones_torch.config as tconfig

    monkeypatch.setattr(tconfig, "ISOCHRONES", str(tmp_path / "no_mist"))
    assert main(["--device", "cpu", "--no_plots", flat]) == 1 and "MIST" in _log(flat)
    assert str(tmp_path / "no_mist") in _log(flat)


def test_cli_parser_and_unported_options(tmp_path, monkeypatch):
    from isochrones_torch.query import Gaia

    folder = _folder(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(CLI + ["--resume", "--emcee", folder])
    assert e.value.code == 2
    args = build_parser().parse_args([])
    assert (args.device, args.dtype, args.models, args.folders) == ("cuda", "float64", "mist", ["."])
    for extra in (["--multihost"], ["--coordinator", "localhost:1234"], ["--num-processes", "2"], ["--process-id", "0"]):
        with pytest.raises(NotImplementedError, match="processes"):
            main(CLI + extra + [folder])
    # the Gaia query and plot_only are ported: an empty Gaia answer, and plot_only without a results
    # file, are the folder's failures, logged before any fit
    monkeypatch.setattr(Gaia, "table_provider", staticmethod(lambda *a: None))
    for extra, msg in ((["--gaia"], "returns empty"), (["--plot_only"], "does not exist")):
        assert main(CLI + extra + [folder]) == 1 and msg in _log(folder)
    failures = []
    for kw in (dict(gaia=True, no_plots=True), dict(plot_only=True, no_plots=False)):
        starfit(folder, models="synthetic", device="cpu", failures=failures, **kw, **SHORT)
    assert failures == [(folder, "single")] * 2 and sorted(os.listdir(folder)) == ["star.ini", "starfit.log"]
    # independent runs are ported: two runs, no dynamic runs with them, no mesh
    mod = BasicStarModel(get_ichrone("synthetic", device="cpu"), J=(9.5, 0.02))
    res = mod.fit(n_runs=2, n_live_points=40, n_batch=4, n_chains=4, n_repeat=8, max_iter=80, seed=0)
    assert res.logz_runs.shape == (2,)
    with pytest.raises(ValueError, match="n_runs=1"):
        mod.fit(n_runs=2, dynamic=True, n_live_points=40)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mod.fit(mesh=object(), n_live_points=40)


def test_entry_points_default_to_the_card(tmp_path):
    """``starfit`` and the CLI build their grids on the card unless asked for
    the CPU; without a card the fit fails (torch's refusal, in the log)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    folder = _folder(tmp_path)
    failures = []
    mod, _ = starfit(folder, models="synthetic", no_plots=True, failures=failures, **SHORT)
    assert mod is None and failures == [(folder, "single")]
    assert not os.path.exists(os.path.join(folder, "synthetic_starmodel_single.npz"))
    assert "starfit failed" in _log(folder) and ("CUDA" in _log(folder) or "cuda" in _log(folder))
    assert main(["--models", "synthetic", "--no_plots", "--n_live_points", "60", folder]) == 1


def test_starfit_resume_bitwise_and_stale_checkpoint(tmp_path, one_thread):
    """A fit stopped after one chunk (its results file lost, as a killed fit
    writes none) and resumed gives bitwise the uninterrupted fit; a resume
    against an edited star.ini is re-raised, not logged and skipped."""
    kw = dict(models="synthetic", no_plots=True, device="cpu", multiplicities=("binary",))
    fit = {k: v for k, v in SHORT.items() if k != "max_iter"}
    whole, stopped = _folder(tmp_path, name="whole"), _folder(tmp_path, name="stopped")
    ref, _ = starfit(whole, **kw, **fit)
    part, _ = starfit(stopped, **kw, resume=True, max_iter=256, **fit)
    path = os.path.join(stopped, "synthetic_starmodel_binary.npz")
    assert os.path.exists(os.path.join(stopped, "chains", "stopped-iso-binary-checkpoint.pkl"))
    assert not os.path.exists(os.path.join(whole, "chains"))
    assert not np.array_equal(part.samples["lnprob"], ref.samples["lnprob"])
    os.remove(path)
    resumed, _ = starfit(stopped, **kw, resume=True, **fit)
    for c in ref.samples:
        np.testing.assert_array_equal(resumed.samples[c], ref.samples[c])
    assert resumed.evidence == ref.evidence
    stored = BasicStarModel.load_hdf(path, device="cpu")
    np.testing.assert_array_equal(stored.samples["lnprob"], ref.samples["lnprob"])

    os.remove(path)
    ini = os.path.join(stopped, "star.ini")
    with open(ini) as f:
        text = f.read()
    with open(ini, "w") as f:
        f.write(text.replace("J = 9.513", "J = 9.613"))
    failures = []
    with pytest.raises(CheckpointConfigError):
        starfit(stopped, **kw, resume=True, failures=failures, **fit)
    assert failures == [(stopped, "binary")] and not os.path.exists(path)


def test_starfit_emcee_and_tree_type(tmp_path, one_thread):
    folder = _folder(tmp_path, "star2")
    failures = []
    mod, _ = starfit(folder, models="synthetic", no_plots=True, device="cpu", use_emcee=True, failures=failures,
                     starmodel_type=StarModel, nwalkers=24, nburn=4, niter=5, seed=0, bands=["G"])
    assert failures == [] and isinstance(mod, StarModel) and mod.use_emcee
    assert len(mod.samples["lnprob"]) == 24 * 5 and "G" in mod.ic.bands
    back = StarModel.load_hdf(os.path.join(folder, "synthetic_starmodel_single.npz"), device="cpu")
    assert back.use_emcee and back.evidence is None and back.labelstring == mod.labelstring


def test_host_helpers_match_jax(tmp_path):
    listfile = tmp_path / "stars.list"
    listfile.write_text("a\nb\nc\nd\ne\n")
    t = tsf.batch_starfit_script(str(listfile), nsplit=2, extra=("--binary",))
    with open(t) as f:
        text = f.read()
    os.remove(t)
    j = jsf.batch_starfit_script(str(listfile), nsplit=2, extra=("--binary",))
    with open(j) as f:
        assert text == f.read().replace("xargs starfit ", "xargs starfit-torch ")
    a, b = _folder(tmp_path, "star3", "a"), _folder(tmp_path, "star3", "b")
    data = {"parallax": (4.2, 0.1), "G": (11.0, 0.01), "BP": (11.4, 0.02)}
    tsf.update_ini_with_gaia(os.path.join(a, "star.ini"), data)
    jsf.update_ini_with_gaia(os.path.join(b, "star.ini"), data)
    assert filecmp.cmp(os.path.join(a, "star.ini"), os.path.join(b, "star.ini"), shallow=False)
    ini = os.path.join(a, "star.ini")
    assert sorted(tsf._ini_native_bands(ini)) == sorted(jsf._ini_native_bands(ini)) == ["H", "J", "K"]
    assert tsf._ini_radec(ini) == jsf._ini_radec(ini) == (45.0, 5.0)
    bare = tmp_path / "bare.ini"
    bare.write_text("Teff = 5800, 100\n")
    with pytest.raises(ValueError, match="RA/dec"):
        tsf._ini_radec(str(bare))
