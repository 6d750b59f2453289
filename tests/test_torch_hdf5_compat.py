"""The port's HDF5 files against the JAX package's, both ways, on the CPU:

- the same draws saved by each package's ``save_hdf`` (flat binary model,
  resolved tree model): the JAX ``BasicStarModel.load_hdf``,
  ``StarModel.load_hdf`` and ``ObservationTree.load_hdf`` read the port's
  files, the port's read the JAX package's, with equal samples, derived
  samples, attributes and photometry records;
- ``summary.write_results_txt`` of either package on either's file: the
  same bytes;
- the MCMC checkpoint: the JAX ``McmcBackend`` reads the port's, and the
  port's ``fit_mcmc_convergent`` resumes one the JAX backend wrote;
- the ``fit-catalog`` CLI on a pandas HDF table (``fixed`` and ``table``)
  writes the bytes it writes from the table's CSV;
- a results file in the port's earlier ``.npz`` container still loads.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_tpu.summary as jsum
import isochrones_torch.starfit as tsf
import isochrones_torch.summary as tsum
import pandas_hdf
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.fit import McmcBackend as JaxMcmcBackend
from isochrones_tpu.observation import ObservationTree as JaxObservationTree
from isochrones_tpu.starmodel import BasicStarModel as JaxBasicStarModel
from isochrones_tpu.treemodel import StarModel as JaxStarModel
from isochrones_torch import BasicStarModel, get_ichrone
from isochrones_torch.fit import McmcBackend, fit_mcmc_convergent
from isochrones_torch.observation import ObservationTree
from isochrones_torch.summary import Frame
from isochrones_torch.treemodel import StarModel

HERE = os.path.dirname(os.path.abspath(__file__))
DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _draws(names, n=200, seed=0):
    rng = np.random.default_rng(seed)
    return {c: rng.uniform(1.0, 2.0, n) for c in names}


def _give(tm, jm, samples, derived, evidence=(-12.5, 0.25)):
    tm._samples, tm._derived_samples = Frame(samples), Frame(derived)
    jm._samples, jm._derived_samples = pd.DataFrame(samples), pd.DataFrame(derived)
    tm._evidence = jm._evidence = evidence


def _same_tables(port, jax_frame):
    assert list(port) == list(jax_frame.columns)
    for c in port:
        np.testing.assert_array_equal(port[c], jax_frame[c].values)


def _models(ics, kind):
    jic, tic = ics
    if kind == "binary":
        obs = tsf._flat_obs_kwargs(os.path.join(HERE, "star1", "star.ini"))
        obs["maxAV"] = 0.7
        tm, jm = (cls(ic, N=2, name="s", directory="d", **obs) for cls, ic in ((BasicStarModel, tic),
                                                                                (JaxBasicStarModel, jic)))
    else:
        path = os.path.join(HERE, "star4")
        tm, jm = StarModel.from_ini(tic, path, index=[0, 0, 1]), JaxStarModel.from_ini(jic, path, index=[0, 0, 1])
    names = list(tm.param_names) + ["lnprob"]
    _give(tm, jm, _draws(names), _draws(["mass", "radius", "Teff", "J_mag", "lnprob"], seed=1))
    return tm, jm


@pytest.mark.parametrize("kind", ["binary", "tree"])
def test_results_files_read_both_ways(ics, tmp_path, kind):
    jic, tic = ics
    tm, jm = _models(ics, kind)
    tpath, jpath = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    tm.save_hdf(tpath, path="fits/a")
    jm.save_hdf(jpath, path="fits/a")
    jcls, tcls = (JaxBasicStarModel, BasicStarModel) if kind == "binary" else (JaxStarModel, StarModel)
    j_of_port = jcls.load_hdf(tpath, path="fits/a", ic=jic)
    t_of_jax = tcls.load_hdf(jpath, path="fits/a", ic=tic)
    for name in ("samples", "derived_samples"):
        _same_tables(getattr(t_of_jax, name), getattr(jm, name))
        _same_tables(getattr(tm, name), getattr(j_of_port, name))
    for a, b in ((j_of_port, tm), (t_of_jax, jm)):
        assert a.name == b.name and a.use_emcee == b.use_emcee and tuple(a.param_names) == tuple(b.param_names)
        assert type(a.ic).__name__ == type(b.ic).__name__ and list(a.ic.bands) == list(b.ic.bands)
    if kind == "binary":
        for a, b in ((j_of_port, tm), (t_of_jax, jm)):
            assert a.N == b.N == 2 and a.kwargs == b.kwargs and tuple(a.evidence) == tuple(b.evidence)
            assert a.bounds("AV") == b.bounds("AV") == (0, 0.7) and a.eep_bounds == b.eep_bounds
        return
    # the trees: the photometry records and the attachments, through either ObservationTree
    assert t_of_jax.obs.to_df() == tm.obs.to_df() and list(tm.obs._N) == list(t_of_jax.obs._N)
    pd.testing.assert_frame_equal(j_of_port.obs.to_df(), jm.obs.to_df())
    for tree_cls, path, ic in ((JaxObservationTree, tpath, jic), (ObservationTree, jpath, tic)):
        back = tree_cls.load_hdf(path, path="fits/a", ic=ic)
        rows = back.to_df()
        rows = rows.to_dict("records") if hasattr(rows, "to_dict") else rows
        assert rows == tm.obs.to_df()
        assert back.limits == tm.obs.limits and back.parallax == tm.obs.parallax and back.AV == tm.obs.AV
        assert back.spectroscopy == tm.obs.spectroscopy


def test_results_txt_either_way(ics, tmp_path):
    tm, jm = _models(ics, "binary")
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    tm.save_hdf(str(port / "mist_starmodel_binary.h5"))
    jm.save_hdf(str(jax / "mist_starmodel_binary.h5"))
    texts = []
    for fn, folder in ((tsum.write_results_txt, jax), (jsum.write_results_txt, port), (tsum.write_results_txt, port),
                       (jsum.write_results_txt, jax)):
        with open(fn(str(folder), mult="binary"), "rb") as f:
            texts.append(f.read())
    assert texts[0] == texts[1] == texts[2] == texts[3] and b"mass" in texts[0]


def test_mcmc_checkpoint_both_ways(ics, tmp_path):
    from isochrones_torch.starmodel import SingleStarModel

    tic = ics[1]
    Teff, logg, _, mags = tic.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
    model = SingleStarModel(tic, Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), J=(float(mags[0]), 0.02),
                            parallax=(5.0, 0.05), name="ck")
    kw = dict(nwalkers=16, iter_chunksize=10, targetn=1e9, nsamples=100, seed=0,
              resultsdir=str(tmp_path / "results"))
    fit_mcmc_convergent(model, maxiter=1, sample_directory=str(tmp_path / "port"), **kw)
    ported = str(tmp_path / "port" / "ck.h5")
    chain, ln = JaxMcmcBackend(ported).load()  # the JAX backend reads the port's checkpoint
    np.testing.assert_array_equal(chain, McmcBackend(ported).load()[0])
    np.testing.assert_array_equal(ln, McmcBackend(ported).load()[1])
    JaxMcmcBackend(str(tmp_path / "jax" / "ck.h5")).save(chain, ln, model.param_names)
    fit_mcmc_convergent(model, maxiter=1, sample_directory=str(tmp_path / "jax"), **kw)  # resumes the JAX one
    chain2, ln2 = McmcBackend(str(tmp_path / "jax" / "ck.h5")).load()
    assert chain2.shape[0] == 2 * chain.shape[0]
    np.testing.assert_array_equal(chain2[:len(chain)], chain)
    np.testing.assert_array_equal(ln2[:len(ln)], ln)
    # and the port's own resume of its own checkpoint draws what the JAX-written one did
    fit_mcmc_convergent(model, maxiter=1, sample_directory=str(tmp_path / "port"), **kw)
    np.testing.assert_array_equal(McmcBackend(ported).load()[0], chain2)


@pytest.mark.parametrize("layout", ["fixed", "table_deflate"])
def test_fit_catalog_hdf_table_bitwise_csv(tmp_path, layout, capsys):
    from isochrones_torch.cli.fit_catalog import main

    rng = np.random.default_rng(4)
    n = 5
    cols = {"J_mag": rng.uniform(9.0, 10.0, n), "J_mag_unc": np.full(n, 0.02), "K_mag": rng.uniform(8.5, 9.5, n),
            "K_mag_unc": np.full(n, 0.02), "parallax": rng.uniform(3.0, 6.0, n), "parallax_unc": np.full(n, 0.05)}
    cols["K_mag"][1] = np.nan
    csv_path, h5 = str(tmp_path / "cat.csv"), str(tmp_path / "cat.h5")
    pd.DataFrame(cols).to_csv(csv_path, index=False)
    if layout == "fixed":
        pandas_hdf.write_fixed(h5, cols)
    else:
        pandas_hdf.write_table(h5, cols, complevel=5)
    args = ["--device", "cpu", "--models", "synthetic", "--method", "mcmc", "--nwalkers", "8", "--nburn", "3",
            "--niter", "3", "--seed", "0"]
    outs = []
    for path in (csv_path, h5):
        assert main(args + [path, "-O", path + ".fit.csv"]) == 0
        with open(path + ".fit.csv", "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and "5 stars fitted" in capsys.readouterr().out


def _legacy_npz(model, path, tree=False):
    """The ``.npz`` container the port wrote before it wrote HDF5: every
    array under its HDF5 path, every attribute a JSON string."""
    entries = {}
    for key in ("samples", "derived_samples"):
        table = getattr(model, key)
        entries[f"{key}/values"] = np.stack([np.asarray(table[c], dtype=float) for c in table], axis=1)
        entries[f"{key}/columns"] = np.array(json.dumps(list(table)))
    attrs = dict(ic_type=type(model.ic).__name__, ic_bands=list(model.ic.bands), use_emcee=False, name=model.name,
                 directory=".", bounds={k: list(v) if v is not None else None for k, v in model._bounds.items()},
                 evidence=list(model.evidence))
    if tree:
        rows = model.obs.to_df()
        dt = [("name", "U32"), ("band", "U16"), ("resolution", "f8"), ("mag", "f8"), ("e_mag", "f8"),
              ("separation", "f8"), ("pa", "f8"), ("relative", "?")]
        entries["obs/values"] = np.array([tuple(r[c] for c, _ in dt) for r in rows], dtype=dt)
        obs = dict(spectroscopy=model.obs.spectroscopy, parallax={str(k): list(v) for k, v in model.obs.parallax.items()},
                   AV={str(k): list(v) for k, v in model.obs.AV.items()}, N=np.atleast_1d(model.obs._N).tolist(),
                   index=np.asarray(model.obs._index).tolist(),
                   limits={l: {k: [None if not np.isfinite(x) else x for x in v] for k, v in d.items()}
                           for l, d in model.obs.limits.items()})
        entries.update({f"obs/attrs/{k}": np.array(json.dumps(v)) for k, v in obs.items()})
    else:
        attrs.update(kwargs={k: [float(v), float(u)] for k, (v, u) in model.kwargs.items()}, N=model.N,
                     eep_bounds=list(model.eep_bounds))
    entries.update({f"attrs/{k}": np.array(json.dumps(v)) for k, v in attrs.items()})
    with open(path, "wb") as f:
        np.savez(f, **entries)


@pytest.mark.parametrize("kind", ["binary", "tree"])
def test_earlier_npz_container_loads(ics, tmp_path, kind):
    tm, _ = _models(ics, kind)
    path = str(tmp_path / "old.npz")
    _legacy_npz(tm, path, tree=kind == "tree")
    cls = BasicStarModel if kind == "binary" else StarModel
    back = cls.load_hdf(path, ic=ics[1])
    for name in ("samples", "derived_samples"):
        a, b = getattr(back, name), getattr(tm, name)
        assert list(a) == list(b) and all(np.array_equal(a[c], b[c]) for c in a)
    assert back.evidence == tuple(tm.evidence) and back.name == tm.name and back.bounds("AV") == tm.bounds("AV")
    if kind == "tree":
        assert back.obs.to_df() == [dict(r, resolution=float(r["resolution"])) for r in tm.obs.to_df()]
    else:
        assert back.N == 2 and back.kwargs == tm.kwargs
    with open(path, "wb") as f:  # neither HDF5 nor the container: refused
        f.write(b"not a results file")
    with pytest.raises(ValueError, match="neither an HDF5 file"):
        cls.load_hdf(path, ic=ics[1])
