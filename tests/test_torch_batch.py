"""Whole-catalog fitting in the port (``isochrones_torch.batch``,
``summary``, ``cli/fit_catalog``, ``cli/batch``) against the JAX package on
the CPU, float64, small synthetic grid.

The catalog posterior is deterministic: ``lnpost_batch`` equals the JAX
``BatchStarFitter.lnpost_batch`` to 1e-10 with identical NaN and -inf
patterns, on the fixture of ``tests/test_batch.py`` plus three stars with a
NaN band, a NaN parallax and no Teff. The samplers draw other random numbers
than the JAX package's, so the fits are held to shapes, finiteness and the
truths; the summary, given the same draws, equals the JAX summary.
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.batch import BatchStarFitter as JaxBatchStarFitter
from isochrones_tpu.catalog import StarCatalog as JaxStarCatalog
from isochrones_tpu.starfit import batch_starfit_script as jax_batch_starfit_script
from isochrones_tpu.summary import quantile_frame as jax_quantile_frame
from isochrones_tpu.summary import summarize_batch as jax_summarize_batch
from isochrones_torch import SingleStarModel, StarCatalog, get_ichrone
from isochrones_torch.batch import BatchStarFitter, fit_catalog
from isochrones_torch.cli.batch import main as batch_main
from isochrones_torch.cli.fit_catalog import main as fit_catalog_main
from isochrones_torch.ops.catalog import catalog_lnlike, catalog_lnlike_plain
from isochrones_torch.ops.star import star_lnlike_fused_plain
from isochrones_torch.samplers.ensemble import run_ensemble_batch
from isochrones_torch.summary import Frame, quantile_frame, summarize_batch

BANDS = ("J", "H", "K")
SMALL = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
PARAMS = ("eep", "age", "feh", "distance", "AV")
#: the truths of tests/test_batch.py, then three stars for the holes
TRUTHS = pd.DataFrame({
    "eep": [40.0, 55.0, 70.0, 60.0, 50.0, 65.0, 45.0, 52.0, 58.0],
    "age": [8.6, 9.0, 9.3, 8.8, 9.1, 8.7, 9.0, 8.9, 9.2],
    "feh": [-0.3, 0.0, 0.2, -0.1, 0.1, -0.2, 0.0, 0.1, -0.1],
    "distance": [150.0, 200.0, 300.0, 250.0, 180.0, 220.0, 190.0, 210.0, 230.0],
    "AV": [0.05, 0.1, 0.2, 0.15, 0.08, 0.12, 0.1, 0.1, 0.1],
})


def _table(iso, truths, seed=0):
    """The fixture of tests/test_batch.py on ``truths``; star 6 lacks H, star
    7 its parallax, star 8 its Teff."""
    rng = np.random.default_rng(seed)
    S = len(truths)
    Teff, logg, _, mags = iso.interp_mag([truths[c].values for c in PARAMS], list(BANDS))
    rows = {}
    for i, b in enumerate(BANDS):
        rows[f"{b}_mag"] = np.asarray(mags)[:, i] + rng.normal(0, 0.02, S)
        rows[f"{b}_mag_unc"] = np.full(S, 0.02)
    rows["Teff"] = np.asarray(Teff) + rng.normal(0, 50, S)
    rows["Teff_unc"] = np.full(S, 80.0)
    rows["logg"] = np.asarray(logg) + rng.normal(0, 0.03, S)
    rows["logg_unc"] = np.full(S, 0.05)
    rows["parallax"] = 1000.0 / truths.distance.values
    rows["parallax_unc"] = np.full(S, 0.05)
    if S > 8:
        rows["H_mag"][6] = np.nan
        rows["parallax"][7] = np.nan
        rows["Teff"][8] = np.nan
    return pd.DataFrame(rows)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the small tensors of these tests run several times
    faster than with a pool of threads, and the test workers share the
    host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jiso = jax_get_ichrone("synthetic", **SMALL)
    tiso = get_ichrone("synthetic", device="cpu", **SMALL)
    df = _table(jiso, TRUTHS)
    jf = JaxBatchStarFitter(jiso, JaxStarCatalog(df, bands=BANDS, props=("Teff", "logg", "parallax")))
    tf = BatchStarFitter(tiso, StarCatalog({c: df[c].values for c in df}, bands=BANDS), bands=BANDS)
    return jiso, tiso, df, jf, tf


def _points(S, B, seed):
    """Truths, points about them, points over and past the grid, NaN rows."""
    rng = np.random.default_rng(seed)
    truth = np.stack([TRUTHS[c].values for c in PARAMS], axis=-1)[:, None, :]
    p = np.repeat(truth, B, axis=1) + rng.normal(0, [5.0, 0.1, 0.1, 20.0, 0.05], (S, B, 5))
    p[:, 0] = truth[:, 0]
    p[:, 1:5] = rng.uniform([1, 5, -2, -10, -0.1], [120, 10.5, 0.6, 3000, 1.2], (S, 4, 5))
    p[:, 5, 2] = np.nan
    p[:, 6, 0] = 200.0  # EEP past the grid
    p[:, 7, 3] = 0.0  # distance on the bound
    p[:, 8, 4] = 2.0  # AV past the prior
    return p


def _assert_same(got, ref, atol):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    for f in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(f(got), f(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=atol)


def test_lnpost_batch_matches_jax(setup):
    _, _, _, jf, tf = setup
    pars = _points(9, 48, seed=1)
    ref = np.asarray(jf.lnpost_batch(jnp.asarray(pars)))
    got = tf.lnpost_batch(pars).numpy()
    _assert_same(got, ref, atol=1e-10)
    assert np.isfinite(ref).sum() > 200 and np.isneginf(ref).sum() > 50
    assert np.isfinite(got[:, 0]).all()  # every truth, the stars with holes included


def test_fitter_members_match_jax(setup):
    _, _, _, jf, tf = setup
    for a, b in zip(tf._bounds_arrays(), jf._bounds_arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf.max_distance, jf.max_distance)
    for k, v in jf.star_data.items():
        ref = np.asarray(v).reshape(9, -1) if v is not None else None
        got = tf.star_data[k]
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy().reshape(9, -1), ref)
    assert tf.eep_bounds == jf.eep_bounds and tf.param_names == jf.param_names
    for k in ("mass", "age", "feh", "AV", "eep"):
        assert tuple(tf.priors[k].bounds) == tuple(jf.priors[k].bounds)
    assert tf.device == torch.device("cpu") and tf.dtype == torch.float64


def test_plain_catalog_matches_single_star(setup):
    """Row i of the plain catalog likelihood is the single-star fused
    likelihood of star i, NaN observations skipped as missing ones."""
    _, tiso, df, _, tf = setup
    lk = tf._catalog_likelihood()
    pars = torch.as_tensor(_points(9, 32, seed=2))
    ll, orig, deriv = catalog_lnlike_plain(pars, lk)
    for i in range(9):
        obs = {b: (df[f"{b}_mag"][i], 0.02) for b in BANDS}
        obs.update(Teff=(df.Teff[i], 80.0), logg=(df.logg[i], 0.05), parallax=(df.parallax[i], 0.05))
        ref = star_lnlike_fused_plain(pars[i], SingleStarModel(tiso, **obs)._star_likelihood())
        for got, want in zip((ll[i], orig[i], deriv[i]), (ref[0], ref[1][:, 0], ref[2][:, 0])):
            _assert_same(got.numpy(), want.numpy(), atol=1e-12)
    # the dispatcher sends CPU tensors to the plain version, and no other device
    for a, b in zip(catalog_lnlike(pars, lk), (ll, orig, deriv)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="cpu or cuda"):
        catalog_lnlike(pars.to("meta"), lk)


def test_fitter_refusals(setup):
    jiso, tiso, df, _, tf = setup
    with pytest.raises(ValueError, match="isochrone"):
        BatchStarFitter(tiso.track, tf.catalog)
    for call in (lambda: tf.fit_mcmc(nwalkers=8, nburn=1, niter=1, mesh=object()),
                 lambda: tf.fit_multinest(n_live_points=16, mesh=object())):
        with pytest.raises(NotImplementedError, match="parallelism"):
            call()
    with pytest.raises(AttributeError):
        BatchStarFitter(tiso, tf.catalog).samples
    with pytest.raises(AttributeError):
        BatchStarFitter(tiso, tf.catalog).evidence


def test_catalog_accepts_itself_and_an_index():
    cols = {"J_mag": np.array([9.0, 9.5]), "J_mag_unc": np.array([0.02, 0.02]), "Teff": np.array([5800.0, 5700.0]),
            "Teff_unc": np.array([100.0, 100.0])}
    cat = StarCatalog(cols)
    again = StarCatalog(cat)
    assert (again.bands, again.props, len(again)) == (("J",), ("Teff",), 2)
    np.testing.assert_array_equal(again.index, [0, 1])
    np.testing.assert_array_equal(StarCatalog(dict(cols, index=np.array([7.0, 3.0]))).index, [7.0, 3.0])


def test_run_ensemble_batch_recovers_gaussians():
    """Three independent 2-d Gaussians in lockstep: each ensemble's chain has
    its problem's mean and standard deviation."""
    mu = torch.tensor([[0.0, 1.0], [5.0, -2.0], [-3.0, 0.5]], dtype=torch.float64)
    sig = torch.tensor([[1.0, 0.5], [0.2, 2.0], [1.5, 1.5]], dtype=torch.float64)

    def lnpost(x):  # (S, n, 2) -> (S, n)
        return -0.5 * (((x - mu[:, None]) / sig[:, None]) ** 2).sum(-1)

    g = torch.Generator()
    g.manual_seed(0)
    rng = np.random.default_rng(0)
    p0 = mu[:, None] + sig[:, None] * torch.as_tensor(rng.normal(size=(3, 32, 2)))
    _, _, state = run_ensemble_batch(lnpost, p0, g, n_steps=200)
    chain, ln_chain, state = run_ensemble_batch(lnpost, state.walkers, g, n_steps=2000, thin=2)
    assert chain.shape == (1000, 3, 32, 2) and ln_chain.shape == (1000, 3, 32)
    assert state.n_accept.shape == (3, 32) and (state.n_accept > 0).all()
    np.testing.assert_array_equal(ln_chain[-1].numpy(), lnpost(chain[-1]).numpy())
    flat = chain.permute(1, 0, 2, 3).reshape(3, -1, 2).numpy()
    np.testing.assert_allclose(flat.mean(1), mu.numpy(), atol=0.1 * sig.numpy().max())
    np.testing.assert_allclose(flat.std(1), sig.numpy(), rtol=0.1)
    # n_steps // thin states are kept, as in the JAX package
    assert run_ensemble_batch(lnpost, p0, g, n_steps=5, thin=2)[0].shape == (2, 3, 32, 2)


def test_fit_catalog_mcmc_and_nested(setup):
    """Both engines on the fixture: shapes, finite results, evidences, and
    the true distance of most stars inside the 95% interval."""
    _, tiso, _, _, tf = setup
    fitter, summary = fit_catalog(tiso, tf.catalog, method="mcmc", nwalkers=16, nburn=100, niter=20, seed=1,
                                  derived=False, bands=BANDS)
    assert fitter.samples.shape == (9, 320, 5) and np.isfinite(fitter._lnprob).all()
    assert list(summary) == [f"{p}_{q}" for p in PARAMS for q in ("16", "50", "84")]
    assert "logz" not in summary
    assert list(fitter.summary()) == list(summary)

    p0 = tf.sample_p0(8, rng=3)
    assert p0.shape == (9, 8, 5) and np.isfinite(tf.lnpost_batch(p0).numpy()).all()

    out = tf.fit_multinest(n_live_points=48, n_batch=8, n_chains=4, n_repeat=8, seed=2)
    assert set(out) == {"logz", "logzerr", "ess", "n_dead", "converged", "dynamic_rounds"}
    assert np.isfinite(out["logz"]).all() and out["converged"].all()
    assert tf.samples.shape == (9, 2000, 5) and tf.evidence[0] is out["logz"]
    lo, hi = np.quantile(tf.samples[:, :, 3], [0.025, 0.975], axis=1)
    assert np.mean((lo <= TRUTHS.distance.values) & (TRUTHS.distance.values <= hi)) >= 7 / 9
    summ = summarize_batch(tf, qs=(0.16, 0.5, 0.84), derived=False)
    np.testing.assert_array_equal(summ["logz"], out["logz"])
    dyn = tf.fit_multinest(n_live_points=48, n_batch=8, n_chains=4, n_repeat=8, seed=2, dynamic=True,
                           min_ess=400.0, max_dynamic_rounds=1)
    assert dyn["dynamic_rounds"] == 1 and np.isfinite(dyn["logz"]).all()
    assert np.all(np.abs(dyn["logz"] - out["logz"]) < 3 * np.hypot(dyn["logzerr"], out["logzerr"]))


def _with_draws(tf, jf, seed=4):
    """The same seeded draws (and evidences) in both fitters; star 2 has no
    posterior support (NaN draws)."""
    rng = np.random.default_rng(seed)
    truth = np.stack([TRUTHS[c].values for c in PARAMS], axis=-1)
    draws = truth[:, None, :] + rng.normal(0, [2.0, 0.05, 0.05, 5.0, 0.02], (9, 300, 5))
    draws[..., 4] = np.abs(draws[..., 4])
    draws[2] = np.nan
    logz, logzerr = rng.normal(-40, 3, 9), rng.uniform(0.1, 0.3, 9)
    for f in (tf, jf):
        f._samples = draws.copy()
        f._evidence = (logz, logzerr)
    return draws


def test_summary_matches_jax(setup, tmp_path):
    _, _, _, jf, tf = setup
    draws = _with_draws(tf, jf)
    got = quantile_frame(draws, list(PARAMS))
    ref = jax_quantile_frame(draws, list(PARAMS))
    assert list(got) == list(ref.columns)
    for c in ref.columns:
        np.testing.assert_array_equal(got[c], ref[c].values)
    got = summarize_batch(tf, max_derived_draws=200)
    ref = jax_summarize_batch(jf, max_derived_draws=200)
    assert list(got) == list(ref.columns)
    np.testing.assert_array_equal(got.index, ref.index.values)
    for c in ref.columns:
        _assert_same(got[c], ref[c].values, atol=1e-9)
    assert np.isnan(got["mass_50"][2]) and np.isfinite(np.delete(got["mass_50"], 2)).all()

    # the CSV is DataFrame.to_csv's, character for character
    path = str(tmp_path / "summary.csv")
    summarize_batch(tf, max_derived_draws=200, filename=path)
    with open(path) as f:
        text = f.read()
    assert text == pd.DataFrame(dict(got), index=got.index).to_csv()
    assert text.splitlines()[0] == ref.to_csv().splitlines()[0]
    # an HDF5 name is written as CSV to <name>.csv in both packages (no PyTables here, none on the card)
    summarize_batch(tf, derived=False, filename=str(tmp_path / "summary.h5"))
    jax_summarize_batch(jf, derived=False, filename=str(tmp_path / "jax_summary.h5"))
    with open(tmp_path / "summary.h5.csv") as f, open(tmp_path / "jax_summary.h5.csv") as g:
        assert f.read() == g.read()


def test_frame_csv_layout(tmp_path):
    fr = Frame({"a_16": np.array([0.1, np.nan, 1e-5]), "b": np.array([1.0, 2.0, 1e20])}, index=np.array([3.0, 4, 5]))
    fr.to_csv(str(tmp_path / "f.csv"))
    with open(tmp_path / "f.csv") as f:
        assert f.read() == pd.DataFrame(dict(fr), index=fr.index).to_csv()
    assert fr.columns == ["a_16", "b"]


def _csv(path, df):
    df.to_csv(path, index=False)
    return str(path)


def test_fit_catalog_cli_writes_the_jax_summary_layout(tmp_path, capsys):
    """``fit-catalog-torch --device cpu`` on a CSV: the summary's header is the
    JAX package's ``to_csv`` header for the same catalog."""
    jiso = jax_get_ichrone("synthetic")  # the CLI's grid
    truths = pd.DataFrame({"eep": [40.0, 48.0, 35.0], "age": [9.0, 9.2, 8.8], "feh": [0.0, -0.1, 0.1],
                           "distance": [150.0, 300.0, 220.0], "AV": [0.1, 0.05, 0.2]})
    df = _table(jiso, truths, seed=5)
    path = _csv(tmp_path / "cat.csv", df)
    out = str(tmp_path / "fit.csv")
    rc = fit_catalog_main(["--device", "cpu", "--models", "synthetic", "--method", "mcmc", "--nwalkers", "8",
                           "--nburn", "20", "--niter", "5", "--seed", "0", path, "-O", out])
    assert rc == 0 and "3 stars fitted" in capsys.readouterr().out
    written = pd.read_csv(out, index_col=0)
    assert len(written) == 3 and np.isfinite(written["distance_50"].values).all()

    jf = JaxBatchStarFitter(jiso, JaxStarCatalog(pd.read_csv(path)))
    jf._samples = np.repeat(np.stack([truths[c].values for c in PARAMS], -1)[:, None], 4, axis=1)
    ref = jax_summarize_batch(jf, qs=(0.16, 0.5, 0.84))
    with open(out) as f:
        assert f.readline() == ref.to_csv().splitlines(keepends=True)[0]

    for extra in (["--multihost"], ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
                  ["--process-id", "0"]):
        with pytest.raises(NotImplementedError, match="parallelism"):
            fit_catalog_main(["--device", "cpu", "--models", "synthetic"] + extra + [path])
    with pytest.raises(NotImplementedError, match="CSV"):
        fit_catalog_main(["--device", "cpu", "--models", "synthetic", str(tmp_path / "cat.h5")])


def test_batch_starfit_cli_writes_the_script(tmp_path, monkeypatch):
    """``batch-starfit-torch`` writes the JAX package's SLURM script with
    ``starfit-torch`` in the place of ``starfit``; ``--no_submit`` skips
    ``sbatch``, which the test never calls."""
    listfile = tmp_path / "folders.txt"
    listfile.write_text("".join(f"star{i}\n" for i in range(45)))
    extra = ["--models", "synthetic", "--device", "cuda"]
    ref_path = jax_batch_starfit_script(str(listfile), nsplit=30, ntasks_per_node=20, minutes_per_fit=7.0,
                                        extra=extra)
    with open(ref_path) as f:
        ref = f.read()
    os.remove(ref_path)
    calls = []
    monkeypatch.setattr("subprocess.call", lambda *a, **k: calls.append(a) or 0)
    # the options go before the list file: everything after it is handed on
    assert batch_main(["-n", "30", "-t", "7", "--no_submit", str(listfile)] + extra) == 0
    with open(ref_path) as f:
        got = f.read()
    assert got == ref.replace("| xargs starfit ", "| xargs starfit-torch ") and "#SBATCH -N 2" in got
    assert calls == []
    assert batch_main([str(listfile)]) == 0
    assert calls == [(["sbatch", ref_path],)]


def test_entry_points_default_to_the_card(setup, tmp_path):
    """Given a grid name, the fitter, ``fit_catalog`` and the CLI build on the
    card; without one they raise (torch's refusal) instead of running on the
    CPU. ``device="cpu"`` runs here."""
    _, _, df, _, tf = setup
    cat = tf.catalog
    assert BatchStarFitter("synthetic", cat, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    path = _csv(tmp_path / "cat.csv", df)
    for call in (lambda: BatchStarFitter("synthetic", cat), lambda: fit_catalog("synthetic", cat),
                 lambda: fit_catalog_main(["--models", "synthetic", path])):
        with pytest.raises((RuntimeError, AssertionError)):  # torch's own refusal, by build
            call()
