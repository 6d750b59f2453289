"""The port's corner plots against the JAX package's on Agg: ``plotting.corner``
on the same ``(N, D)`` table, the star models' ``corner_physical``,
``corner_observed``, ``corner(query=...)`` and ``write_results`` on models
whose samples are set from the same table, and ``StarCatalog.hr_plot``. The
histograms' heights and the 2-d histograms' counts must be equal; limits,
truths and quantile lines to 1e-12; labels equal. Then, in a process with
matplotlib, pandas, h5py and astroquery hidden: the port imports, and
``starfit`` with plots keeps the fit and logs the plots' failure."""

import json
import os
import shutil
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from isochrones_tpu import get_ichrone as jax_get_ichrone  # noqa: E402
from isochrones_tpu.catalog import StarCatalog as JaxStarCatalog  # noqa: E402
from isochrones_tpu.plotting import corner as jax_corner  # noqa: E402
from isochrones_tpu.starmodel import BasicStarModel as JaxBasicStarModel  # noqa: E402
from isochrones_torch import BasicStarModel, StarCatalog, get_ichrone  # noqa: E402
from isochrones_torch.plotting import corner  # noqa: E402
from isochrones_torch.summary import Frame  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _geometry(fig):
    """Every axes' visibility, limits, labels, line coordinates, patch
    vertices (the step histograms) and collection arrays (the 2-d histograms'
    counts, the scatter offsets), and the figure's title."""
    out = []
    for ax in fig.axes:
        out.append(dict(
            visible=ax.get_visible(), xlim=ax.get_xlim(), ylim=ax.get_ylim(), xlabel=ax.get_xlabel(),
            ylabel=ax.get_ylabel(),
            lines=[np.stack([np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(), float)])
                   for ln in ax.get_lines()],
            patches=[np.asarray(p.get_xy()) for p in ax.patches],
            counts=[np.ma.filled(c.get_array(), np.nan) for c in ax.collections if c.get_array() is not None],
            offsets=[np.asarray(c.get_offsets()) for c in ax.collections if c.get_array() is None],
        ))
    title = fig._suptitle.get_text() if fig._suptitle is not None else None
    return out, title


def _same_figures(fig, ref):
    (got, gt), (want, wt) = _geometry(fig), _geometry(ref)
    assert gt == wt and len(got) == len(want)
    n_hist = n_counts = 0
    for g, w in zip(got, want):
        assert (g["visible"], g["xlabel"], g["ylabel"]) == (w["visible"], w["xlabel"], w["ylabel"])
        np.testing.assert_allclose(g["xlim"], w["xlim"], rtol=1e-12)
        np.testing.assert_allclose(g["ylim"], w["ylim"], rtol=1e-12)
        for key in ("lines", "offsets"):
            assert len(g[key]) == len(w[key])
            for a, b in zip(g[key], w[key]):
                np.testing.assert_allclose(a, b, rtol=1e-12)
        assert len(g["patches"]) == len(w["patches"]) and len(g["counts"]) == len(w["counts"])
        for a, b in zip(g["patches"], w["patches"]):
            np.testing.assert_array_equal(a, b)  # the histogram's heights, exactly
        for a, b in zip(g["counts"], w["counts"]):
            np.testing.assert_array_equal(a, b)  # the 2-d histogram's counts, exactly
        n_hist += len(g["patches"])
        n_counts += len(g["counts"])
    plt.close(fig)
    plt.close(ref)
    return n_hist, n_counts


def _table(n=400, d=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)) @ rng.normal(0, 1, (d, d)) + np.arange(d)
    x[rng.choice(n, 9, replace=False), rng.integers(0, d, 9)] = np.nan
    return x


@pytest.mark.parametrize("case", ["array", "frame", "truths_ranges", "one_column"])
def test_corner_matches_jax(case):
    x = _table()
    kw = {}
    if case == "array":
        t, j = corner(x), jax_corner(x)
    elif case == "frame":
        cols = {f"c{i}": x[:, i] for i in range(x.shape[1])}
        t, j = corner(Frame(cols), bins=17), jax_corner(pd.DataFrame(cols), bins=17)
    elif case == "truths_ranges":
        kw = dict(truths=[0.1, None, 2.5, 3.0], ranges=[(-3, 3), (-4, 5), (0, 4), (1, 6)], labels=list("abcd"),
                  quantiles=(0.05, 0.95))
        t, j = corner(x, **kw), jax_corner(x, **kw)
    else:
        t, j = corner(x[:, 0]), jax_corner(x[:, 0])
    d = 1 if case == "one_column" else 4
    assert _same_figures(t, j) == (d, d * (d - 1) // 2)


def _models(N):
    """The same star in both packages, its samples and derived samples set
    from one seeded table (the columns of the N-star physical and observed
    quantities)."""
    obs = dict(J=(9.5, 0.02), H=(9.2, 0.02), K=(9.1, 0.02), Teff=(5800.0, 100.0), parallax=(4.0, 0.1))
    tm = BasicStarModel(get_ichrone("synthetic", device="cpu"), N=N, name="star", **obs)
    jm = JaxBasicStarModel(jax_get_ichrone("synthetic"), N=N, name="star", **obs)
    rng = np.random.default_rng(N)
    n = 600
    samples = {c: rng.normal(i + 1.0, 0.2, n) for i, c in enumerate(tm.param_names)}
    samples["lnprob"] = rng.normal(-5, 1, n)
    cols = list(dict.fromkeys(tm.physical_quantities + [f"{b}_mag" for b in tm.bands]
                              + ["Teff" if N == 1 else "Teff_0", "parallax"]))
    derived = {c: rng.normal(10.0 + i, 0.3, n) for i, c in enumerate(cols)}
    derived["J_mag"][:5] = np.nan
    tm._samples, tm._derived_samples = Frame(samples), Frame(derived)
    jm._samples, jm._derived_samples = pd.DataFrame(samples), pd.DataFrame(derived)
    return tm, jm


@pytest.mark.parametrize("N", [1, 2])
def test_star_model_corners_match_jax(N, tmp_path):
    tm, jm = _models(N)
    assert tm.observed_quantities == jm.observed_quantities
    _same_figures(tm.corner_physical(), jm.corner_physical())
    _same_figures(tm.corner_observed(), jm.corner_observed())
    if N == 2:
        return
    _same_figures(tm.corner_params(bins=12), jm.corner_params(bins=12))
    _same_figures(tm.corner(["mass", "radius"], query="mass > 10.0 & radius < 11.5"),
                  jm.corner(["mass", "radius"], query="mass > 10.0 & radius < 11.5"))
    _same_figures(tm.triangle(["eep", "age"]), jm.triangle(["eep", "age"]))
    assert tm.mag_plot() is None and jm.mag_plot() is None

    # write_results: the JAX package's file names (its base, starmodel.py:1961-1989), .npz for .h5
    tm.write_results(directory=str(tmp_path))
    base = f"star-{jm.ic.name}-{jm.labelstring}-"
    assert sorted(os.listdir(tmp_path)) == sorted([base + "starmodel.npz"] + [f"{base}{t}.png" for t in
                                                                              ("params", "observed", "physical")])
    back = BasicStarModel.load_hdf(str(tmp_path / (base + "starmodel.npz")), ic=tm.ic)
    np.testing.assert_array_equal(back.derived_samples["mass"], tm.derived_samples["mass"])
    figs = tm.corner_plots(str(tmp_path / "plots"))
    assert len(figs) == 2 and {"plots_physical.png", "plots_observed.png"} <= set(os.listdir(tmp_path))


def test_hr_plot_matches_jax():
    rng = np.random.default_rng(5)
    cols = {}
    for b in ("J", "H", "K"):
        cols[f"{b}_mag"] = rng.uniform(8.0, 12.0, 30)
        cols[f"{b}_mag_unc"] = np.full(30, 0.02)
    tc, jc = StarCatalog(dict(cols)), JaxStarCatalog(pd.DataFrame(cols))
    n_hist, n_counts = _same_figures(tc.hr_plot(), jc.hr_plot())
    fig, ax = plt.subplots(1, 3)
    fig2, ax2 = plt.subplots(1, 3)
    assert tc.hr_plot(ax=ax) is fig and jc.hr_plot(ax=ax2) is fig2
    _same_figures(fig, fig2)


_HIDDEN = r"""
import importlib, json, os, sys
for m in ("matplotlib", "matplotlib.pyplot", "pandas", "h5py", "astroquery", "astroquery.vizier"):
    sys.modules[m] = None
import isochrones_torch
for m in ("summary", "plotting", "extinction", "query", "query.query", "query.catalog", "query.vizier",
          "starfit", "starmodel", "catalog", "cli.summarize", "cli.select", "cli.starfit"):
    importlib.import_module("isochrones_torch." + m)
import torch
torch.set_num_threads(1)
from isochrones_torch.starfit import starfit
folder = sys.argv[1]
failures = []
mod, _ = starfit(folder, models="synthetic", device="cpu", failures=failures, n_live_points=60, n_batch=8,
                 n_chains=4, n_repeat=8, max_iter=240, seed=0)
print(json.dumps([failures, mod is not None and mod._samples is not None]))
"""


def test_without_matplotlib_pandas_h5py_astroquery(tmp_path):
    folder = str(tmp_path / "star1")
    shutil.copytree(os.path.join(HERE, "star1"), folder)
    proc = subprocess.run([sys.executable, "-c", _HIDDEN, folder], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    failures, fitted = json.loads(proc.stdout.strip().splitlines()[-1])
    assert failures == [[folder, "single"]] and fitted
    assert os.path.exists(os.path.join(folder, "synthetic_starmodel_single.npz"))
    assert not [f for f in os.listdir(folder) if f.endswith(".png")]
    with open(os.path.join(folder, "starfit.log")) as f:
        log = f.read()
    assert "single starfit failed" in log and "matplotlib.pyplot" in log and "starfit successful" not in log
