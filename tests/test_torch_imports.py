"""The port stands alone: importing every module of ``isochrones_torch``
loads no JAX, no JAX-package, no pandas, no h5py, no PyTables, no
matplotlib, no astroquery and no requests module (the machine with the card
has none of the first five; the plots, the Vizier queries and the downloads
import theirs at the call). With h5py, pandas and PyTables hidden, the HDF5
files go through ``isochrones_torch.hdf5``: ``starfit`` -> ``load_hdf`` ->
``write_results_txt``, and ``clusterfit`` from a pandas HDF table."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

import pandas_hdf

_PROBE = r"""
import importlib, json, pkgutil, sys
import isochrones_torch
for m in pkgutil.walk_packages(isochrones_torch.__path__, "isochrones_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "isochrones_tpu", "pandas", "h5py",
                                                    "tables", "matplotlib", "astroquery", "requests"))
mods = sorted(n for n in sys.modules if n.startswith("isochrones_torch"))
print(json.dumps([bad, mods]))
"""

#: modules the probe must have imported (the walk covers every module; these
#: pin the star-model slice in particular)
_EXPECTED = (
    "isochrones_torch.starmodel",
    "isochrones_torch.priors",
    "isochrones_torch.models.interpolator",
    "isochrones_torch.ops.likelihood",
    "isochrones_torch.ops.star",
    "isochrones_torch.ops.star_cuda",
    "isochrones_torch.samplers.nested",
    "isochrones_torch.iniparse",
    "isochrones_torch.observation",
    "isochrones_torch.ops.tree",
    "isochrones_torch.ops.tree_cuda",
    "isochrones_torch.treemodel",
    "isochrones_torch.starfit",
    "isochrones_torch.cli.starfit",
    "isochrones_torch.ops.eep",
    "isochrones_torch.ops.rootfind",
    "isochrones_torch.isochrone",
    "isochrones_torch.cluster",
    "isochrones_torch.cli.clusterfit",
    "isochrones_torch.ops.catalog",
    "isochrones_torch.ops.catalog_cuda",
    "isochrones_torch.batch",
    "isochrones_torch.summary",
    "isochrones_torch.cli.fit_catalog",
    "isochrones_torch.cli.batch",
    "isochrones_torch.ops.generate",
    "isochrones_torch.ops.generate_cuda",
    "isochrones_torch.populations",
    "isochrones_torch.cli.generate_cmd",
    "isochrones_torch.grids.base",
    "isochrones_torch.grids.mist",
    "isochrones_torch.grids.mist_eep",
    "isochrones_torch.grids.mist_files",
    "isochrones_torch.grids.parse",
    "isochrones_torch.eep_fit",
    "isochrones_torch.mist",
    "isochrones_torch.mist.bc",
    "isochrones_torch.mist.eep",
    "isochrones_torch.mist.isochrone",
    "isochrones_torch.mist.models",
    "isochrones_torch.mist.utils",
    "isochrones_torch.cli.initialize",
    "isochrones_torch.version",
    "isochrones_torch.bc",
    "isochrones_torch.grid",
    "isochrones_torch.eep",
    "isochrones_torch.likelihood",
    "isochrones_torch.mags",
    "isochrones_torch.cluster_utils",
    "isochrones_torch.interp",
    "isochrones_torch.plotting",
    "isochrones_torch.extinction",
    "isochrones_torch.query",
    "isochrones_torch.query.query",
    "isochrones_torch.query.catalog",
    "isochrones_torch.query.vizier",
    "isochrones_torch.cli.summarize",
    "isochrones_torch.cli.select",
    "isochrones_torch.hdf5",
)


def test_port_imports_no_jax_no_pandas():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    bad, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    assert set(_EXPECTED) <= set(mods), sorted(set(_EXPECTED) - set(mods))


_HIDDEN = r"""
import json, sys
for m in ("h5py", "pandas", "tables"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from isochrones_torch import BasicStarModel
from isochrones_torch.cluster import clusterfit
from isochrones_torch.starfit import starfit
from isochrones_torch.summary import write_results_txt
folder, table = sys.argv[1:3]
failures = []
mod, _ = starfit(folder, models="synthetic", no_plots=True, device="cpu", failures=failures, n_live_points=40,
                 n_batch=8, n_chains=4, n_repeat=8, max_iter=120, seed=0)
back = BasicStarModel.load_hdf(folder + "/synthetic_starmodel_single.h5", device="cpu")
same = all((back.samples[c] == mod.samples[c]).all() for c in mod.samples)
txt = write_results_txt(folder, models="synthetic")
cluster = clusterfit(table, models="synthetic", device="cpu", mineep=1, maxeep=151, eep_step=3.0,
                     max_distance=2000, nlive=12, max_iter=6, dynamic=False, seed=0)
print(json.dumps([failures, same, txt, len(cluster.stars), cluster.evidence is not None]))
"""


def test_hdf5_files_without_h5py_or_pandas(tmp_path):
    from isochrones_torch import get_ichrone
    from isochrones_torch.cluster import SimulatedCluster
    from test_torch_cluster_fit import SIM

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder, table = str(tmp_path / "star1"), str(tmp_path / "members.h5")
    shutil.copytree(os.path.join(root, "tests", "star1"), folder)
    sim = SimulatedCluster(6, ic=get_ichrone("synthetic", device="cpu"), rng=1, **SIM)
    pandas_hdf.write_table(table, {c: np.asarray(sim.data[c], dtype=float) for c in sim.data
                                   if c not in ("is_binary", "eep_sec")}, complevel=4)
    proc = subprocess.run([sys.executable, "-c", _HIDDEN, folder, table], cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    failures, same, txt, n_stars, fitted = json.loads(proc.stdout.strip().splitlines()[-1])
    assert failures == [] and same and n_stars == 6 and fitted
    assert txt == os.path.join(folder, "synthetic_single_results.txt") and os.path.exists(txt)
