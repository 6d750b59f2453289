"""The port stands alone: importing every module of ``isochrones_torch``
loads no JAX, no JAX-package, no pandas, no h5py, no matplotlib, no
astroquery and no requests module (the machine with the card has none of the
first four; the plots, the Vizier queries and the downloads import theirs at
the call)."""

import json
import os
import subprocess
import sys

_PROBE = r"""
import importlib, json, pkgutil, sys
import isochrones_torch
for m in pkgutil.walk_packages(isochrones_torch.__path__, "isochrones_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "isochrones_tpu", "pandas", "h5py",
                                                    "matplotlib", "astroquery", "requests"))
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
)


def test_port_imports_no_jax_no_pandas():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    bad, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    assert set(_EXPECTED) <= set(mods), sorted(set(_EXPECTED) - set(mods))
