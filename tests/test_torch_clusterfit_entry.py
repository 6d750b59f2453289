"""The cluster entry point, ``isochrones_torch.cluster.clusterfit`` and its
CLI (``isochrones_torch.cli.clusterfit``), on the CPU in float64 on a
6-star catalogue of the default synthetic grid written as CSV: the model it
builds, a short nested fit (dynamic by default, static on request), the
warning that names a row without support, the same table as a pandas HDF
table (the ``fixed`` and ``table`` layouts, deflated or not) fitted bitwise
as its CSV, a CSV under an HDF name refused, the CLI's defaults and its
error without MIST's files.

Torch runs on one thread from the module's first fixture on: at these sizes a
pool of threads beside the other test workers' is many times slower.
"""

import csv
import logging
import os

import numpy as np
import pytest
import torch

import pandas_hdf
from isochrones_torch import get_ichrone
from isochrones_torch.cluster import SimulatedCluster, StarClusterModel, clusterfit
from test_torch_cluster_fit import SIM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def member_table(tmp_path_factory):
    """A 6-star catalogue on the default synthetic grid (the grid the entry
    point builds), written as CSV."""
    ic = get_ichrone("synthetic", device="cpu")
    sim = SimulatedCluster(6, ic=ic, rng=1, **SIM)
    path = str(tmp_path_factory.mktemp("cluster") / "members.csv")
    cols = [c for c in sim.data if c not in ("is_binary", "eep_sec")]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(len(sim)):
            w.writerow([repr(float(sim.data[c][i])) for c in cols])
    return path, sim


#: a short run: the budget ends it long before it converges
ENTRY = dict(models="synthetic", mineep=1, maxeep=151, eep_step=3.0, max_distance=2000, nlive=40, max_iter=40)


def test_clusterfit_from_csv(member_table, caplog):
    path, sim = member_table
    with caplog.at_level(logging.INFO, logger="isochrones_torch"):
        model = clusterfit(path, name="m67", device="cpu", **ENTRY)
    assert isinstance(model, StarClusterModel) and model.device.type == "cpu" and model.dtype == torch.float64
    assert model.bands == ("J", "K") and model.props == ("parallax",) and len(model.stars) == 6
    assert model.bounds("eep") == (1, 151) and model._n_ladder == 51 and model.minq == 0.2
    assert model.bounds("AV") == (0, 0.1) and model.bounds("distance") == (0, 2000)
    assert model.labelstring == "cluster_m67"
    assert np.isfinite(model.evidence[0]) and model._nested_result.n_iter == 40
    assert set(model.samples) == set(model.param_names) | {"lnprob"} and len(model.samples["age"]) == 4000
    assert model._nested_result.dynamic_rounds >= 0 and set(model.derived_samples) == set(model.samples)
    assert "bands = ('J', 'K')" in caplog.text and "logz = " in caplog.text
    assert "no (eep, q) support" not in caplog.text
    np.testing.assert_array_equal(model.stars.data["J_mag"], sim.data["J_mag"])
    # comm and rank are accepted and ignored; static is honoured
    static = clusterfit(path, device="cpu", comm=object(), rank=3, dynamic=False, min_ess=50.0, **ENTRY)
    assert np.isfinite(static.evidence[0]) and static._nested_result.dynamic_rounds == 0


def test_clusterfit_warns_of_unsupported_stars(member_table, tmp_path, caplog, monkeypatch):
    """A NaN magnitude makes every probe point -inf: the entry point names
    the row before it fits."""
    path, _ = member_table
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    rows[3][rows[0].index("K_mag")] = "nan"
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    monkeypatch.setattr(StarClusterModel, "fit", lambda self, **kw: None)
    with caplog.at_level(logging.WARNING, logger="isochrones_torch"):
        model = clusterfit(bad, device="cpu", **ENTRY)
    assert "no (eep, q) support" in caplog.text and "rows [2]" in caplog.text
    assert model.evidence is None


#: a cut seeded fit, to hold an HDF table's fit to its CSV's bitwise
SEEDED = dict(ENTRY, nlive=12, max_iter=6, dynamic=False, seed=0)


@pytest.fixture(scope="module")
def seeded_csv_fit(member_table):
    return clusterfit(member_table[0], device="cpu", **SEEDED)


@pytest.mark.parametrize("name", ["stars.h5", "stars.hdf", "stars.hdf5"])
def test_clusterfit_refuses_hdf_by_name(member_table, seeded_csv_fit, tmp_path, name):
    """A member table in pandas' HDF layouts (``.h5``: ``fixed``; ``.hdf``:
    ``table``; ``.hdf5``: ``table``, deflated) fits to bitwise the samples
    and evidence of the same seeded fit from its CSV; a CSV under an HDF
    name is refused (``ValueError``), not read as CSV."""
    path, _ = member_table
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    cols = {c: np.array([float(r[i]) for r in rows]) for i, c in enumerate(header)}
    hdf = str(tmp_path / name)
    if name.endswith(".h5"):
        pandas_hdf.write_fixed(hdf, cols)
    else:
        pandas_hdf.write_table(hdf, cols, complevel=6 if name.endswith(".hdf5") else None)
    from_csv, from_hdf = seeded_csv_fit, clusterfit(hdf, device="cpu", **SEEDED)
    assert from_hdf.evidence == from_csv.evidence and np.isfinite(from_hdf.evidence[0])
    for c in from_csv.samples:
        np.testing.assert_array_equal(from_hdf.samples[c], from_csv.samples[c])
    for c in from_csv.stars.data:
        np.testing.assert_array_equal(from_hdf.stars.data[c], from_csv.stars.data[c])
    fake = str(tmp_path / ("csv_" + name))
    os.symlink(path, fake)
    with pytest.raises(ValueError, match="HDF5 signature"):
        clusterfit(fake, device="cpu", **SEEDED)


def test_clusterfit_cli(member_table, caplog, tmp_path, monkeypatch):
    import isochrones_torch.config as tconfig
    from isochrones_torch.cli.clusterfit import build_parser, main
    from isochrones_torch.grids.base import MissingGridError

    defaults = build_parser().parse_args(["x.csv"])
    assert (defaults.models, defaults.mineep, defaults.maxeep, defaults.nlive, defaults.maxAV, defaults.minq,
            defaults.max_distance, defaults.device, defaults.dtype, defaults.dynamic, defaults.eep_step) == \
        ("mist", 200, 800, 1000, 0.1, 0.2, 10000, "cuda", "float64", None, 1.0)
    assert build_parser().parse_args(["--static", "x.csv"]).dynamic is False
    assert build_parser().parse_args(["--dynamic", "x.csv"]).dynamic is True
    path, _ = member_table
    with caplog.at_level(logging.INFO, logger="isochrones_torch"):
        rc = main(["--models", "synthetic", "--device", "cpu", "--mineep", "1", "--maxeep", "151", "--eep-step", "3",
                   "--max_distance", "2000", "--nlive", "40", "--max_iter", "40", "--name", "cli", path])
    assert rc == 0 and "clusterfit cluster_cli: logz = " in caplog.text
    # the default grid is MIST's: without its files the error names the missing path
    monkeypatch.setattr(tconfig, "ISOCHRONES", str(tmp_path))
    with pytest.raises(MissingGridError, match="MIST"):
        main(["--device", "cpu", path])
