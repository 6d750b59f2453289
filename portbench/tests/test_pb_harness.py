"""The harness around the program: the JAX check, the refusal without a
card, sound runs, and the faults and the control that the check must catch.
Runs on the CPU at the tiny sizes of conftest.py; ``cuda`` cases run the
cells as committed on the card."""

import contextlib
import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import ROOT, faults, run
from portbench.drivers import catalog_fit, cluster_posterior

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("jaxtyping", "isochrones_tpu_extra", "isochrones_torch"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("jax", "jaxlib", "flax", "isochrones_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    base = run.forbidden_modules()
    assert base == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, "isochrones_tpu", types.ModuleType("isochrones_tpu"))
    assert run.forbidden_modules() == ["isochrones_tpu", "jaxlib"]


def test_verdict_fails_a_number_that_is_not_finite():
    assert run.verdict({"a": {"value": 0.5, "limit": 1.0}, "b": {"value": 0, "limit": 0}})
    assert not run.verdict({"a": {"value": 1.5, "limit": 1.0}})
    for bad in (math.nan, math.inf):
        checks = {"a": {"value": 0.5, "limit": 1.0}, "b": {"value": bad, "limit": 1.0}}
        assert not run.verdict(checks)
        assert checks["b"]["value"] == 1e300 and json.loads(json.dumps(checks)) == checks


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "cluster50.evals1024", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA card" in out.err


def test_no_program_no_result(tmp_path):
    """In a directory of BENCHMARK.json and the benchmark's files alone the
    run fails and prints no result."""
    import shutil

    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "cluster50.evals1024", "--seed", "1",
                        "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _run(tiny_cell, cell, fault=None, control=False):
    bench, wl, cfg, traffic = tiny_cell(cell)
    planted = faults.plant(fault, cfg["family"]) if fault else contextlib.nullcontext()
    driver = cluster_posterior if cfg["family"] == "cluster" else catalog_fit
    with planted:
        state = driver.setup(cfg, traffic, SEED, CPU)
        driver.measure(state, 0.3)
    driver.release(state)
    return driver.check(state, cfg, control=control)


def test_the_catalogue_work_does_not_follow_the_seed(tiny_cell):
    """Every run fits the same stars in the same order with the same sampler
    seed; the run's seed draws only the check's sample."""
    _, _, cfg, traffic = tiny_cell("catalog4096.nested")
    a = catalog_fit.setup(cfg, traffic, SEED, CPU)
    b = catalog_fit.setup(cfg, traffic, SEED + 1, CPU)
    assert "seed" in traffic["nested"]
    for k in a.obs:
        np.testing.assert_array_equal(a.obs[k], b.obs[k])
    np.testing.assert_array_equal(a.truths, b.truths)
    assert not np.array_equal(a.keep, b.keep)
    catalog_fit.measure(a, 0.0)
    catalog_fit.measure(b, 0.0)
    assert a.fits[0]["n_dead"] == b.fits[0]["n_dead"]
    both = np.intersect1d(a.keep, b.keep)  # the stars with holes at least
    assert both.size >= 4
    np.testing.assert_array_equal(a.fits[0]["samples"][np.searchsorted(a.keep, both)],
                                  b.fits[0]["samples"][np.searchsorted(b.keep, both)])


@pytest.mark.parametrize("cell", ["cluster50.evals1024", "catalog4096.nested"])
def test_sound_runs_are_correct(tiny_cell, cell):
    checks = _run(tiny_cell, cell)
    assert run.verdict(checks), checks


@pytest.mark.parametrize("cell, fault", [
    ("cluster50.evals1024", "answer"), ("cluster50.evals1024", "half"),
    ("catalog4096.nested", "answer"), ("catalog4096.nested", "half"), ("catalog4096.nested", "stuck"),
])
def test_faults_make_the_run_incorrect(tiny_cell, cell, fault):
    checks = _run(tiny_cell, cell, fault=fault)
    assert not run.verdict(checks), checks


@pytest.mark.parametrize("cell", ["cluster50.evals1024", "catalog4096.nested"])
def test_the_float32_control_is_incorrect(tiny_cell, cell):
    checks = _run(tiny_cell, cell, control=True)
    assert not run.verdict(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cluster50.evals1024", "catalog4096.nested"])
def test_cells_run_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(SEED), "--seconds",
                        "3"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
