"""Cells of the benchmark cut to a size the CPU holds in a test.

The widths stay (the grid's 1710 EEPs, J, H, K, the members, the traffic's
walker draws); the grid has fewer ages and [Fe/H] rows, the cluster ladder a
coarser step, the catalogue fewer stars and live points."""

import copy

import pytest

from portbench import run


def tiny(workload):
    bench = run.load_json("BENCHMARK.json")
    wl, cfg, traffic = run.cell_spec(bench, workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["grid"].update(n_feh=5, n_mass=20, n_age=30)
    if cfg["family"] == "cluster":
        cfg["model"]["eep_step"] = 20.0
        traffic["walkers"] = 8
        traffic["batches"] = 4
        cfg["check"]["walkers"] = 16
    else:
        cfg["catalog"]["n_stars"] = 16
        cfg["check"]["stars"] = 6
        traffic["nested"].update(n_live_points=32, n_equal=200, min_ess=10, dlogz=0.5)
        traffic["warmup_dead_points"] = 16
    return bench, wl, cfg, traffic


@pytest.fixture
def tiny_cell():
    return tiny
