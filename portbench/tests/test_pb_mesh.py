"""The four-card cluster cell on the CPU and its multi-card trace.

The cell at the tiny sizes of conftest.py on four CPU shards: a sound run is
``correct``; the harness's ``answer`` fault, the float32 control and a fault
of the mesh's own (one shard's partial sum left out of the gather) each make
it incorrect. ``mesh_trace.MeshTrace`` on hand-built events of two cards:
each card's busy time, the mean card, the cards busy at once and the gaps in
which no card is busy; the cell's readers on those events, and on a traced
tiny run on the CPU, where only the program's spans are there to read. The
``cuda`` case runs the cell as committed on four cards."""

import contextlib
import itertools
import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import ROOT, faults, run
from portbench.drivers import cluster_mesh
from portbench.mesh_trace import MeshTrace
from portbench.trace import WINDOW

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977
CELL = "cluster200.evals1024.4chip"
READERS = ("cards_concurrent.cluster200", "idle_share.cluster200", "shard_issue_ms.cluster200",
           "xcard_copy_ms.cluster200", "cluster_kernel_roofline.cluster200")


@contextlib.contextmanager
def dropped_shard(n_shards):
    """The last shard's partial sum and count left out of the gather: that
    shard's ``_finite_sum`` hands back zeros."""
    from isochrones_torch import cluster

    orig, seen = cluster._finite_sum, itertools.count()

    def partial(lnmarg):
        total, bad = orig(lnmarg)
        if next(seen) % n_shards == n_shards - 1:
            return torch.zeros_like(total), torch.zeros_like(bad)
        return total, bad

    cluster._finite_sum = partial
    try:
        yield
    finally:
        cluster._finite_sum = orig


def _run(tiny_cell, fault=None, control=False):
    _, _, cfg, traffic = tiny_cell(CELL)
    planted = contextlib.nullcontext()
    if fault == "dropped_shard":
        planted = dropped_shard(cfg["mesh"]["cards"])
    elif fault:
        planted = faults.plant(fault, cfg["family"])
    with planted:
        state = cluster_mesh.setup(cfg, traffic, SEED, CPU)
        cluster_mesh.measure(state, 0.3)
    assert state.mesh.size == cfg["mesh"]["cards"] == 4
    cluster_mesh.release(state)
    return cluster_mesh.check(state, cfg, control=control)


def test_a_sound_run_is_correct(tiny_cell):
    checks = _run(tiny_cell)
    assert run.verdict(checks), checks


@pytest.mark.parametrize("fault, control", [("answer", False), (None, True), ("dropped_shard", False)])
def test_faults_and_the_control_make_the_run_incorrect(tiny_cell, fault, control):
    checks = _run(tiny_cell, fault=fault, control=control)
    assert not run.verdict(checks), checks


class Event:
    """A kineto event of the profiler's results: ``card`` None is a host
    event."""

    def __init__(self, name, start, end, card=None, annotation=False):
        self._name, self._start, self._end, self._card, self._annotation = name, start, end, card, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return torch.autograd.DeviceType.CPU if self._card is None else torch.autograd.DeviceType.CUDA

    def device_index(self):
        return -1 if self._card is None else self._card

    def is_user_annotation(self):
        return self._annotation


#: a window of 100 ns; card 0 busy 10-50 (two kernels that overlap and a peer
#: copy inside them) and 60-70; card 1 busy 20-45 and 80-100 (its last kernel
#: runs past the window's end); a span's copy on card 1 and a kernel before
#: the window, both left out; two calls on the host
EVENTS = [Event(WINDOW, 0, 100), Event("portbench.lnpost_batch", 0, 40), Event("portbench.lnpost_batch", 40, 95),
          Event("host_op", 45, 65), Event("isochrones_torch.cluster.shard", 2, 6),
          Event("isochrones_torch.cluster.shard", 6, 9), Event("isochrones_torch.cluster.shard", 41, 49),
          Event("isochrones_torch.cluster.shard", 49, 50),
          Event("cluster_marginal", 10, 40, card=0), Event("add", 30, 50, card=0),
          Event("Memcpy PtoP (Device -> Device)", 40, 44, card=0), Event("cluster_marginal", 60, 70, card=0),
          Event("cluster_marginal", 20, 45, card=1), Event("cluster_marginal", 80, 120, card=1),
          Event("isochrones_torch.cluster.shard", 20, 30, card=1, annotation=True),
          Event("cluster_marginal", -20, -10, card=1)]


def hand_trace(cards):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: EVENTS)))
    return MeshTrace(prof, cards)


def test_busy_time_card_by_card():
    tr = hand_trace([0, 1])
    assert tr.n_device_events == 6 and list(tr.dev_index) == [0, 0, 0, 0, 1, 1]
    assert tr.card_busy_s() == pytest.approx({0: 50e-9, 1: 45e-9}, rel=1e-12)
    assert tr.busy_s == pytest.approx(47.5e-9, rel=1e-12)
    assert tr.any_busy_s == pytest.approx(70e-9, rel=1e-12)  # 10-50, 60-70, 80-100
    assert tr.concurrency() == pytest.approx(95 / 70, rel=1e-12)
    gs, ge = tr.gaps()  # no card busy
    assert list(zip(gs, ge)) == [(0, 10), (50, 60), (70, 80)]
    # each gap by the shortest host event over its middle (5, 55, 75)
    assert dict(tr.idle_gaps()) == pytest.approx({"isochrones_torch.cluster.shard": 10e-9, "host_op": 10e-9,
                                                  "portbench.lnpost_batch": 10e-9})
    # a card of the mesh with no event is idle throughout
    assert hand_trace([0, 1, 2]).busy_s == pytest.approx(95e-9 / 3, rel=1e-12)


def test_the_readers_on_hand_built_events():
    ctx = types.SimpleNamespace(trace=hand_trace([0, 1]), n_calls=2)
    got = {m: run.read_metric(m, ctx) for m in READERS[:4]}
    assert got["cards_concurrent.cluster200"] == pytest.approx(95 / 70, rel=1e-12)
    assert got["idle_share.cluster200"] == pytest.approx(1 - 47.5 / 100, rel=1e-12)
    assert got["shard_issue_ms.cluster200"] == pytest.approx(8e-6, rel=1e-12)  # calls of 7 and 9 ns
    assert got["xcard_copy_ms.cluster200"] == pytest.approx(2e-6, rel=1e-12)  # 4 ns over 2 calls


def test_the_readers_on_a_traced_tiny_run(tiny_cell):
    """On the CPU the window holds the program's spans and no device event:
    the span reader reads, the device readers find nothing."""
    _, _, cfg, traffic = tiny_cell(CELL)
    state = cluster_mesh.setup(cfg, traffic, SEED, CPU)
    ctx = cluster_mesh.traced(state, 0.3)
    got = {m: run.read_metric(m, ctx) for m in READERS}
    assert math.isfinite(got.pop("shard_issue_ms.cluster200")) and set(got.values()) == {None}, got
    n = {}
    for name in ctx.trace.cpu_name:
        n[name] = n.get(name, 0) + 1
    assert n["isochrones_torch.cluster.shard"] == 4 * ctx.n_calls and n["isochrones_torch.cluster.gather"] == \
        ctx.n_calls == n["portbench.lnpost_batch"] and np.isfinite(ctx.call_s).all()


@pytest.mark.cuda
def test_the_cell_runs_correct_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL, "--seed", str(SEED), "--seconds",
                        "3"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
