"""The port's fleets of independent fits (``isochrones_torch.parallel.multihost``)
on the CPU: the shard arithmetic against the JAX package's, the single-process
fallback, and real two-process ``torch.distributed`` (gloo) fleets of spawned
interpreters on a free localhost port (``tests/_torch_multihost_worker.py``).

The fast fleet maps a trivial work list and meets at a barrier that one
process reaches 3 s after the other; the slow one fits five stars, as
``tests/test_multihost.py::test_two_process_fleet`` does in the JAX package.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from isochrones_tpu.parallel.multihost import process_shard as jax_process_shard
from isochrones_torch.parallel.multihost import initialize_distributed, process_shard

HERE = os.path.dirname(os.path.abspath(__file__))
ENV_VARS = ("ISOCHRONES_TPU_COORDINATOR", "ISOCHRONES_TPU_NUM_PROCESSES", "ISOCHRONES_TPU_PROCESS_ID")


@pytest.mark.parametrize("n_items,nproc", [(5, 2), (8, 3), (3, 4), (0, 2), (7, 1)])
def test_process_shard_matches_jax(n_items, nproc):
    items = list(range(n_items))
    shards = [process_shard(items, p, nproc) for p in range(nproc)]
    assert shards == [jax_process_shard(items, p, nproc) for p in range(nproc)]
    assert [x for s in shards for x in s] == items  # disjoint, complete, in order
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1


def test_process_shard_explicit_ids_and_defaults():
    items = ["a", "b", "c", "d", "e"]
    assert process_shard(items, 0, 2) == jax_process_shard(items, 0, 2) == ["a", "b", "c"]
    assert process_shard(items, 1, 2) == jax_process_shard(items, 1, 2) == ["d", "e"]
    assert process_shard(items) == items  # outside a fleet: process 0 of 1


def test_initialize_distributed_single_process(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == (0, 1)
    assert initialize_distributed(num_processes=1, process_id=0) == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="number of processes"):
        initialize_distributed(coordinator_address="localhost:1")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="outside"):
        initialize_distributed("localhost:1", num_processes=2, process_id=2)
    assert not dist.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fleet(mode, tmp_path, timeout):
    """Two spawned workers in a fleet on a free port; their JSON outputs."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, ISOCHRONES_TPU_COORDINATOR=f"localhost:{port}", ISOCHRONES_TPU_NUM_PROCESSES="2",
                   ISOCHRONES_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_multihost_worker.py"), mode,
                                       str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = []
    for pid in range(2):
        with open(tmp_path / f"proc{pid}.json") as f:
            got.append(json.load(f))
    assert [(d["pid"], d["nproc"]) for d in got] == [(0, 2), (1, 2)]
    return got


def test_two_process_fleet_and_late_barrier(tmp_path):
    """A real gloo fleet: the shards are disjoint and complete, and the
    barrier that process 1 reaches 3 s after process 0 still returns (process
    0 waited for it)."""
    got = _fleet("trivial", tmp_path, timeout=120)
    assert got[0]["shard"] == [0, 1, 2, 3] and got[1]["shard"] == [4, 5, 6]
    assert got[0]["results"] + got[1]["results"] == [x * x for x in range(7)]
    assert got[0]["barrier_wait_s"] > 2.0 and got[1]["barrier_wait_s"] < got[0]["barrier_wait_s"]


@pytest.mark.slow
def test_two_process_fleet(tmp_path):
    """Five stars fitted by a two-process fleet: disjoint, complete, and each
    fit recovers its star."""
    got = _fleet("fits", tmp_path, timeout=600)
    eeps = [r["eep_true"] for d in got for r in d["results"]]
    assert sorted(eeps) == [30.0, 32.0, 34.0, 36.0, 38.0]
    assert len(got[0]["results"]) == 3 and len(got[1]["results"]) == 2
    for d in got:
        for r in d["results"]:
            assert abs(r["eep_med"] - r["eep_true"]) < 5.0, r
