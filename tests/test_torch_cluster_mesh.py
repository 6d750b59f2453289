"""The cluster posterior with its star axis on a CPU mesh, against the plain
reference of the benchmark (``portbench/reference/cluster.py``: plain torch,
nothing of the program), and its mesh spans.

A small grid (5 [Fe/H] x 30 ages x 1710 EEPs), a coarse ladder (EEP step 20,
70 rows), the first 20 members of the benchmark's 200-member cluster, float64.
Each case runs unsharded (``mesh=None``), on four shards (five members each)
and on three (7, 7, 6): the log-posterior within 1e-12 of the reference with
the same finite pattern, at walkers about the truth and outside the prior
box; under the profiler one ``cluster.shard`` span a shard and one
``cluster.gather`` span a call; a traced call bitwise the untraced one; and
the order of issue: the walkers reach every shard's device before any shard's
work, the shards follow in mesh order, and a shard on the walkers' own device
takes them uncopied.
"""

import copy

import numpy as np
import pytest
import torch

from isochrones_torch import tracing
from isochrones_torch.cluster import StarClusterModel
from isochrones_torch.parallel import default_mesh, mesh_constrain_leading
from portbench import run
from portbench.drivers import cluster_posterior, common
from portbench.reference import cluster as ref

CPU = torch.device("cpu")
N_MEMBERS = 20
N_WALKERS = 24
SHARDS = [None, 4, 3]
CALLS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setting():
    """``(cfg, ic, tables, member columns, member tensors, walkers)``."""
    _, cfg, traffic = run.cell_spec(run.load_json("BENCHMARK.json"), "cluster200.evals1024.4chip")
    cfg = copy.deepcopy(cfg)
    cfg["grid"].update(n_feh=5, n_mass=20, n_age=30)
    cfg["model"]["eep_step"] = 20.0
    ic, tables = common.interpolator(cfg, CPU)
    cols = {k: v[:N_MEMBERS] for k, v in cluster_posterior.members(cfg).items()}
    stars = {"mag_vals": torch.as_tensor(np.stack([cols[f"{b}_mag"] for b in cfg["bands"]], -1)),
             "mag_uncs": torch.as_tensor(np.stack([cols[f"{b}_mag_unc"] for b in cfg["bands"]], -1)),
             "plax": torch.as_tensor(cols["parallax"]), "plax_unc": torch.as_tensor(cols["parallax_unc"])}
    rng = np.random.default_rng(20261018)
    p = np.asarray(traffic["center"]) + np.asarray(traffic["scale"]) * rng.standard_normal((N_WALKERS, 7))
    p[0, 6] = 0.7  # fB above its prior box
    p[1, 4] = -4.5  # alpha below it
    p[2, 2] = -10.0  # a negative distance
    p[3, 0] = 10.3  # an age past the grid
    return cfg, ic, tables, cols, stars, torch.as_tensor(p)


def model(setting, shards):
    cfg, ic, _, cols, _, _ = setting
    m = cfg["model"]
    mesh = None if shards is None else default_mesh(shards, ("stars",), device="cpu")
    return StarClusterModel(ic, cols, bands=tuple(cfg["bands"]), props=["parallax"],
                            eep_bounds=tuple(m["eep_bounds"]), eep_step=m["eep_step"],
                            max_distance=m["max_distance"], minq=m["minq"], mass_bounds=tuple(m["mass_bounds"]),
                            halo_fraction=cfg["priors"]["feh_halo_fraction"], max_AV=cfg["priors"]["AV"][1],
                            mesh=mesh)


def span_counts(fn):
    """``(fn(), {span name less the prefix: count})`` under a CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    counts = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            name = e.name[len(tracing.PREFIX):]
            counts[name] = counts.get(name, 0) + 1
    return out, counts


@pytest.mark.parametrize("shards", SHARDS)
def test_lnpost_matches_the_plain_reference(setting, shards):
    cfg, _, tables, _, stars, p = setting
    got = model(setting, shards).lnpost_batch(p).numpy()
    want = ref.lnpost(p, tables, stars, cfg).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(want).sum() >= N_WALKERS - 4 and (~np.isfinite(want[:4])).all()
    gap, mismatch = common.gaps(got, want)
    assert mismatch == 0 and gap <= 1e-12, gap


@pytest.mark.parametrize("shards", SHARDS)
def test_one_span_a_shard_and_one_gather_a_call(setting, shards):
    m, p = model(setting, shards), setting[-1]
    m.lnpost_batch(p)  # builds the closures outside the trace

    def calls():
        return [m.lnpost_batch(p) for _ in range(CALLS)]

    _, counts = span_counts(calls)
    assert counts == {"cluster.shard": CALLS * (shards or 1), "cluster.gather": CALLS}


@pytest.mark.parametrize("shards", SHARDS)
def test_a_traced_call_is_bitwise_the_untraced_one(setting, shards):
    m, p = model(setting, shards), setting[-1]
    plain = m.lnpost_batch(p)
    traced, counts = span_counts(lambda: m.lnpost_batch(p))
    assert counts["cluster.gather"] == 1
    assert plain.numpy().tobytes() == traced.numpy().tobytes()


class Recorder:
    """The sharded likelihood's order of issue: ``("copy", device)`` for each
    ``Tensor.to`` of ``walkers``, ``("block", walkers, mag_vals)`` for each
    call of a replica's block function; ``obs``, ``mesh`` and the closures as
    the model built them."""

    def __init__(self, monkeypatch):
        self.log, self.walkers = [], None
        build_block, build_sharded, to = (StarClusterModel._build_block_lnmarg,
                                          StarClusterModel._build_sharded_lnlike, torch.Tensor.to)

        def block_lnmarg(model):
            fn = build_block(model)

            def block(p, mv, *rest):
                self.log.append(("block", p, mv))
                return fn(p, mv, *rest)

            return block

        def sharded(model, obs, mesh):
            self.obs, self.mesh = obs, mesh
            out = build_sharded(model, obs, mesh)
            self.closures = dict(zip(("lnlike_flat", "star_lnmarg"), out))
            return out

        def copy(x, *args, **kwargs):
            if x is self.walkers:
                self.log.append(("copy",) + args)
            return to(x, *args, **kwargs)

        monkeypatch.setattr(StarClusterModel, "_build_block_lnmarg", block_lnmarg)
        monkeypatch.setattr(StarClusterModel, "_build_sharded_lnlike", sharded)
        monkeypatch.setattr(torch.Tensor, "to", copy)

    def call(self, closure, p):
        """The log of one call of ``closure`` at walkers ``p``."""
        self.log.clear()
        self.walkers = p
        self.closures[closure](p)
        return list(self.log)


@pytest.mark.parametrize("closure", ["lnlike_flat", "star_lnmarg"])
@pytest.mark.parametrize("shards", SHARDS)
def test_the_walkers_reach_every_device_before_any_shard_s_work(setting, shards, closure, monkeypatch):
    rec = Recorder(monkeypatch)
    m, p = model(setting, shards), setting[-1]
    m.lnpost_batch(p)  # builds the closures through the recorders
    stacks = [st for st in mesh_constrain_leading(rec.obs, rec.mesh) if st[0].shape[0] > 0]
    assert len(stacks) == (shards or 1)
    log = rec.call(closure, p)
    n_copies = len(set(rec.mesh.devices))
    assert [e[0] for e in log] == ["copy"] * n_copies + ["block"] * len(stacks), log
    for (_, _, mv), st in zip(log[n_copies:], stacks):
        assert torch.equal(mv, st[0])


@pytest.mark.parametrize("shards", SHARDS)
def test_a_shard_on_the_walkers_device_takes_them_uncopied(setting, shards, monkeypatch):
    rec = Recorder(monkeypatch)
    m, p = model(setting, shards), setting[-1]
    m.lnpost_batch(p)
    blocks = [e for e in rec.call("lnlike_flat", p) if e[0] == "block"]
    assert len(blocks) == (shards or 1)
    assert all(x is p for _, x, _ in blocks)
