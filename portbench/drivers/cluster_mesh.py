"""``cluster_posterior``'s closed loop with the members split over the cards
of one host: ``StarClusterModel(mesh=default_mesh(cards, ("stars",)))``.

The configuration's ``mesh`` gives the cards and the axis. Every call copies
the walkers from the first card to the others, issues each card's shard (the
ladder and the cluster kernel over its members) from this one host thread,
and sums the shards' partial likelihoods on the first card. The walkers, the
loop and its rate, the check's sample and the check are
``cluster_posterior``'s; the reference runs on the first card over every
member. Set-up calls the posterior twice, which copies the tables to every
card and makes each card's planar copies and kernels; the window and set-up
end with a synchronise of every card. The traced run reads a
``mesh_trace.MeshTrace``: each card's busy time on its own. On the CPU (the
tests) the mesh is as many CPU shards.
"""

from __future__ import annotations

import dataclasses
import sys
import types

import numpy as np
import torch

from ..mesh_trace import MeshTrace
from ..trace import profiled, window
from . import common
from .cluster_posterior import State, _loop, check, measure, members, release as _release, reseed, sample

__all__ = ["setup", "reseed", "measure", "traced", "sample", "release", "check"]


@dataclasses.dataclass
class MeshState(State):
    mesh: object = None

    def sync(self):
        for d in self.mesh.distinct_devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def make_mesh(cfg, device):
    """The configuration's mesh: its first ``cards`` CUDA cards, or as many
    shards on the CPU."""
    from isochrones_torch.parallel import default_mesh

    spec = cfg["mesh"]
    if device.type == "cuda":
        return default_mesh(spec["cards"], (spec["axis"],))
    return default_mesh(spec["cards"], (spec["axis"],), device="cpu")


def setup(cfg, traffic, seed, device):
    from isochrones_torch.cluster import StarClusterModel

    compile_s = common.build_kernels(device)
    ic, tables = common.interpolator(cfg, device)
    mesh = make_mesh(cfg, device)
    cols = members(cfg)
    m = cfg["model"]
    model = StarClusterModel(ic, cols, bands=tuple(cfg["bands"]), props=["parallax"],
                             eep_bounds=tuple(m["eep_bounds"]), eep_step=m["eep_step"],
                             max_distance=m["max_distance"], minq=m["minq"], mass_bounds=tuple(m["mass_bounds"]),
                             halo_fraction=cfg["priors"]["feh_halo_fraction"], max_AV=cfg["priors"]["AV"][1],
                             mesh=mesh)
    dt = ic.dtype
    t = {k: torch.as_tensor(np.stack([cols[f"{b}_mag{s}"] for b in cfg["bands"]], -1), dtype=dt, device=device)
         for k, s in (("mag_vals", ""), ("mag_uncs", "_unc"))}
    t["plax"] = torch.as_tensor(cols["parallax"], dtype=dt, device=device)
    t["plax_unc"] = torch.as_tensor(cols["parallax_unc"], dtype=dt, device=device)
    state = MeshState(model, tables, t, cfg, traffic, seed, device, torch.Generator(device=device),
                      torch.as_tensor(traffic["center"], dtype=dt, device=device),
                      torch.as_tensor(traffic["scale"], dtype=dt, device=device), compile_s, mesh=mesh)
    reseed(state, seed)
    for b in range(2):  # every card's tables, planar copies and kernels at the walker batch's one shape
        model.lnpost_batch(state.pool[b])
    state.sync()
    return state


def traced(state, seconds):
    """The same loop under the profiler, read card by card."""
    with profiled() as prof:
        with window():
            _, call_s = _loop(state, seconds)
    calls = state.calls
    n = len(calls) * state.traffic["walkers"]
    cards = [d.index for d in state.mesh.distinct_devices if d.type == "cuda"]
    return types.SimpleNamespace(trace=MeshTrace(prof, cards), call_s=call_s, n_calls=len(calls),
                                 walkers=[state.pool[b] for b, _ in calls], n_stars=state.stars["mag_vals"].shape[0],
                                 tables=state.tables, cfg=state.cfg, attempted=n, failed=0)


def release(state):
    """Write each card's memory peak to standard error (the result line has
    the first card's), then free the program's state."""
    peaks = {str(d): int(torch.cuda.max_memory_allocated(d)) for d in state.mesh.distinct_devices
             if d.type == "cuda"}
    if peaks:
        print(f"memory_peak_bytes by card: {peaks}", file=sys.stderr)
    _release(state)
