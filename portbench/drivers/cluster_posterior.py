"""A closed loop of cluster posterior calls (``StarClusterModel.lnpost_batch``).

Set-up draws the traffic's ``batches`` batches of walkers on the device from
the run's seed, in one call: Gaussian about the traffic's ``center`` with the
traffic's ``scale`` (where a nested fit's live points sit after its first
steps). Call ``i`` of the window takes batch ``i`` modulo ``batches``, so the
window issues the program's calls and nothing else. The next call is issued
when the previous one has been issued; a CUDA event recorded after each call
times it on the device, with no synchronise. The window ends with a
synchronise, and the rate is every walker evaluation of the window over the
whole window. The traced run is the same loop under the profiler. The check
draws a sample of the window's walkers from the seed and compares the
program's log-posteriors with the reference's.
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from ..reference import cluster as ref
from ..trace import Trace, profiled, span, window
from . import common


@dataclasses.dataclass
class State:
    model: object
    tables: dict
    stars: dict
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    gen: torch.Generator
    center: torch.Tensor
    scale: torch.Tensor
    compile_s: float
    pool: torch.Tensor = None
    calls: list = dataclasses.field(default_factory=list)
    picked: tuple = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def members(cfg):
    """The members' observations as the program's catalogue takes them."""
    data = common.read_csv(cfg["members"])
    cols = {}
    for b in cfg["bands"]:
        cols[f"{b}_mag"], cols[f"{b}_mag_unc"] = data[f"{b}_mag"], data[f"{b}_mag_unc"]
    cols["parallax"], cols["parallax_unc"] = data["parallax"], data["parallax_unc"]
    return cols


def setup(cfg, traffic, seed, device):
    from isochrones_torch.cluster import StarClusterModel

    compile_s = common.build_kernels(device)
    ic, tables = common.interpolator(cfg, device)
    cols = members(cfg)
    m = cfg["model"]
    model = StarClusterModel(ic, cols, bands=tuple(cfg["bands"]), props=["parallax"],
                             eep_bounds=tuple(m["eep_bounds"]), eep_step=m["eep_step"],
                             max_distance=m["max_distance"], minq=m["minq"], mass_bounds=tuple(m["mass_bounds"]),
                             halo_fraction=cfg["priors"]["feh_halo_fraction"], max_AV=cfg["priors"]["AV"][1])
    dt = ic.dtype
    t = {k: torch.as_tensor(np.stack([cols[f"{b}_mag{s}"] for b in cfg["bands"]], -1), dtype=dt, device=device)
         for k, s in (("mag_vals", ""), ("mag_uncs", "_unc"))}
    t["plax"] = torch.as_tensor(cols["parallax"], dtype=dt, device=device)
    t["plax_unc"] = torch.as_tensor(cols["parallax_unc"], dtype=dt, device=device)
    state = State(model, tables, t, cfg, traffic, seed, device, torch.Generator(device=device),
                  torch.as_tensor(traffic["center"], dtype=dt, device=device),
                  torch.as_tensor(traffic["scale"], dtype=dt, device=device), compile_s)
    reseed(state, seed)
    for b in range(2):  # the walker batch's one shape: the kernels, the ladder's planar copies
        model.lnpost_batch(state.pool[b])
    state.sync()
    return state


def reseed(state, seed):
    """Draw the walkers of the window from ``seed``, with no call made."""
    state.seed = seed
    state.gen.manual_seed(int(seed))
    tr = state.traffic
    z = torch.randn((tr["batches"], tr["walkers"], 7), generator=state.gen, dtype=state.center.dtype,
                    device=state.device)
    state.pool = state.center + state.scale * z
    state.calls = []
    state.picked = None


def _loop(state, seconds):
    """The window: ``(seconds elapsed, each call's device seconds or [])``."""
    model, calls, pool = state.model, state.calls, state.pool
    timed = state.device.type == "cuda"
    ends = []
    t0 = time.perf_counter()
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    while True:
        b = len(calls) % pool.shape[0]
        with span("lnpost_batch"):
            calls.append((b, model.lnpost_batch(pool[b])))
        if timed:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        if time.perf_counter() - t0 >= seconds:
            break
    state.sync()
    elapsed = time.perf_counter() - t0
    marks = [start] + ends if timed else []
    return elapsed, [a.elapsed_time(e) * 1e-3 for a, e in zip(marks, marks[1:])]


def measure(state, seconds):
    elapsed, _ = _loop(state, seconds)
    n = len(state.calls) * state.traffic["walkers"]
    return types.SimpleNamespace(values={"posterior_evals_per_s": n / elapsed}, attempted=n, failed=0)


def traced(state, seconds):
    """The same loop under the profiler."""
    with profiled() as prof:
        with window():
            _, call_s = _loop(state, seconds)
    calls = state.calls
    n = len(calls) * state.traffic["walkers"]
    return types.SimpleNamespace(trace=Trace(prof), call_s=call_s, n_calls=len(calls),
                                 walkers=[state.pool[b] for b, _ in calls], n_stars=state.stars["mag_vals"].shape[0],
                                 tables=state.tables, cfg=state.cfg, attempted=n, failed=0)


def sample(state):
    """The check's walkers and the program's answers at them: a sample drawn
    from the seed over every walker of the window."""
    if state.picked is None:
        W = state.traffic["walkers"]
        n = min(state.cfg["check"]["walkers"], len(state.calls) * W)
        pick = np.sort(common.seeded(state.seed, 1).choice(len(state.calls) * W, size=n, replace=False))
        p = torch.stack([state.pool[state.calls[i // W][0]][i % W] for i in pick])
        lp = torch.stack([state.calls[i // W][1][i % W] for i in pick])
        state.picked = (p, lp.cpu().numpy())
    return state.picked


def release(state):
    """Free the program's state once the check's sample is taken."""
    sample(state)
    state.model = None
    state.calls = []
    state.pool = None


def check(state, cfg, control=False):
    """The compared numbers; with ``control`` the reference computed in
    float32 stands in the program's place."""
    p, prog = sample(state)
    if control:
        stars32 = {k: v.to(torch.float32) for k, v in state.stars.items()}
        prog = ref.lnpost(p.to(torch.float32), common.as_dtype(state.tables, torch.float32), stars32,
                          cfg).cpu().numpy()
    want = ref.lnpost(p, state.tables, state.stars, cfg).cpu().numpy()
    gap, mismatch = common.gaps(prog, want)
    lim = cfg["check"]["limits"]
    return {"lnpost_gap": {"value": gap, "limit": lim["lnpost_gap"]},
            "finite_mismatch": {"value": mismatch, "limit": 0}}
