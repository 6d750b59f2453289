"""Two orders of issuing the four-card cluster call, each timed with and
without the profiler.

Run from the repository root:

    python scripts/probe_mesh_issue_order.py [--seconds 10] [--tiny] [--out FILE]

Sets up the benchmark cell ``cluster200.evals1024.4chip`` (200 members, the
star axis over the first four cards) and measures two ways of issuing
``StarClusterModel.lnpost_batch`` over the mesh:

- ``program``: ``_build_sharded_lnlike`` as the package has it, where the
  walkers are copied to every card before any shard's work is issued;
- ``copy_in_loop``: the same shards, each copying the walkers to its card
  just before its own work, as the package issued them before the order
  changed. A copy between cards runs on the source card's stream, so the
  copies to cards 1-3 wait behind shard 0's work on card 0 and the cards
  take turns: this order reproduces the serial timeline (about half the
  program's rate and 2 cards busy at once instead of 4).

For each order, installed afresh (the model's cached functions dropped):

- ``evals_per_s``: the cell's untraced window (``cluster_mesh.measure``),
  which ends with a synchronise of every card;
- ``call_ms_synced``: the median host time of calls each bracketed by a
  synchronise of every card, with no profiler;
- ``shard_alone_ms``: each card's shard issued alone on its card, timed the
  same way; ``concurrent_from_clock`` is their sum over ``call_ms_synced``,
  the cards busy at once as the host clock sees it;
- the traced window (``cluster_mesh.traced``): ``cards_concurrent``,
  ``idle_share``, each card's busy seconds and the median call time from the
  device events, as the benchmark's readers compute them;
- ``bitwise_same``: whether the first calls' log-posteriors equal the other
  order's at the same walkers.

Prints each card's name and power limit (from ``nvidia-smi``) and one JSON
line per order (program, copy_in_loop, program again). ``--tiny`` runs a
small grid and ladder on four CPU shards, to try the script without a card;
its times mean nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from isochrones_torch import cluster as C  # noqa: E402
from isochrones_torch.tracing import span  # noqa: E402
from portbench import run  # noqa: E402
from portbench.drivers import cluster_mesh  # noqa: E402

CELL = "cluster200.evals1024.4chip"


def _copy_in_loop(self, obs, mesh):
    """``_build_sharded_lnlike`` with each shard's copy of the walkers issued
    just before that shard's work."""
    from isochrones_torch.parallel import mesh_constrain_leading, replicas

    reps = replicas(self, mesh)
    fns = {d: m._build_block_lnmarg() for d, m in reps.items()}
    stacks = mesh_constrain_leading(obs, mesh)
    shards = [(fns[d], d, st) for d, st in zip(mesh.devices, stacks) if st[0].shape[0] > 0]
    first = mesh.devices[0]

    def lnlike_flat(flat):
        parts = []
        for fn, d, st in shards:
            with span("cluster.shard"):
                parts.append(C._finite_sum(fn(flat.to(d), *st)))
        with span("cluster.gather"):
            total, n_bad = (x.to(first) for x in parts[0])
            for part, bad in parts[1:]:
                total = total + part.to(first)
                n_bad = n_bad + bad.to(first)
            return torch.where(n_bad > 0, float("-inf"), total)

    def star_lnmarg(p):
        return torch.cat([fn(p.to(d), *st).to(first) for fn, d, st in shards], dim=1)

    return lnlike_flat, star_lnmarg, max(st[0].shape[0] for _, _, st in shards)


ORDERS = {"program": C.StarClusterModel._build_sharded_lnlike, "copy_in_loop": _copy_in_loop}


@contextlib.contextmanager
def issue_order(model, name):
    """Install one order of issue on ``model``; restore the package's on exit."""
    C.StarClusterModel._build_sharded_lnlike = ORDERS[name]
    model._fn_cache = {}
    try:
        yield
    finally:
        C.StarClusterModel._build_sharded_lnlike = ORDERS["program"]
        model._fn_cache = {}


def _synced_ms(state, fn, n):
    """Median host milliseconds of ``fn()``, each call between two
    synchronises of every card."""
    times = []
    for _ in range(n):
        state.sync()
        t0 = time.perf_counter()
        fn()
        state.sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _shard_alone_ms(state, walkers, n):
    """``{"<shard> <device>": ms}``: each shard's copy of the walkers and its
    work, issued alone on its card."""
    from isochrones_torch.parallel import mesh_constrain_leading, replicas

    model, mesh = state.model, state.mesh
    reps = replicas(model, mesh)
    obs = tuple(torch.as_tensor(x, dtype=model.dtype, device=model.device)
                for x in model.stars.observation_stacks())
    stacks = mesh_constrain_leading(obs, mesh)
    out = {}
    for i, (d, st) in enumerate(zip(mesh.devices, stacks)):
        if st[0].shape[0] == 0:
            continue
        fn = reps[d]._build_block_lnmarg()
        fn(walkers.to(d), *st)  # its first call makes the card's planar copies
        out[f"{i} {d}"] = _synced_ms(state, lambda: C._finite_sum(fn(walkers.to(d), *st)), n)
    return out


def probe(state, order, seconds, n_synced, first):
    model = state.model
    with issue_order(model, order):
        cluster_mesh.reseed(state, state.seed)
        model.lnpost_batch(state.pool[0])
        state.sync()
        got = cluster_mesh.measure(state, seconds)
        n_calls = len(state.calls)
        lps = torch.stack([lp for _, lp in state.calls[:4]]).cpu()
        ref = first.get(state.seed)
        same = None if ref is None else bool(torch.equal(ref[:len(lps)], lps[:len(ref)]))
        first.setdefault(state.seed, lps)
        call_ms = _synced_ms(state, lambda: model.lnpost_batch(state.pool[1]), n_synced)
        cluster_mesh.reseed(state, state.seed)
        ctx = cluster_mesh.traced(state, seconds)
    tr = ctx.trace
    traced_ms = statistics.median(ctx.call_s) * 1e3 if ctx.call_s else None
    return {"order": order, "seed": state.seed, "evals_per_s": got.values["posterior_evals_per_s"],
            "calls": n_calls, "call_ms_synced": call_ms, "bitwise_same": same,
            "traced": {"calls": ctx.n_calls, "cards_concurrent": tr.concurrency(),
                       "idle_share": 1 - tr.busy_s / tr.window_s,
                       "card_busy_s": {str(k): v for k, v in tr.card_busy_s().items()}, "call_ms_median": traced_ms}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=10.0, help="each window's length")
    ap.add_argument("--synced-calls", type=int, default=9, help="calls timed between synchronises")
    ap.add_argument("--seed", type=int, default=2654435761)
    ap.add_argument("--tiny", action="store_true", help="a small grid and ladder on four CPU shards")
    ap.add_argument("--out", default=None, help="append the JSON lines here too")
    args = ap.parse_args(argv)

    bench = run.load_json("BENCHMARK.json")
    _, cfg, traffic = run.cell_spec(bench, CELL)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    if args.tiny:
        cfg["grid"].update(n_feh=5, n_mass=20, n_age=30)
        cfg["model"]["eep_step"] = 20.0
        traffic.update(walkers=8, batches=4)
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("probe_mesh_issue_order: no CUDA card (try --tiny)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout, end="", flush=True)
        device = torch.device("cuda", 0)
    state = cluster_mesh.setup(cfg, traffic, args.seed, device)
    first = {}
    lines = []
    for order in ("program", "copy_in_loop", "program"):
        line = probe(state, order, args.seconds, args.synced_calls, first)
        if order == "program" and lines:
            line["order"] = "program_again"
        lines.append(line)
    alone = _shard_alone_ms(state, state.pool[1], args.synced_calls)
    for line in lines:
        line["shard_alone_ms"] = alone
        line["concurrent_from_clock"] = sum(alone.values()) / line["call_ms_synced"] if alone else None
    for line in lines:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
