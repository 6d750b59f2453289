"""Run one cell of the benchmark of ``isochrones_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration file and its
traffic mix are found by name through ``BENCHMARK.json``; the traffic's
``driver`` names the module of ``portbench/drivers/`` that sets the cell up,
measures its window and checks its outputs against the reference. With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each read by the module of
``portbench/metrics/`` of the metric's name from the traced window. The
numbers the check compared, each beside its limit, are the last lines of
standard error and the last key of the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import ROOT  # noqa: E402
HERE = os.path.join(ROOT, "portbench")
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "isochrones_tpu")


def load_json(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def verdict(checks):
    """``correct``: every compared number within its limit. A number that is
    not finite (a comparison that found nothing to compare) fails, and is
    written as 1e300 in ``checks``, since JSON holds no inf or NaN."""
    for c in checks.values():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300
    return all(c["value"] <= c["limit"] for c in checks.values())


def cell_spec(bench, workload):
    """``(workload entry, configuration dict, traffic dict)`` of a cell."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return wl, load_json(entry["file"]), load_json(os.path.join("portbench", "traffic", wl["traffic"] + ".json"))


def _for_cell(metrics, workload):
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def read_metric(name, ctx):
    """The value of the per-layer metric ``name`` on a traced window, or None."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def run_cell(bench, wl, cfg, traffic, seed, seconds, trace, device):
    """Set up, measure and check one cell on ``device``; returns the result
    dict (without the device's description) and the checks."""
    import torch

    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    state = driver.setup(cfg, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    if trace:
        ctx = driver.traced(state, seconds)
        metrics = {}
        for m in _for_cell(bench["per_layer"], wl["name"]):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out = {"attempted": ctx.attempted, "failed": ctx.failed, "metrics": metrics,
               "trace": ctx.trace}
    else:
        got = driver.measure(state, seconds)
        got.values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(got.values[m["name"]]), "unit": m["unit"]}
                   for m in _for_cell(bench["end_to_end"], wl["name"])}
        out = {"attempted": got.attempted, "failed": got.failed, "metrics": metrics, "trace": None}
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    out["compile_s"] = state.compile_s
    driver.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(state, cfg)
    return out, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json("BENCHMARK.json")
    wl, cfg, traffic = cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out, checks = run_cell(bench, wl, cfg, traffic, args.seed, args.seconds, bool(args.trace), device)

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    correct = verdict(checks)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": out["metrics"],
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": wl["chips"],
                         "memory_peak_bytes": out["memory_peak_bytes"]},
              "compile_s": out["compile_s"]}
    tr = out["trace"]
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
