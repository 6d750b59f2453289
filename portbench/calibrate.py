"""The readings that the check's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds <n,n,...> --seconds <s> [--fault <kind>]

One process sets the cell up once, then for each seed draws that seed's
inputs, runs a window of ``--seconds`` (with ``--fault``, a fault of
``portbench.faults`` planted under it) and prints one JSON line: the
numbers the check compares and the verdict that ``portbench.run`` gives on
them (``correct``), for the program (with ``--fault``, the program with the
fault planted) and for the control (the reference computed in float32 in the
program's place). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch

from . import faults, run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    wl, cfg, traffic = run.cell_spec(run.load_json("BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    seeds = [int(s) for s in args.seeds.split(",")]
    state = driver.setup(cfg, traffic, seeds[0], device)
    for seed in seeds:
        driver.reseed(state, seed)
        planted = faults.plant(args.fault, cfg["family"]) if args.fault else contextlib.nullcontext()
        t0 = time.perf_counter()
        with planted:
            driver.measure(state, args.seconds)
        t1 = time.perf_counter()
        program = driver.check(state, cfg)
        control = driver.check(state, cfg, control=True)
        print(json.dumps({"seed": seed, "fault": args.fault, "window_s": t1 - t0, "check_s": time.perf_counter() - t1,
                          "program": {k: v["value"] for k, v in program.items()},
                          "program_correct": run.verdict(program),
                          "control": {k: v["value"] for k, v in control.items()},
                          "control_correct": run.verdict(control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
