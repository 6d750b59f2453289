"""Where the time of one cluster ``lnpost_batch`` goes, on one CUDA card.

Run from the repository root:

    python -m scripts.profile_torch_cluster [--calls 20] [--walkers 16] [--out profile_cluster.json]

The 50-star cluster of ``chip_smoke.py`` phases 4-5 on the MIST-scale
synthetic grid in float32. It traces ``--calls`` calls of ``lnpost_batch``
for ``--walkers`` walkers with ``torch.profiler``: wall-clock per call,
device-busy time (sum of kernel times), the idle share, kernel launches per
call, the cluster kernel's share of the device-busy time and the kernels
that take the most device time. Prints a summary, and with ``--out`` writes
the numbers as JSON.
"""

import argparse
import json
import os
import subprocess

import numpy as np
import torch

import isochrones_torch
from chip_smoke import FIXTURE, GRID, MODEL, P0_SCALE, TRUTH, profile_kernels
from isochrones_torch.catalog import read_csv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    ap.add_argument("--calls", type=int, default=20, help="lnpost_batch calls in the traced window")
    ap.add_argument("--walkers", type=int, default=16, help="walkers per call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cluster: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    ic = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    model = isochrones_torch.StarClusterModel(ic, read_csv(FIXTURE), **MODEL)
    p = np.asarray(TRUTH)[None, :] + np.random.default_rng(0).normal(0, P0_SCALE, size=(args.walkers, 7))
    for _ in range(3):
        model.lnpost_batch(p)
    torch.cuda.synchronize()

    wall, by_name = profile_kernels(lambda: model.lnpost_batch(p), args.calls)
    busy_ms = sum(ms for ms, _ in by_name.values())
    cluster_ms = sum(ms for name, (ms, _) in by_name.items() if "cluster_marginal" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = dict(
        device=smi, walkers=args.walkers, calls=args.calls,
        wall_ms_per_call=1e3 * wall / args.calls,
        device_busy_ms_per_call=busy_ms / args.calls,
        idle_share=1.0 - busy_ms / 1e3 / wall,
        kernel_launches_per_call=sum(n for _, n in by_name.values()) / args.calls,
        cluster_kernel_ms_per_call=cluster_ms / args.calls,
        cluster_kernel_share_of_busy=cluster_ms / busy_ms,
        top_kernels=[{"name": k[:90], "ms": v[0], "count": v[1]} for k, v in top],
    )
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in out.items() if k != "top_kernels"}))
    for t in out["top_kernels"]:
        print(f"  {t['ms']:9.3f} ms  {t['count']:6d}x  {t['name']}")


if __name__ == "__main__":
    main()
