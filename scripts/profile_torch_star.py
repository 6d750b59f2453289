"""Where the time of the port's binary-star nested fit goes, on one CUDA card.

Run from the repository root:

    python -m scripts.profile_torch_star [--steps 4] [--out profile_star.json]

The bench's binary at the MIST-scale synthetic grid in float32 (the setup of
``chip_smoke.py`` phases 7-8). It times one ``lnpost_batch`` at the
sampler's batch (n_batch * n_chains = 1024 points) through the kernel and
through the plain path, then traces a steady window of nested-sampling steps
(``_FamilySteps.chunk`` on a family of one, as ``run_nested`` steps a
single run, at n_live 1000, n_batch 64, n_chains 16) with
``torch.profiler``: wall-clock per step, device-busy share (sum of kernel
times over the window), launches per step, the star kernel's time per launch
and share of the device-busy time, and the kernels that take the most device
time. Prints a summary, and with ``--out`` writes the numbers as JSON.
"""

import argparse
import json
import os
import subprocess
import time

import torch

import isochrones_torch
import isochrones_torch.starmodel as star_mod
from chip_smoke import GRID, STAR_BOX, profile_kernels, star_observations, star_points
from isochrones_torch.ops.star import star_lnlike_fused_plain
from isochrones_torch.ops.star_cuda import star_lnlike_cuda
from isochrones_torch.samplers.nested import _FamilySteps

N_LIVE, N_BATCH, N_CHAINS, N_REPEAT = 1000, 64, 16, 24


def _wall_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    ap.add_argument("--steps", type=int, default=4, help="nested steps in the traced window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_star: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    ic = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    model = isochrones_torch.BinaryStarModel(ic, **star_observations(ic))
    out = {"device": smi}

    # one lnpost_batch at the sampler's batch, kernel path and plain path
    p = torch.as_tensor(star_points(ic.model.knots, 2, N_BATCH * N_CHAINS, seed=13, box=STAR_BOX), device=dev,
                        dtype=torch.float32)
    out["lnpost_1024_kernel_ms"] = _wall_ms(lambda: model.lnpost_batch(p), 50)
    dispatch = star_mod.star_lnlike_fused
    star_mod.star_lnlike_fused = star_lnlike_fused_plain  # the plain path, on the card
    try:
        out["lnpost_1024_plain_ms"] = _wall_ms(lambda: model.lnpost_batch(p), 50)
    finally:
        star_mod.star_lnlike_fused = dispatch
    out["lnpost_1024_kernel_ms_again"] = _wall_ms(lambda: model.lnpost_batch(p), 50)

    # a live set as run_nested starts it: uniform draws with finite lnL
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def lnlike_u(u):
        return model.lnpost_batch(model.prior_transform_batch(u))

    def lnlike_fam(u):  # a family of one, as run_nested calls it
        return lnlike_u(u.reshape(-1, model.n_params)).reshape(1, -1)

    u = torch.empty((0, model.n_params), device=dev)
    while u.shape[0] < N_LIVE:
        cand = torch.rand((4 * N_LIVE, model.n_params), generator=g, device=dev)
        u = torch.cat([u, cand[torch.isfinite(lnlike_u(cand))]])
    u = u[:N_LIVE][None].contiguous()
    lnl = lnlike_fam(u)
    scale = torch.full((1,), 0.5, device=dev)
    steps = _FamilySteps(lnlike_fam, g, N_LIVE, N_CHAINS, N_REPEAT, N_BATCH)
    _, _, u, lnl, scale = steps.chunk(u, lnl, scale, 8)
    torch.cuda.synchronize()

    star_lnlike_cuda.launches = 0
    wall, by_name = profile_kernels(
        lambda: steps.chunk(u, lnl, scale, args.steps))
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    star_ms = sum(ms for name, (ms, _) in by_name.items() if "star_lnlike" in name)
    out.update(
        steps=args.steps,
        wall_ms_per_step=1e3 * wall / args.steps,
        device_busy_ms_per_step=busy_ms / args.steps,
        idle_share=1.0 - busy_ms / 1e3 / wall,
        kernel_launches_per_step=sum(n for _, n in by_name.values()) / args.steps,
        star_kernel_launches=star_lnlike_cuda.launches,
        star_kernel_ms_per_launch=star_ms / max(star_lnlike_cuda.launches, 1),
        star_kernel_share_of_busy=star_ms / busy_ms,
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
