"""Time kernel A' against its variant that locates its cells twice, in turns, on one CUDA card.

Run from the repository root:

    python -m scripts.tune_torch_star_grad [--reps 50] [--out FILE]

Builds the library (``isochrones_torch/csrc``: ``carry``, whose A' hands
the model and BC cells that its first pass locates to its second) and, at
the same time, a copy of ``csrc/`` in ``isochrones_torch/_build/`` whose
``star_lnlike.cu`` is ``scripts/star_lnlike_variants.cu`` (``relocate``: A'
locates both cells again in its second pass, by ``group_vjp``), and prints
ptxas's registers, stack and spills of every A' instance of both. Then, on the bench binary of
``chip_smoke.py`` phase 25a (the MIST-scale synthetic grid in float32, the
points of its timings, seeded cotangents) at 4, 8, 1024 and 131072 points,
it holds both to autograd of the plain version (``chip_smoke.check_grad`` at
``RTOL_GRAD_F32``) and times them in turns (relocate, carry, carry,
relocate):
medians of 400 launches at 4 and 8 points (``kernel_ms_spread``), means of
``--reps`` launches above. Prints one line per batch and, with ``--out``,
writes the numbers as JSON.
"""

import argparse
import concurrent.futures
import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

import isochrones_torch
from chip_smoke import (
    GRAD_BATCHES, GRID, LEAF_CHAINS, RTOL_GRAD_F32, STAR_BOX, check_grad, grad_cotangents, grid_as, kernel_ms,
    kernel_ms_spread, plain_grad, star_observations, star_points,
)
from isochrones_torch.ops import _build, star_cuda
from isochrones_torch.ops.star import star_lnlike_fused_plain
from scripts.compare_torch_kernels import Baseline

#: the variant's source: a copy of star_lnlike.cu whose A' locates its cells again
VARIANT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "star_lnlike_variants.cu")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")


def variant_sources():
    """A copy of ``csrc/`` with ``star_lnlike.cu`` replaced by the variant,
    under the git-ignored build directory; returns its path."""
    out = os.path.join(_build.BUILD_DIR, "star_grad_relocate_csrc")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for f in glob.glob(os.path.join(_build.CSRC, "*.cu")) + glob.glob(os.path.join(_build.CSRC, "*.cuh")):
        shutil.copy(f, out)
    shutil.copy(VARIANT, os.path.join(out, "star_lnlike.cu"))
    return out


def grad_lines(log):
    """ptxas's lines for A''s instances: ``[(instance, line), ...]``."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1) if "star_lnlike_grad_kernel" in m.group(1) else None
        elif cur and ("registers" in line or "spill" in line):
            out.append((cur, line.strip()))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50, help="launches a timing at 1024 and 131072 points")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_torch_star_grad: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    src = variant_sources()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        library = pool.submit(_build.build)
        relocate = pool.submit(Baseline.build, src)
        path, secs, log = library.result()
        variant = relocate.result()
    _build.load_library()
    print(f"[build] carry (the library) in {secs:.3f} s, relocate in {variant.seconds:.3f} s")
    ptx = {"carry": grad_lines(log), "relocate": grad_lines(variant.log)}
    for tag, lines in ptx.items():
        for inst, line in lines:
            print(f"[build] {tag} {inst}: {line}")

    ic32 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    ic64 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float64, **GRID)
    lk32 = isochrones_torch.BinaryStarModel(ic32, **star_observations(ic64))._star_likelihood()
    lk32up = dataclasses.replace(lk32, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    results = {"device": smi, "order": ["relocate", "carry", "carry", "relocate"], "ptxas": ptx, "batches": {}}
    for B in GRAD_BATCHES:
        p32 = torch.as_tensor(star_points(ic64.model.knots, 2, B, seed=50, box=STAR_BOX), device=dev,
                              dtype=torch.float32)
        cot = grad_cotangents(B, 2, 52, dev, torch.float32)
        ref = plain_grad(star_lnlike_fused_plain, p32.double(), lk32up, tuple(c.double() for c in cot))
        ref = ref.cpu().numpy()
        runs = {"carry": lambda: star_cuda.star_lnlike_grad_cuda(p32, lk32, *cot),
                "relocate": lambda: variant.run(lambda: star_cuda.star_lnlike_grad_cuda(p32, lk32, *cot))}
        row = {}
        for tag, fn in runs.items():
            got = fn().cpu().numpy()
            row[f"{tag}_err"] = check_grad(f"A' {tag} B={B}", got, ref, RTOL_GRAD_F32)[0]
        same = np.array_equal(runs["carry"]().cpu().numpy(), runs["relocate"]().cpu().numpy(), equal_nan=True)
        times = {"carry": [], "relocate": []}
        for tag in results["order"]:
            if B <= LEAF_CHAINS:
                times[tag].append(kernel_ms_spread(runs[tag], "star_lnlike_grad_kernel")[0])
            else:
                times[tag].append(kernel_ms(runs[tag], "star_lnlike_grad_kernel", reps=args.reps))
        row.update(bitwise_same=bool(same), ms=times)
        results["batches"][str(B)] = row
        print(f"[tune] A' B={B} float32: relocate {np.round(times['relocate'], 5).tolist()} ms (mean "
              f"{np.mean(times['relocate']):.5f}), carry {np.round(times['carry'], 5).tolist()} ms (mean "
              f"{np.mean(times['carry']):.5f}), {np.mean(times['carry']) / np.mean(times['relocate']):.3f}x; "
              f"errors {row['relocate_err']:.3e} / {row['carry_err']:.3e} of the row's scale (rtol "
              f"{RTOL_GRAD_F32}); bitwise the same: {same}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
