"""Measure the catalog kernel's launch bounds and band-table widths on one CUDA card.

Run from the repository root:

    python -m scripts.tune_torch_catalog [--reps 50] [--out FILE]

Builds ``isochrones_torch/csrc/catalog_lnlike.cu`` alone into
``isochrones_torch/_build/tune/`` once per variant of the ``__launch_bounds__``
minimum of blocks a SM (``-DCATALOG_MIN_BLOCKS``: 1, 2, 3, 4, 5 (the
source's own), 6 and 8), every ``nvcc`` started together. It prints ptxas's
registers and spills for every instantiation (type, compact BC table width
W, posterior or likelihood) with the occupancy those registers allow. Then,
on the smoke run's 256-star catalogue at the MIST-scale grid in float32
(``chip_smoke.catalog_table``), it takes the posterior kernel's device time
(``torch.profiler``, ``chip_smoke.kernel_ms``) for every variant at the
catalog fits' batches, (256, 256) and (256, 32) parameters; for the
source's own variant also at smaller batches (16 stars x 64 points, the
CLI's fit, and 4 x 64, 256 x 16), the unit-cube form at (256, 256), the
likelihood instantiation, and the posterior with 6 and 15 bands (the 8- and
16-wide compact tables). Each measurement is first held to the plain
version (the smoke's float32 tolerances). Prints one line per measurement
and, with ``--out``, writes them as JSON.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess

import torch

import isochrones_torch
from chip_smoke import (
    ATOL_STAR_F32, CAT_BANDS, CAT_EEP_BOX, CAT_STARS, GRID, RTOL_STAR_F32, catalog_likelihood_as, catalog_points,
    catalog_priors_as, catalog_table, catalog_unit_points, check_star, kernel_ms,
)
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.ops import _build, catalog_cuda
from isochrones_torch.ops.catalog import catalog_lnlike_plain, catalog_lnpost_plain, unit_box

#: (tag, CATALOG_MIN_BLOCKS); mb5 is the source's own
VARIANTS = [("mb5", 5), ("mb1", 1), ("mb2", 2), ("mb3", 3), ("mb4", 4), ("mb6", 6), ("mb8", 8)]
DEFAULT = "mb5"
BATCHES = (256, 32)
#: (stars, points) below the fits' batches, timed with the default variant
SMALL = ((16, 64), (4, 64), (256, 16))
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_KERNEL = re.compile(r"catalog_lnlike_kernelI([fd])Li(\d+)ELb([01])E")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _occupancy(regs, threads=128):
    """Share of the SM's 2048 threads that blocks of ``threads`` can hold
    at ``regs`` registers a thread (allocated in units of 8), registers
    alone."""
    blocks = min(2048 // threads, 65536 // (-(-regs // 8) * 8 * threads))
    return blocks * threads / 2048


def build_variants():
    """Compile every variant; returns ``{tag: (CDLL, {instantiation: (registers, spill bytes)})}``."""
    out_dir = os.path.join(_build.BUILD_DIR, "tune")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    src = os.path.join(_build.CSRC, "catalog_lnlike.cu")
    procs = {}
    for tag, mb in VARIANTS:
        path = os.path.join(out_dir, f"catalog_{tag}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", f"-DCATALOG_MIN_BLOCKS={mb}", "-o", path, src]
        procs[tag] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {tag}:\n{log}")
        lib = ctypes.CDLL(path)
        for name in ("catalog_lnpost_f32", "catalog_lnlike_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(catalog_cuda._CatalogArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if lib.catalog_lnlike_args_size() != ctypes.sizeof(catalog_cuda._CatalogArgs):
            raise RuntimeError(f"variant {tag}: CatalogArgs layout differs")
        regs, current = {}, None
        for line in log.splitlines():
            m = _ENTRY.search(line)
            if m:
                k = _KERNEL.search(m.group(1))
                kind = "post" if k is not None and k.group(3) == "1" else "lnlike"
                current = None if k is None else f"{k.group(1)}{k.group(2)}{kind}"
                continue
            if current is None:
                continue
            s = _SPILL.search(line)
            if s:
                regs.setdefault(current, [0, 0])[1] = int(s.group(1)) + int(s.group(2))
            r = _REGS.search(line)
            if r:
                regs.setdefault(current, [0, 0])[0] = int(r.group(1))
        built[tag] = (lib, regs)
    return built


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50, help="launches per timing")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_torch_catalog: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    built = build_variants()
    results = {"device": smi, "reps": args.reps, "registers": {}, "ms": {}}
    for tag, (_, regs) in built.items():
        results["registers"][tag] = regs
        for inst in sorted(regs):
            r, spill = regs[inst]
            print(f"[ptxas] {tag} {inst}: {r} registers, {spill} bytes spilled, register-bound occupancy "
                  f"{_occupancy(r):.3f}")

    ic32 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    truths, table = catalog_table(ic32, CAT_STARS, CAT_EEP_BOX)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def catalog(n_stars):
        """The first ``n_stars`` stars: likelihood, priors, their float64
        copies, points, unit-cube points and box tops."""
        fitter = BatchStarFitter(ic32, {k: v[:n_stars] for k, v in table.items()}, bands=CAT_BANDS)
        lk, pri = fitter._catalog_likelihood(), fitter._catalog_priors()
        pts = torch.as_tensor(catalog_points(ic32, truths[:n_stars], max(BATCHES), seed=16), device=dev,
                              dtype=torch.float32)
        los, his = fitter._bounds_arrays()
        u = torch.as_tensor(catalog_unit_points(truths[:n_stars], los, his, max(BATCHES), seed=17), device=dev,
                            dtype=torch.float32)
        return dict(lk=lk, pri=pri, lkup=catalog_likelihood_as(lk, torch.float64),
                    priup=catalog_priors_as(pri, torch.float64), pts=pts, u=u,
                    his=torch.as_tensor(his, device=dev, dtype=torch.float32))

    def launcher(c, lib, x, his=None, post=True):
        base = catalog_cuda._post_template(c["lk"], c["pri"], torch.float32, dev) if post else \
            catalog_cuda._template(c["lk"], torch.float32, dev)
        outs = [torch.empty(x.shape[:2], dtype=torch.float32, device=dev) for _ in range(1 if post else 3)]
        call = catalog_cuda._CatalogArgs.from_buffer_copy(base)
        call.pars, call.out = x.data_ptr(), outs[0].data_ptr()
        call.S, call.B = x.shape[0], x.shape[1]
        call.his = None if his is None else his.data_ptr()
        if not post:
            call.orig, call.deriv = outs[1].data_ptr(), outs[2].data_ptr()
        fn = lib.catalog_lnpost_f32 if post else lib.catalog_lnlike_f32

        def run():
            err = fn(ctypes.byref(call), stream)
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")
            return outs

        return run

    def measure(label, c, lib, x, his=None, post=True):
        run = launcher(c, lib, x, his, post)
        got = [o.cpu().numpy() for o in run()]
        px = x if his is None else unit_box(x, c["pri"], his)
        ref = ([catalog_lnpost_plain(px.double(), c["lkup"], c["priup"])[0]] if post
               else list(catalog_lnlike_plain(px.double(), c["lkup"])))
        err = check_star(label, got, [r.cpu().numpy() for r in ref], RTOL_STAR_F32, ATOL_STAR_F32)
        ms = kernel_ms(run, "catalog_lnlike", reps=args.reps)
        results["ms"][label] = ms
        print(f"[tune] {label}: {ms:.5f} ms (max_abs_err {err:.3e})")
        return ms

    def widened(c, reps):
        """The catalogue with its bands repeated ``reps`` times."""
        lk = c["lk"]
        wide = dataclasses.replace(lk, band_icols=lk.band_icols * reps, mag_vals=lk.mag_vals.repeat(1, reps),
                                   mag_uncs=lk.mag_uncs.repeat(1, reps))
        return dict(c, lk=wide, lkup=catalog_likelihood_as(wide, torch.float64))

    full = catalog(CAT_STARS)
    for tag, (lib, _) in built.items():
        for B in BATCHES:
            measure(f"{tag} posterior B={B}", full, lib, full["pts"][:, :B].contiguous())
    lib0 = built[DEFAULT][0]
    for n_stars, B in SMALL:
        c = catalog(n_stars)
        measure(f"{DEFAULT} posterior S={n_stars} B={B}", c, lib0, c["pts"][:, :B].contiguous())
    measure(f"{DEFAULT} posterior unit cube B=256", full, lib0, full["u"], his=full["his"])
    for B in BATCHES:
        x = full["pts"][:, :B].contiguous()
        measure(f"{DEFAULT} likelihood B={B}", full, lib0, x, post=False)
        for reps in (2, 5):
            c = widened(full, reps)
            measure(f"{DEFAULT} posterior {len(c['lk'].band_icols)} bands (W="
                    f"{catalog_cuda.compact_bc(c['lk']).shape[-1]}) B={B}", c, lib0, x)
    for B in BATCHES:
        best = min(((v, k) for k, v in results["ms"].items() if k.endswith(f" posterior B={B}")))
        print(f"[tune] fastest launch bounds at B={B}: {best[1]} {best[0]:.5f} ms; the source's {DEFAULT}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
