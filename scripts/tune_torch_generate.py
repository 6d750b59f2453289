"""Time the forward-model kernel (kernel F) by parts and by design on one CUDA card.

Run from the repository root:

    python -m scripts.tune_torch_generate [--reps 20] [--out FILE]

Builds ``isochrones_torch/csrc/generate.cu`` (with ``generate_f64.cu``) alone into
``isochrones_torch/_build/tune/`` once per variant, every ``nvcc`` started
together: the source as the library builds it (``full``), and the same
source cut by ``-DGEN_PART`` to the EEP alone (``part1``: the inversion, and
in the accurate form the Newton step, with the EEP's store) and to the EEP
with the model lerp and its stores (``part2``). It prints ptxas's registers
and spills for every instantiation (type, compact BC width W, form). Then, at
``chip_smoke.py`` phase 20's shape (the MIST-scale grid in float32,
1,000,000 points of ``chip_smoke.generate_points``, all 15 columns, 11
bands), it takes each variant's device time (``torch.profiler``,
``chip_smoke.kernel_ms``) for the fast form and the accurate form, and for
``full`` also with the 11 bands read from a 16-wide compact BC table (the
width the kernel's first version read), with ``all_As``, and in float64. The parts' differences
split the time into the inversion, the model lerp with its stores, and the
BC lerp with the magnitudes' stores; the accurate form is timed again on
points whose fast EEP is finite (no scan), and the EEP-only accurate forms
(the track grid's; the Newton step on the isochrone grid) alone. Each full measurement is first
held to the plain version (``chip_smoke.check_generate``). Prints one line per
measurement and, with ``--out``, writes them as JSON.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

import isochrones_torch
from chip_smoke import GEN_POINTS, GRID, check_eep, check_generate, generate_points, kernel_ms
from isochrones_torch.ops import _build, generate_cuda as gc
from isochrones_torch.ops.catalog_cuda import compact_table
from isochrones_torch.ops.eep import interp_eep
from isochrones_torch.ops.generate import generate_plain, get_eep_accurate

#: (tag, nvcc defines); "full" is the library's build
VARIANTS = [("full", []), ("part1", ["-DGEN_PART=1"]), ("part2", ["-DGEN_PART=2"])]
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_KERNEL = re.compile(r"generate_kernelI([fd])Li(\d+)ELi(\d)E")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_FORMS = {0: "invert", 1: "given", 2: "eep-only", 3: "accurate", 4: "accurate-eep", 5: "newton"}


def build_variants():
    """Compile every variant; returns ``{tag: (CDLL, {instantiation: (registers, spill bytes)})}``."""
    out_dir = os.path.join(_build.BUILD_DIR, "tune")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    srcs = [os.path.join(_build.CSRC, f) for f in ("generate.cu", "generate_f64.cu")]
    procs = {}
    for tag, defs in VARIANTS:
        path = os.path.join(out_dir, f"generate_{tag}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", *defs, "-o", path, *srcs]
        procs[tag] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {tag}:\n{log}")
        lib = ctypes.CDLL(path)
        for name in ("generate_f32", "generate_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(gc._GenerateArgs), ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.generate_args_size.restype = ctypes.c_int
        if lib.generate_args_size() != ctypes.sizeof(gc._GenerateArgs):
            raise RuntimeError(f"variant {tag}: GenerateArgs layout differs")
        regs, current = {}, None
        for line in log.splitlines():
            m = _ENTRY.search(line)
            if m:
                k = _KERNEL.search(m.group(1))
                current = None if k is None else f"{k.group(1)} W={k.group(2)} {_FORMS[int(k.group(3))]}"
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
    ap.add_argument("--reps", type=int, default=20, help="launches per timing")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_torch_generate: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    built = build_variants()
    results = {"device": smi, "reps": args.reps, "points": GEN_POINTS, "registers": {}, "ms": {}}
    for tag, (_, regs) in built.items():
        results["registers"][tag] = regs
        for inst in sorted(regs):
            print(f"[ptxas] {tag} {inst}: {regs[inst][0]} registers, {regs[inst][1]} bytes spilled")

    ics = {dt: isochrones_torch.get_ichrone("synthetic", device=dev, dtype=dt, **GRID)
           for dt in (torch.float32, torch.float64)}
    track = ics[torch.float64].track
    cols = generate_points(track, GEN_POINTS, seed=20)
    icols = track.model.icols("all")
    bcols = tuple(track.bc.column_index[b] for b in track.bands)

    # the same points with each one whose fast EEP is NaN replaced by one
    # whose is not: the accurate form then scans (almost) nowhere
    fm64 = ics[torch.float64].track._forward_model
    seed = interp_eep(*(torch.as_tensor(c, device=dev) for c in (cols[1], cols[2], cols[0])), *fm64.eep_support,
                      eep0=fm64.eep0).cpu().numpy()
    ok = np.isfinite(seed)
    keep = np.where(ok, np.arange(GEN_POINTS), np.random.default_rng(0).choice(np.flatnonzero(ok), GEN_POINTS))
    finite_cols = [c[keep] for c in cols]

    def launcher(lib, dt, accurate=False, all_As=False, bc16=False, pts=cols):
        """One launch of ``lib``'s kernel as ``generate_cuda`` (or
        ``generate_accurate_cuda``) makes it on ``pts``; ``bc16`` reads the
        bands from a 16-wide compact table."""
        fm = ics[dt].track._forward_model
        x = [torch.as_tensor(c, device=dev, dtype=dt) for c in pts]
        call = gc._GenerateArgs.from_buffer_copy(gc._template(fm, bcols, dt, dev, accurate))
        keep = []
        if bc16:
            table = compact_table(fm.bc, bcols, widths=(16,))
            call.bc, call.bc_ncols = table.data_ptr(), 16
            keep.append(table)
        table, order = gc.packed_model(fm, dt, dev)
        prop_cols, call.read_len = gc.pack_layout(order, icols)
        call.model, call.row_len, call.P = table.data_ptr(), table.shape[-1], len(prop_cols)
        call.prop_cols[:len(prop_cols)] = prop_cols
        call.N, call.resid_tol = GEN_POINTS, 0.02
        gc._point_args(call, x)
        eeps = torch.empty(GEN_POINTS, dtype=dt, device=dev)
        props = torch.empty((GEN_POINTS, len(icols)), dtype=dt, device=dev)
        mags = torch.empty((GEN_POINTS, len(bcols)), dtype=dt, device=dev)
        mags0 = torch.empty_like(mags) if all_As else None
        call.eep, call.props, call.mags = eeps.data_ptr(), props.data_ptr(), mags.data_ptr()
        call.mags0 = None if mags0 is None else mags0.data_ptr()
        fn = lib.generate_f32 if dt == torch.float32 else lib.generate_f64
        stream = torch.cuda.current_stream(dev).cuda_stream
        mode = gc._ACCURATE if accurate else gc._INVERT

        def run():
            err = fn(ctypes.byref(call), mode, stream)
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")
            return eeps, props, mags, mags0

        return run, fm, x, keep

    def measure(label, tag, dt=torch.float32, accurate=False, all_As=False, bc16=False, pts=cols):
        run, fm, x, _keep = launcher(built[tag][0], dt, accurate, all_As, bc16, pts)
        got = run()
        if not tag.startswith("part"):
            # the columns at the kernel's own EEPs; the fast EEP against
            # interp_eep, the accurate one (float64) against the plain Newton step
            ref = generate_plain(fm, *x, icols, bcols, eeps=got[0], all_As=all_As)
            e_ref = got[0] if accurate else interp_eep(x[1], x[2], x[0], *fm.eep_support, eep0=fm.eep0)
            check_generate(label, got, (e_ref,) + tuple(ref[1:]), "float64" if dt == torch.float64 else "float32")
            if accurate and dt == torch.float64:
                check_eep(label, got[0].cpu().numpy(), get_eep_accurate(fm, *x[:3]).cpu().numpy())
        ms = kernel_ms(run, "generate_kernel", reps=args.reps)
        results["ms"][label] = ms
        print(f"[tune] {label}: {ms:.5f} ms")
        return ms

    for accurate in (False, True):
        form = "accurate" if accurate else "fast"
        t = {tag: measure(f"{tag} {form}", tag, accurate=accurate) for tag, _ in VARIANTS}
        split = {"EEP": t["part1"], "model lerp and stores": t["part2"] - t["part1"],
                 "BC lerp and stores": t["full"] - t["part2"]}
        results[f"split {form}"] = split
        print(f"[tune] split of the {form} form (ms): {json.dumps({k: round(v, 5) for k, v in split.items()})}")
    print(f"[tune] points whose fast EEP is NaN (the accurate form scans for those on the grid): "
          f"{int((~ok).sum())} of {GEN_POINTS}")
    for tag in ("part1", "full"):
        measure(f"{tag} accurate, no NaN fast EEP", tag, accurate=True, pts=finite_cols)
    # the EEP-only accurate forms: the track grid's, and the Newton step from
    # EEP 300 on the isochrone grid; each bitwise the library's own launch
    ng = ics[torch.float32]._newton_grid
    x32 = [torch.as_tensor(c, device=dev, dtype=torch.float32) for c in cols[:3]]
    seed = torch.full_like(x32[0], 300.0)
    lib_out = {gc._ACCURATE_EEP: gc.get_eep_accurate_cuda(ics[torch.float32].track._forward_model, *x32),
               gc._NEWTON: gc.eep_newton_cuda(ng, seed, *x32)}

    def eep_form(label, tag, mode):
        if mode == gc._ACCURATE_EEP:
            base, xs = gc._template(ics[torch.float32].track._forward_model, (), torch.float32, dev, True), x32
        else:
            base, xs = gc._CACHE[ng][("newton", torch.float32, dev)][0], x32 + [seed]
        call = gc._GenerateArgs.from_buffer_copy(base)
        call.N, call.resid_tol = GEN_POINTS, 0.02
        gc._point_args(call, xs)
        out = torch.empty(GEN_POINTS, dtype=torch.float32, device=dev)
        call.eep = out.data_ptr()
        fn, stream = built[tag][0].generate_f32, torch.cuda.current_stream(dev).cuda_stream

        def run():
            err = fn(ctypes.byref(call), mode, stream)
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")
            return out

        if not torch.equal(run().nan_to_num(-1.0), lib_out[mode].nan_to_num(-1.0)):
            raise AssertionError(f"{label}: differs from the library's launch")
        ms = kernel_ms(run, "generate_kernel", reps=args.reps)
        results["ms"][label] = ms
        print(f"[tune] {label}: {ms:.5f} ms")

    eep_form("full accurate EEP alone", "full", gc._ACCURATE_EEP)
    eep_form("full Newton step, isochrone grid", "full", gc._NEWTON)
    measure("full fast, 16-wide BC table", "full", bc16=True)
    measure("full fast all_As", "full", all_As=True)
    measure("full fast float64", "full", dt=torch.float64)
    measure("full accurate float64", "full", dt=torch.float64, accurate=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
