"""Time kernel B's design steps at the cluster ladder's call, in turns, on one CUDA card.

Run from the repository root:

    python -m scripts.tune_torch_interp [--parent DIR] [--reps 20] [--out FILE]

Builds ``isochrones_torch/csrc/interp_nd.cu`` (with ``interp_nd_f64.cu``)
alone into ``isochrones_torch/_build/tune_interp/`` as the library builds it
(``final``), and the variants the library does not keep from this script's
own copy of the kernel, ``scripts/interp_nd_variants.cu``, every ``nvcc``
started together: with ``-DINTERP_STAGED_IO=1`` (``staged``: the points in
by 16-byte cp.async copies and the values out 16 bytes a store, through
shared memory), with ``-DINTERP_SHARED_LOCATE=1`` (``shared``:
``interp_common.cuh``'s cell search, in 64-bit cells, whose exact_affine
search always takes its second step), with ``-DINTERP_PART=1`` (``search``:
the cell search without the gathers) and with ``-DINTERP_CHUNK_UNROLL=n``;
with ``--parent DIR`` also that directory's ``interp_nd.cu`` (another
version, e.g. the parent commit's first design). It prints each
build's seconds, the static instruction mix of the ladder's instance
(``cuobjdump -sass``) and ptxas's registers, stack and spills for every
instantiation of kernel B. Then, at the cluster ladder's call of
``chip_smoke.py`` phase 26 (W = 1024 walkers of the 50-star cluster, points
(1024, 700, 3), the mass pair, the MIST-scale grid in float32), it holds
every step to the plain version (``chip_smoke.check_interp``) and times them
in turns (``torch.profiler``; the order, then reversed):

- ``parent``: the other version;
- ``s1 64-bit``: ``final`` with 64-bit offsets and cells (the wide
  instance), chunks of 8 columns, the row layout (the first design's
  choices, in the new code);
- ``s2 32-bit``: ``s1`` with 32-bit offsets and the lane's 32-bit cell
  search;
- ``s3 exact columns``: ``s2`` with the exact 2-column instance;
- ``s4 planar``: ``s3`` reading the column-planar copy (the ladder's design);
- ``s3 staged`` and ``s4 staged``: ``s3`` and ``s4`` from ``staged``;
- ``s4 shared search``: ``s4`` from ``shared``;
- ``s4 cell search alone``: ``s4`` from ``search`` (not held to the plain
  version: it writes no lerp);

beside ``torch.nn.functional.grid_sample`` on the same work (its kernel's
device time); and at the every-column call of phase 26 (100,000 seeded
points, all 15 columns, the row layout: the chunked instance), the other
version and builds with the chunked instances' corner loop unrolled 1, 2
(``final``), 4 and 8 times (``-DINTERP_CHUNK_UNROLL=n``). The steps are
forced through the wrapper's ``launch_choice`` and the library it loads.
Prints one line per measurement and, with ``--out``, writes them as JSON.
"""

import argparse
import contextlib
import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

import isochrones_torch
from chip_smoke import (
    ATOL_INTERP_F32, FIXTURE, GRID, INTERP_LADDER_W, INTERP_VALUE_POINTS, MODEL, P0_SCALE, TRUTH, check_interp,
    grid_sample_input, interp_points, interp_scale, kernel_ms, ladder_points,
)
from isochrones_torch.catalog import read_csv
from isochrones_torch.ops import _build, interp_cuda
from isochrones_torch.ops.interp import interp_nd_plain
from scripts.compare_torch_kernels import Baseline, using

#: the variants' source: a copy of kernel B with the switches below
VARIANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "interp_nd_variants.cu")
#: (tag, nvcc defines); every tag but "final" builds from VARIANTS
BUILDS = [("final", []), ("staged", ["-DINTERP_STAGED_IO=1"]), ("shared", ["-DINTERP_SHARED_LOCATE=1"]),
          ("search", ["-DINTERP_PART=1"])] + [(f"unroll {n}", [f"-DINTERP_CHUNK_UNROLL={n}"]) for n in (1, 4, 8)]
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_table(log, pattern):
    """``{mangled name: (registers, stack bytes, spill stores)}`` of the
    entries whose name matches ``pattern`` in an ``nvcc -Xptxas -v`` log."""
    out, current = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if current is None:
            continue
        m = _PROPS.search(line)
        if m:
            out.setdefault(current, [None, None, None])[1:] = [int(m.group(1)), int(m.group(2))]
        m = _REGS.search(line)
        if m:
            out.setdefault(current, [None, None, None])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


#: the ladder's instance: float32, 3 axes, 2 columns, 32-bit offsets (the
#: other version: float32, 3 axes)
LADDER_KERNEL = r"interp_nd_kernelIfLi3E(?:Li2ELb0E)?E"
_INSN = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(lib_path, pattern=LADDER_KERNEL):
    """Static opcode counts (``cuobjdump -sass``, modifiers dropped) of the
    kernel whose mangled name matches ``pattern``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    for func in sass.split("Function : ")[1:]:
        if re.search(pattern, func.split("\n", 1)[0]):
            counts = {}
            for m in _INSN.finditer(func):
                op = m.group(1).split(".")[0]
                counts[op] = counts.get(op, 0) + 1
            return dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    return {}


def build(parent_dir=None):
    """Compile the builds (and the other version); returns ``{tag: (CDLL,
    ptxas table)}``."""
    out_dir = os.path.join(_build.BUILD_DIR, "tune_interp")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    library = [os.path.join(_build.CSRC, f) for f in ("interp_nd.cu", "interp_nd_f64.cu")]
    jobs = [(tag, defs if tag == "final" else [f"-I{_build.CSRC}", *defs], library if tag == "final" else [VARIANTS])
            for tag, defs in BUILDS]
    if parent_dir:  # its float64 unit too where it has one
        jobs.append(("parent", [], [os.path.join(parent_dir, f) for f in ("interp_nd.cu", "interp_nd_f64.cu")
                                    if os.path.exists(os.path.join(parent_dir, f))]))
    procs = {}
    t0 = time.perf_counter()
    for tag, defs, srcs in jobs:
        path = os.path.join(out_dir, f"interp_{tag.replace(' ', '_')}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", *defs, "-o", path, *srcs]
        procs[tag] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
        print(f"[build] {tag}: done {time.perf_counter() - t0:.1f} s after the start")
        sass = sass_counts(path)
        print(f"[sass] {tag}, the ladder's instance: {sum(sass.values())} instructions {json.dumps(sass)}")
        built[tag] = (ctypes.CDLL(path), ptxas_table(log, r"interp_nd_kernel"))
    return built


@contextlib.contextmanager
def forced(choice):
    """``interp_cuda.launch_choice`` forced to ``choice(table_len, ncols,
    ndim)`` inside the block."""
    saved = interp_cuda.launch_choice
    interp_cuda.launch_choice = choice
    try:
        yield
    finally:
        interp_cuda.launch_choice = saved


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="a directory holding another version's interp_nd.cu")
    ap.add_argument("--reps", type=int, default=20, help="calls per timing")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_torch_interp: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    built = build(args.parent)
    for tag, (_, table) in built.items():
        for name, (regs, stack, spill) in sorted(table.items()):
            print(f"[ptxas] {tag} {name}: {regs} registers, {stack} bytes stack, {spill} bytes spill stores")

    ic = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    g = ic.model
    ci = g.column_index
    rng = np.random.default_rng(1)
    pw = np.asarray(TRUTH)[None, :] + rng.normal(0, P0_SCALE, size=(INTERP_LADDER_W, 7))
    gp = ladder_points(isochrones_torch.StarClusterModel(ic, read_csv(FIXTURE), **MODEL), pw)
    icols = (ci["initial_mass"], ci["dm_deep"])
    ref = interp_nd_plain(g.values, g.knots, gp, icols=icols, axis_maps=g.axis_maps)
    scale = interp_scale(g.values, icols)

    def new(tag, choice, use_planar):
        lib = built[tag][0]

        def run():
            with using(lib), forced(choice):
                return interp_cuda.interp_nd_cuda(g.values, g.knots, gp, icols=icols, axis_maps=g.axis_maps,
                                                  planar=use_planar)
        return run

    steps = {
        "s1 64-bit": new("final", lambda n, c, d: (interp_cuda.CHUNK, True), False),
        "s2 32-bit": new("final", lambda n, c, d: (interp_cuda.CHUNK, False), False),
        "s3 exact columns": new("final", lambda n, c, d: (c, False), False),
        "s4 planar": new("final", lambda n, c, d: (c, False), True),
        "s3 staged": new("staged", lambda n, c, d: (c, False), False),
        "s4 staged": new("staged", lambda n, c, d: (c, False), True),
        "s4 shared search": new("shared", lambda n, c, d: (c, False), True),
        "s4 cell search alone": new("search", lambda n, c, d: (c, False), True),
    }
    if "parent" in built:
        parent = Baseline(built["parent"][0])
        steps = {"parent": lambda: parent.interp(g.values, g.knots, gp, icols, g.axis_maps, planar=True), **steps}
    results = {"device": smi, "reps": args.reps, "shape": list(gp.shape), "columns": list(icols),
               "ptxas": {tag: {k: list(v) for k, v in t.items()} for tag, (_, t) in built.items()}, "max_abs_err": {},
               "ms": {}}
    for name, run in steps.items():
        if "cell search alone" not in name:
            results["max_abs_err"][name] = check_interp(name, run(), ref, scale, 0.0, ATOL_INTERP_F32)
    vol, sg = grid_sample_input(g, gp, icols)
    order = list(steps) + ["grid_sample"]
    for name in order + order[::-1]:
        if name == "grid_sample":
            ms = kernel_ms(lambda: F.grid_sample(vol, sg, mode="bilinear", align_corners=True), "grid_sampler",
                           reps=args.reps)
        else:
            ms = kernel_ms(steps[name], "interp_nd_kernel", reps=args.reps)
        results["ms"].setdefault(name, []).append(ms)
    for name in order:
        t = results["ms"][name]
        print(f"[tune] {name}: {np.round(t, 4).tolist()} ms (mean {np.mean(t):.4f})"
              + (f", max_abs_err {results['max_abs_err'][name]:.3e}" if name in results["max_abs_err"] else ""))

    # the every-column call: the chunked instance
    vp = torch.as_tensor(interp_points(g.knots, INTERP_VALUE_POINTS, seed=26), device=dev, dtype=torch.float32)
    vref = interp_nd_plain(g.values, g.knots, vp, axis_maps=g.axis_maps)

    def every(tag):
        def run():
            with using(built[tag][0]):
                return interp_cuda.interp_nd_cuda(g.values, g.knots, vp, axis_maps=g.axis_maps)
        return run

    calls = {tag: every(tag) for tag in ["final"] + [t for t, _ in BUILDS if t.startswith("unroll")]}
    if "parent" in built:
        calls = {"parent": lambda: parent.interp(g.values, g.knots, vp, None, g.axis_maps), **calls}
    results["every_column"] = {"points": INTERP_VALUE_POINTS, "max_abs_err": {}, "ms": {}}
    for name, run in calls.items():
        results["every_column"]["max_abs_err"][name] = check_interp(f"every column {name}", run(), vref,
                                                                    interp_scale(g.values), 0.0, ATOL_INTERP_F32)
    for name in list(calls) + list(calls)[::-1]:
        results["every_column"]["ms"].setdefault(name, []).append(kernel_ms(calls[name], "interp_nd_kernel",
                                                                            reps=args.reps))
    for name, t in results["every_column"]["ms"].items():
        print(f"[tune] every column ({INTERP_VALUE_POINTS} points, 15 columns) {name}: {np.round(t, 4).tolist()} ms "
              f"(mean {np.mean(t):.4f})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
