"""Time the port's CUDA kernels against another version of their sources, in
turns, on one CUDA card.

Run from the repository root:

    python -m scripts.compare_torch_kernels [--baseline DIR ...] [--reps 20] [--out FILE]

Builds ``isochrones_torch/csrc`` and, with ``--baseline``, the ``*.cu`` files
of each DIR (other versions of the same sources with the same C entry
points, e.g. a parent commit's, labelled by the directory's name) with the
same nvcc flags, and prints each build's register, spill and shared-memory
lines and the instruction mix (``cuobjdump -sass``) of the innermost loop of
the float32, 3-band cluster kernel: its opcodes per iteration, by name.
Then, at the main paths' shapes, each library's kernels are checked
against their plain versions (the tolerances of ``chip_smoke.py``) and
their device time (``torch.profiler``) is taken in turns: the baselines,
current, current, the baselines in reverse. Shapes: the cluster
marginal at (S, E, B) = (50, 700, 3) and (50, 1710, 3) with W = 8 walkers
(float32; float64 at the first), the fused star likelihood of the bench's
binary on the MIST-scale grid at the nested fit's batch of 1024 points and at
131072 points (float32; float64 at the second), the tree likelihood of
the smoke run's three-star plan at the same two batches and types, the
catalog posterior on the smoke's 256-star catalogue at 256 points a star
and the forward model at 1,000,000 points (float32). A
baseline whose tree kernel is the first version (one thread per point, ``ll``
alone, another argument struct) is called through that version's struct and
held to the plain version's ``ll``. ``--reps 0`` builds and checks only. Prints one line per case and, with ``--out``, writes the numbers
as JSON.

:class:`Baseline` holds such a version for other timing scripts
(``chip_smoke.py --parent-csrc``, ``scripts/tune_torch_interp.py --parent``),
whose kernel B may take the first design's argument struct.
"""

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import glob
import json
import os
import re
import subprocess
import tempfile
import time

import torch

import isochrones_torch
from chip_smoke import (
    ATOL_F32, ATOL_STAR_F32, ATOL_TREE_COL_F32, ATOL_TREE_F32, ATOL_TREE_F64, CAT_BANDS, CAT_EEP_BOX, CAT_POINTS,
    CAT_STARS, GEN_POINTS, GRID, NESTED, RTOL_F32, RTOL_F64, RTOL_STAR_F32, RTOL_STAR_F64, RTOL_TREE_COL_F32,
    RTOL_TREE_F32, RTOL_TREE_F64, STAR_BATCH, STAR_BOX, as_float32, catalog_likelihood_as, catalog_points,
    catalog_priors_as, catalog_table, check_close, check_generate, check_star, generate_points, grid_as, kernel_ms,
    make_kernel_inputs, star_observations, star_points, to_torch, tree_likelihood_as, tree_points, write_tree_ini,
)
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.ops import _build, catalog_cuda, cluster_cuda, generate_cuda, interp_cuda, star_cuda, tree_cuda
from isochrones_torch.ops.catalog import catalog_lnpost_plain
from isochrones_torch.ops.cluster import cluster_lnmarginal_plain
from isochrones_torch.ops.eep import interp_eep
from isochrones_torch.ops.generate import generate_plain
from isochrones_torch.ops.star import star_lnlike_fused_plain
from isochrones_torch.ops.tree import tree_lnlike_fused_plain
from isochrones_torch.treemodel import StarModel


#: mangled name of the float32 cluster kernel: 3 bands, or the older
#: version's one instantiation per type
CLUSTER_F32 = re.compile(r"cluster_marginal_partialIf(?:Li3E)?E")
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def build_baseline(src_dir):
    """Compile ``src_dir``'s ``*.cu`` with the package's nvcc flags (one nvcc
    per source, all at once, then a link) into the git-ignored build
    directory; returns ``(path, seconds, compiler_log)``."""
    nvcc = _build.find_nvcc()
    out = os.path.join(_build.BUILD_DIR, "baseline_" + os.path.basename(os.path.normpath(src_dir)))
    os.makedirs(out, exist_ok=True)
    srcs = sorted(glob.glob(os.path.join(src_dir, "*.cu")))
    objs = [os.path.join(out, os.path.basename(s) + ".o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for s, o in zip(srcs, objs)]
    log = [p.communicate()[0] for p in procs]
    if not srcs or any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{''.join(log)}")
    path = os.path.join(out, "lib.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", path, *objs], check=True)
    return path, time.perf_counter() - t0, "".join(log)


def inner_loop_mix(lib_path, kernel=CLUSTER_F32):
    """Opcode counts of one iteration of the innermost loop of ``kernel``
    (a pattern of the mangled name) in ``cuobjdump -sass``: of the regions
    that a backward branch closes and that hold MUFU.EX2 but no such region
    inside them, the one with the most MUFU.EX2. MUFU keeps its function
    (MUFU.EX2), other opcodes lose their modifiers."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    for func in sass.split("Function : ")[1:]:
        if not kernel.search(func.split("\n", 1)[0]):
            continue
        insns, labels, pending = [], {}, []
        for line in func.splitlines():
            lab = _LABEL.match(line)
            if lab:
                pending.append(lab.group(1))
            m = _INSN.search(line)
            if m:
                addr = int(m.group(1), 16)
                labels.update({name: addr for name in pending})
                pending = []
                op = m.group(2)
                insns.append((addr, op if op.startswith("MUFU") else op.split(".")[0], m.group(3)))
        loops = []
        for addr, op, args in insns:
            tgt = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", args) if op == "BRA" else None
            if tgt:
                start = int(tgt.group(1), 16) if tgt.group(1) else labels.get(tgt.group(2), addr + 1)
                body = collections.Counter(o for a, o, _ in insns if start <= a <= addr)
                if start <= addr and body["MUFU.EX2"]:
                    loops.append((start, addr, body))
        inner = [body for s, e, body in loops
                 if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2, _ in loops)]
        if inner:
            return dict(sorted(max(inner, key=lambda b: b["MUFU.EX2"]).items(), key=lambda kv: -kv[1]))
    raise RuntimeError(f"no loop of a kernel matching {kernel.pattern} in {lib_path}")


_WRAPPERS = (cluster_cuda, star_cuda, tree_cuda, interp_cuda, catalog_cuda, generate_cuda)


@contextlib.contextmanager
def using(lib):
    """Route the kernel wrappers through the loaded library ``lib`` (a
    wrapper looks its entry points up at its first call inside)."""
    saved = [m.load_library for m in _WRAPPERS]
    for m in _WRAPPERS:
        m.load_library = lambda: lib
        m._lib.cache_clear()
    try:
        yield lib
    finally:
        for m, load in zip(_WRAPPERS, saved):
            m.load_library = load
            m._lib.cache_clear()


#: the plan's device arrays, in the order of the first tree kernel's struct
_FIRST_PLAN = ("star_param_idx", "member", "obs_band", "obs_val", "obs_unc", "obs_ref", "obs_active", "spec_star",
               "spec_prop", "spec_val", "spec_unc", "lim_star", "lim_prop", "lim_lo", "lim_hi", "plax_idx",
               "plax_val", "plax_unc", "av_idx", "av_val", "av_unc")


class _TreeArgsFirst(ctypes.Structure):
    """``TreeArgs`` of the tree kernel's first version: one thread per point,
    ``ll`` alone, the 4-column model pack, the plan as device arrays."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("pars", "ll", "model", "dens_table", "bc") + _FIRST_PLAN]
        + [("B", ctypes.c_longlong)]
        + [(name, ctypes.c_int) for name in ("P", "n_stars", "n_obs", "n_bands", "n_spec", "n_lim", "n_plax", "n_av")]
        + [("io", ctypes.c_int * 5), ("bc_ncols", ctypes.c_int), ("dens_row_len", ctypes.c_int),
           ("dens_col", ctypes.c_int), ("band_cols", ctypes.c_int * tree_cuda.MAX_BANDS),
           ("model_ax", star_cuda._Axis * 3), ("bc_ax", star_cuda._Axis * 4)]
    )


def tree_first_version(lib, p, lk, pack4):
    """``(ll,)`` from the first version of the tree kernel in ``lib``, for a
    plan without density rows; ``pack4`` is the interpolator's 4-column pack."""
    if lk.full_model is not None:
        raise ValueError("the first tree kernel is timed on plans without density rows")
    lib.tree_lnlike_args_size.restype = ctypes.c_int
    if lib.tree_lnlike_args_size() != ctypes.sizeof(_TreeArgsFirst):
        raise RuntimeError("the baseline's tree kernel takes neither the current argument struct nor the first one")
    a = _TreeArgsFirst()
    ll = torch.empty(p.shape[0], dtype=p.dtype, device=p.device)
    a.pars, a.ll, a.model, a.bc, a.dens_table = p.data_ptr(), ll.data_ptr(), pack4.values.data_ptr(), lk.bc.values.data_ptr(), None
    for name in _FIRST_PLAN:
        t = getattr(lk, name)
        setattr(a, name, t.data_ptr() if t.numel() else None)
    a.B, a.P, a.n_stars, a.n_obs, a.n_bands = p.shape[0], lk.n_params, lk.n_stars, lk.n_obs, len(lk.band_icols)
    a.n_spec, a.n_lim, a.n_plax, a.n_av = len(lk.spec_star), len(lk.lim_star), len(lk.plax_idx), len(lk.av_idx)
    a.io[:] = [int(i) for i in lk.index_order[:5]]
    a.bc_ncols = lk.bc.values.shape[-1]
    a.band_cols[:len(lk.band_icols)] = [int(c) for c in lk.band_icols]
    a.model_ax[:] = star_cuda._axes(pack4, p.dtype, p.device, "model")
    a.bc_ax[:] = star_cuda._axes(lk.bc, p.dtype, p.device, "BC")
    fn = lib.tree_lnlike_f32 if p.dtype == torch.float32 else lib.tree_lnlike_f64
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    err = fn(ctypes.byref(a), torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the first tree kernel's launch failed ({err})")
    return (ll,)


class _InterpArgsFirst(ctypes.Structure):
    """``InterpArgs`` of kernel B's first design (one lane a point, chunks of
    8 columns, 64-bit offsets, the row layout): no table length, column
    instance or offset width."""

    _fields_ = [
        ("points", ctypes.c_void_p), ("table", ctypes.c_void_p), ("grad_out", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("P", ctypes.c_longlong), ("ndim", ctypes.c_int), ("ncols", ctypes.c_int),
        ("row_len", ctypes.c_int), ("pad", ctypes.c_int), ("axes", interp_cuda._Axis * interp_cuda.MAX_DIM),
        ("cols", ctypes.c_int * interp_cuda.MAX_COLS),
    ]


class Baseline:
    """Another version's kernels (e.g. the parent commit's), built from the
    ``*.cu`` of a directory (:meth:`build`) or loaded already (``lib``),
    called on the current wrappers' inputs: ``run(fn)`` calls ``fn`` with
    the wrappers routed through that library (:func:`using`; for kernels
    whose argument struct is the current one), ``interp`` calls its kernel B
    whichever of the two argument structs it takes, ``star_grad`` and
    ``interp_grad`` its kernels A' and B'."""

    def __init__(self, lib, seconds=0.0, log=""):
        self.lib, self.seconds, self.log = lib, seconds, log
        self.lib.interp_nd_args_size.restype = ctypes.c_int

    @classmethod
    def build(cls, src_dir):
        path, seconds, log = build_baseline(src_dir)
        return cls(ctypes.CDLL(path), seconds, log)

    def run(self, fn):
        with using(self.lib):
            return fn()

    def star_grad(self, pars, lk, g_ll, g_orig, g_deriv):
        """Kernel A' of this version on the call ``star_lnlike_grad_cuda(pars,
        lk, g_ll, g_orig, g_deriv)``: A' has kept its entry points and both
        argument structs since its first design, so the current wrapper calls
        it (checked by the structs' sizes)."""
        for name, struct in (("star_lnlike_args_size", star_cuda._StarArgs),
                             ("star_lnlike_grad_args_size", star_cuda._StarGradArgs)):
            getattr(self.lib, name).restype = ctypes.c_int
            if getattr(self.lib, name)() != ctypes.sizeof(struct):
                raise RuntimeError(f"the baseline's kernel A' takes another argument struct ({name})")
        return self.run(lambda: star_cuda.star_lnlike_grad_cuda(pars, lk, g_ll, g_orig, g_deriv))

    def interp_grad(self, values, knots, points, grad_out, icols=None, axis_maps=None):
        """Kernel B' of this version on the call ``interp_nd_grad_cuda(values,
        knots, points, grad_out, icols, axis_maps)``, through the current
        wrapper (checked by the argument struct's size)."""
        if self.lib.interp_nd_args_size() != ctypes.sizeof(interp_cuda._InterpArgs):
            raise RuntimeError("the baseline's kernel B' takes another argument struct")
        return self.run(lambda: interp_cuda.interp_nd_grad_cuda(values, knots, points, grad_out, icols, axis_maps))

    def interp(self, values, knots, points, icols=None, axis_maps=None, planar=False):
        """Kernel B of this version on the call ``interp_nd_cuda(values,
        knots, points, icols, axis_maps, planar)``: through the current
        wrapper where the version takes the current struct, else through the
        first design's (which reads the row layout whatever ``planar``)."""
        if self.lib.interp_nd_args_size() == ctypes.sizeof(interp_cuda._InterpArgs):
            return self.run(lambda: interp_cuda.interp_nd_cuda(values, knots, points, icols=icols,
                                                               axis_maps=axis_maps, planar=planar))
        if self.lib.interp_nd_args_size() != ctypes.sizeof(_InterpArgsFirst):
            raise RuntimeError("the baseline's kernel B takes neither the current argument struct nor the first one")
        a, pts, _ = interp_cuda._args(values, knots, points, icols, axis_maps, "baseline interp_nd")
        old = _InterpArgsFirst()
        for name in ("points", "table", "P", "ndim", "ncols", "row_len"):
            setattr(old, name, getattr(a, name))
        old.axes[:] = list(a.axes)
        old.cols[:] = list(a.cols)
        out = torch.empty((pts.shape[0], a.ncols), dtype=pts.dtype, device=pts.device)
        old.out = out.data_ptr()
        fn = self.lib.interp_nd_f32 if pts.dtype == torch.float32 else self.lib.interp_nd_f64
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        err = fn(ctypes.byref(old), torch.cuda.current_stream(pts.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the baseline's interp_nd launch failed ({err})")
        return out.reshape(points.shape[:-1] + (a.ncols,))


def _cluster_cases(dev):
    out = []
    for (S, E, B), dtypes in (((50, 700, 3), ("float32", "float64")), ((50, 1710, 3), ("float32",))):
        inputs = make_kernel_inputs(S, E, B, 8, seed=S + E + B)
        in32 = as_float32(inputs)
        for dt in dtypes:
            src = in32 if dt == "float32" else inputs
            a, kw = to_torch(src, dev, getattr(torch, dt))
            a64, kw64 = to_torch(src, dev, torch.float64)
            ref = cluster_lnmarginal_plain(*a64, **kw64)
            tol = (RTOL_F32, ATOL_F32) if dt == "float32" else (RTOL_F64, 0.0)

            def run(lib, a=a, kw=kw):
                return cluster_cuda.cluster_lnmarginal_cuda(*a, **kw)

            def check(got, ref=ref.cpu().numpy(), tol=tol, name=f"cluster {S, E, B} {dt}"):
                return check_close(name, got.cpu().numpy(), ref, *tol)

            out.append((f"cluster_marginal S={S} E={E} B={B} W=8 {dt}", "cluster_marginal", run, check))
    return out


def _tree_cases(ic32, ic64, dev):
    """The smoke run's three-star plan at the fit's batch and at 131072
    points. ``run`` takes the library: the current struct where it fits, the
    first version's where the library is of that version."""
    with tempfile.TemporaryDirectory() as folder:
        mod = StarModel.from_ini(ic64, write_tree_ini(folder, ic64))
    lk64 = mod._get_fn("lnlike").likelihood
    lk32 = tree_likelihood_as(lk64, torch.float32)
    lk32up = tree_likelihood_as(lk32, torch.float64)
    names = mod.param_names
    fit_batch = NESTED["n_batch"] * NESTED["n_chains"]
    out = []
    for B, seed, dtypes in ((fit_batch, 23, ("float32",)), (STAR_BATCH, 24, ("float32", "float64"))):
        p32 = torch.as_tensor(tree_points(names, ic64.model.knots, B, seed=seed, narrow=True), device=dev,
                              dtype=torch.float32)
        for dt in dtypes:
            p, lk, pack4 = (p32, lk32, ic32.model_packed) if dt == "float32" else (p32.double(), lk64, ic64.model_packed)
            ref = [x.cpu().numpy() for x in tree_lnlike_fused_plain(p.double(), lk32up if dt == "float32" else lk64)]
            f32 = dt == "float32"

            def run(lib, p=p, lk=lk, pack4=pack4):
                lib.tree_lnlike_args_size.restype = ctypes.c_int
                if lib.tree_lnlike_args_size() == ctypes.sizeof(tree_cuda._TreeArgs):
                    return tree_cuda.tree_lnlike_cuda(p, lk)
                return tree_first_version(lib, p, lk, pack4)

            def check(got, ref=ref, f32=f32, name=f"tree B={B} {dt}"):
                got = [x.cpu().numpy() for x in got]
                err = check_star(name, got[:1], ref[:1], *((RTOL_TREE_F32, ATOL_TREE_F32) if f32 else
                                                           (RTOL_TREE_F64, ATOL_TREE_F64)))
                cols = (RTOL_TREE_COL_F32, ATOL_TREE_COL_F32) if f32 else (RTOL_TREE_F64, ATOL_TREE_F64)
                return max(err, check_star(name + " prior columns", got[1:], ref[1:len(got)], *cols))

            out.append((f"tree_lnlike B={B} 3 stars 12 rows 3 bands {dt}", "tree_lnlike", run, check))
    return out


def _star_cases(ic32, ic64, dev):
    obs = star_observations(ic64)
    lk32 = isochrones_torch.BinaryStarModel(ic32, **obs)._star_likelihood()
    lk64 = isochrones_torch.BinaryStarModel(ic64, **obs)._star_likelihood()
    lk32up = dataclasses.replace(lk32, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    fit_batch = NESTED["n_batch"] * NESTED["n_chains"]
    out = []
    for B, seed, dtypes in ((fit_batch, 14, ("float32",)), (STAR_BATCH, 13, ("float32", "float64"))):
        p32 = torch.as_tensor(star_points(ic64.model.knots, 2, B, seed=seed, box=STAR_BOX), device=dev,
                              dtype=torch.float32)
        for dt in dtypes:
            p, lk = (p32, lk32) if dt == "float32" else (p32.double(), lk64)
            ref = [x.cpu().numpy() for x in star_lnlike_fused_plain(p.double(), lk32up if dt == "float32" else lk64)]
            tol = (RTOL_STAR_F32, ATOL_STAR_F32) if dt == "float32" else (RTOL_STAR_F64, 0.0)

            def run(lib, p=p, lk=lk):
                return star_cuda.star_lnlike_cuda(p, lk)

            def check(got, ref=ref, tol=tol, name=f"star B={B} {dt}"):
                return check_star(name, [x.cpu().numpy() for x in got], ref, *tol)

            out.append((f"star_lnlike B={B} N=2 4 bands {dt}", "star_lnlike", run, check))
    return out


def _catalog_cases(ic32, ic64, dev):
    """The catalog posterior kernel (E) on the smoke's seeded 256-star
    catalogue at 256 points a star, float32, against its plain version."""
    truths, table = catalog_table(ic64, CAT_STARS, CAT_EEP_BOX)
    fit32 = BatchStarFitter(ic32, table, bands=CAT_BANDS)
    lk32, pri32 = fit32._catalog_likelihood(), fit32._catalog_priors()
    lk32up, pri32up = catalog_likelihood_as(lk32, torch.float64), catalog_priors_as(pri32, torch.float64)
    p32 = torch.as_tensor(catalog_points(ic64, truths, CAT_POINTS, seed=16), device=dev, dtype=torch.float32)
    ref = catalog_lnpost_plain(p32.double(), lk32up, pri32up)[0].cpu().numpy()

    def run(lib):
        return catalog_cuda.catalog_lnpost_cuda(p32, lk32, pri32)[0]

    def check(got):
        return check_star(f"catalog S={CAT_STARS} B={CAT_POINTS} float32", [got.cpu().numpy()], [ref],
                          RTOL_STAR_F32, ATOL_STAR_F32)

    return [(f"catalog_lnpost S={CAT_STARS} B={CAT_POINTS} 3 bands float32", "catalog_lnlike", run, check)]


def _generate_cases(ic32, dev):
    """The forward-model kernel (F) at the smoke's 1,000,000 seeded points,
    every model column and band, float32, against its plain version on the
    same float32 tables in float64."""
    import dataclasses as dc

    tr32 = ic32.track
    fm32 = tr32._forward_model
    up = [grid_as(g, torch.float64) for g in (fm32.model, fm32.model_packed, fm32.bc)]
    sup = tuple(x.double() if x.is_floating_point() else x for x in fm32.eep_support)
    fm32up = dc.replace(fm32, model=up[0], model_packed=up[1], bc=up[2], eep_support=sup)
    icols = tr32.model.icols("all")
    bcols = tuple(tr32.bc.column_index[b] for b in tr32.bands)
    x32 = [torch.as_tensor(c, device=dev, dtype=torch.float32) for c in generate_points(tr32, GEN_POINTS, seed=20)]
    x32up = [x.double() for x in x32]

    def run(lib):
        return generate_cuda.generate_cuda(fm32, *x32, icols, bcols)

    def check(got):
        e_ref = interp_eep(x32up[1], x32up[2], x32up[0], *fm32up.eep_support, eep0=fm32up.eep0)
        ref = generate_plain(fm32up, *x32up, icols, bcols, eeps=got[0].double())
        return check_generate(f"generate N={GEN_POINTS} float32", got, (e_ref,) + tuple(ref[1:]), "float32")

    return [(f"generate N={GEN_POINTS} {len(icols)} columns {len(bcols)} bands float32", "generate_kernel", run,
             check)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", nargs="*", default=[],
                    help="directories of other versions of the *.cu sources (labelled by directory name)")
    ap.add_argument("--reps", type=int, default=20, help="calls per timing (0: build and check only)")
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_torch_kernels: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    libs, mixes = {}, {}
    builds = [(os.path.basename(os.path.normpath(d)), lambda d=d: build_baseline(d)) for d in args.baseline]
    for name, make in builds + [("current", _build.build)]:
        path, secs, log = make()
        libs[name] = ctypes.CDLL(path)
        print(f"[build] {name}: {os.path.relpath(path)} in {secs:.3f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name} {line.strip()}")
        mixes[name] = inner_loop_mix(path)
        print(f"[sass] {name} cluster kernel, float32, 3 bands, innermost loop: {sum(mixes[name].values())} "
              f"instructions per iteration {json.dumps(mixes[name])}")

    bases = [n for n in libs if n != "current"]
    order = bases + ["current", "current"] + bases[::-1]
    results = {"device": smi, "reps": args.reps, "order": order, "inner_loop_mix": mixes, "cases": {}}
    ic32 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float32, **GRID)
    ic64 = isochrones_torch.get_ichrone("synthetic", device=dev, dtype=torch.float64, **GRID)
    cases = (_cluster_cases(dev) + _star_cases(ic32, ic64, dev) + _tree_cases(ic32, ic64, dev)
             + _catalog_cases(ic32, ic64, dev) + _generate_cases(ic32, dev))
    for label, kname, run, check in cases:
        row = {}
        for name, lib in libs.items():
            with using(lib):
                got = run(lib)
                torch.cuda.synchronize()
                row[f"{name}_max_abs_err"] = check(got)
        if args.reps > 0:
            times = []
            for name in order:
                with using(libs[name]) as lib:
                    times.append(kernel_ms(lambda: run(lib), kname, reps=args.reps))
            row["ms"] = dict(zip([f"{i}:{n}" for i, n in enumerate(order)], times))
        results["cases"][label] = row
        print(f"[compare] {label}: {json.dumps(row)}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
