"""Hand-written CUDA kernel for the forward model and the EEP inversions.

Replaces the JAX package's XLA-fused forward model, ``_generate_g``
(``isochrones_tpu/models/interpolator.py:109-156``), and its accurate EEP
inversion, ``get_eep_newton`` (``isochrones_tpu/ops/eep.py:128-180``); the
source is ``isochrones_torch/csrc/generate.cu``, whose header says what bounds
it on the card and how the design answers that. The plain versions it
replaces sit beside it in :mod:`isochrones_torch.ops.generate` and
:mod:`isochrones_torch.ops.eep`.

Five wrappers over the one kernel body, each one launch and each with its own
count of launches: :func:`generate_cuda` (the fast EEP inversion, or given
EEPs, then the chosen model columns and the magnitudes, with ``all_As`` also
at AV = 0), :func:`generate_accurate_cuda` (the same after the Newton step and
the ``resid_tol`` cut), :func:`get_eep_cuda` (the fast EEP alone, a track
grid's fast ``get_eep``), :func:`get_eep_accurate_cuda` (the accurate EEP alone
on a track grid) and :func:`eep_newton_cuda` (the Newton step from given seeds
on any 3-d grid whose last axis is the EEP: an isochrone grid's ``get_eep``).

The argument struct (axis kinds and constants, knot and table pointers) is
built once per :class:`~isochrones_torch.ops.generate.ForwardModel` (or
:class:`~isochrones_torch.ops.generate.NewtonGrid`), dtype, device and band
list; each call patches in its pointers. Beside it, built once and kept with
it: a packed copy of the model table, every column with Teff, logg, feh and
Mbol first, rows padded to a multiple of 4 values (:func:`packed_model`; a
call names its columns by their places in it, :func:`pack_layout`), the BC
table's wanted columns in a compact copy 4, 8, 12 or 16 wide
(:func:`~.catalog_cuda.compact_table`), and for the Newton step the matched
column as its own contiguous table, with the scan's 33 EEPs. The inputs are
1-d tensors of one length N, read with their own strides (a broadcast scalar
has stride 0). Caps: 16 bands, a model table of 32 columns, 32 columns asked
for, ``N < 2**31`` points (one thread each); the Newton step takes a 3-d
grid whose last axis is the EEP,
and on a track grid the axes (feh, mass, eep) and an age column. Past a cap
it raises a ``ValueError`` that names it; it never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch

from ._build import load_library
from ._grad import refuse_grad
from .catalog_cuda import compact_table
from .generate import ForwardModel, NewtonGrid
from .star_cuda import _KINDS, _Axis, _axes

__all__ = ["generate_cuda", "generate_accurate_cuda", "get_eep_cuda", "get_eep_accurate_cuda", "eep_newton_cuda",
           "packed_model", "pack_layout", "MAX_BANDS", "MAX_PROPS"]

MAX_BANDS = 16
#: the model table's columns, all in the packed row
_MAX_COLS = 32
#: model columns a call may ask for
MAX_PROPS = _MAX_COLS
_MAX_POINTS = 1 << 31
#: the kernel's Mode
_INVERT, _GIVEN, _EEP_ONLY, _ACCURATE, _ACCURATE_EEP, _NEWTON = range(6)
#: the compact BC table's widths the kernel is instantiated for
_BC_WIDTHS = (4, 8, 12, 16)
#: get_eep_newton's steps and scan points
_N_ITER, _N_SCAN = 12, 33


class _GenerateArgs(ctypes.Structure):
    """Mirror of ``GenerateArgs`` in ``csrc/generate.cu`` (checked by size)."""

    _fields_ = [
        ("inp", ctypes.c_void_p * 5), ("eeps_in", ctypes.c_void_p), ("model", ctypes.c_void_p),
        ("bc", ctypes.c_void_p), ("age_rows", ctypes.c_void_p), ("lengths", ctypes.c_void_p),
        ("newton_col", ctypes.c_void_p), ("scan", ctypes.c_void_p),
        ("eep", ctypes.c_void_p), ("props", ctypes.c_void_p), ("mags", ctypes.c_void_p), ("mags0", ctypes.c_void_p),
        ("stride", ctypes.c_longlong * 5), ("N", ctypes.c_longlong), ("n_eep", ctypes.c_longlong),
        ("n_tracks", ctypes.c_longlong), ("eep0", ctypes.c_double), ("resid_tol", ctypes.c_double),
        ("io", ctypes.c_int * 3), ("n_steps", ctypes.c_int), ("row_len", ctypes.c_int), ("read_len", ctypes.c_int),
        ("P", ctypes.c_int), ("prop_cols", ctypes.c_int * _MAX_COLS), ("n_bands", ctypes.c_int),
        ("bc_ncols", ctypes.c_int),
        ("n_iter", ctypes.c_int),
        ("inv_ax", _Axis * 2), ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4), ("newton_ax", _Axis * 3),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the forward model's C signatures declared."""
    lib = load_library()
    for name in ("generate_f32", "generate_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_GenerateArgs), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("generate_args_size", "generate_max_bands", "generate_max_cols"):
        getattr(lib, name).restype = ctypes.c_int
    lib.star_lnlike_error_string.argtypes = [ctypes.c_int]
    lib.star_lnlike_error_string.restype = ctypes.c_char_p
    if lib.generate_args_size() != ctypes.sizeof(_GenerateArgs):
        raise RuntimeError(f"GenerateArgs layout differs: C {lib.generate_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_GenerateArgs)}")
    if lib.generate_max_bands() != MAX_BANDS or lib.generate_max_cols() != _MAX_COLS:
        raise RuntimeError("forward-model kernel caps differ from the wrapper's")
    return lib


#: per forward model or Newton grid: {key: (argument struct or table, tensors it points into)}
_CACHE = weakref.WeakKeyDictionary()


def _cached(owner, key, build):
    per = _CACHE.setdefault(owner, {})
    if key not in per:
        per[key] = build()
    return per[key]


def packed_model(fm: ForwardModel, dtype, device):
    """``(table, order)``: every column of the model table, those of Teff,
    logg, feh and Mbol (``fm.model_icols``) first and the others in the
    table's order, padded with zeros to a multiple of 4 columns, as one
    contiguous ``(m0, m1, m2, width)`` copy; ``order`` names the table column
    at each place. Built once per forward model, dtype and device."""

    def build():
        n = fm.model.values.shape[-1]
        if n > _MAX_COLS:
            raise ValueError(f"forward-model kernel takes a model table of at most {_MAX_COLS} columns, got {n}")
        order = [int(c) for c in fm.model_icols] + [c for c in range(n) if c not in fm.model_icols]
        vals = fm.model.values[..., order]
        width = -(-n // 4) * 4
        return torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (width - n,))], dim=-1).contiguous(), tuple(order)

    return _cached(fm, ("pack", dtype, device), build)


def pack_layout(order, prop_icols):
    """``(prop_cols, read_len)``: the places of the table columns
    ``prop_icols`` in a pack of ``order``, and the lerped part of its row,
    the first multiple of 4 columns that holds them and Teff, logg, feh and
    Mbol."""
    place = {c: i for i, c in enumerate(order)}
    prop_cols = [place[int(c)] for c in prop_icols]
    return prop_cols, (max([3] + prop_cols) // 4 + 1) * 4


def _newton_tables(grid, icol, dtype, device):
    """The Newton step's column of ``grid`` as a contiguous ``(n0, n1, n2)``
    table, the scan's EEPs, ``linspace(first, last EEP knot, 33)`` as
    get_eep_newton makes them, and the grid's axes."""
    if len(grid.knots) != 3:
        raise ValueError(f"the Newton step needs a 3-d grid whose last axis is the EEP, got {len(grid.knots)} axes")
    if not 0 <= icol < grid.values.shape[-1]:
        raise ValueError(f"Newton column {icol} outside the table of {grid.values.shape[-1]} columns")
    axes = _axes(grid, dtype, device, "Newton grid")
    col = grid.values[..., icol].contiguous()
    eeps = grid.knots[-1]
    scan = torch.linspace(float(eeps[0]), float(eeps[-1]), _N_SCAN, dtype=dtype, device=device)
    return col, scan, axes


def _template(fm: ForwardModel, band_icols, dtype, device, accurate=False):
    """The argument struct of ``fm`` and these bands (with the Newton step's
    tables when ``accurate``); raises on what the kernel does not take."""
    key = ("args", dtype, device, tuple(int(c) for c in band_icols), accurate)
    return _cached(fm, key, lambda: _build_template(fm, key[3], dtype, device, accurate))[0]


def _build_template(fm: ForwardModel, bands, dtype, device, accurate):
    if fm.eep_support is None:
        raise ValueError("forward-model kernel needs the track grid's EEP support arrays")
    if len(fm.model.knots) != 3 or len(fm.bc.knots) != 4:
        raise ValueError("forward-model kernel needs a 3-d model table and a 4-d BC table")
    if sorted(int(i) for i in fm.index_order[:3]) != [0, 1, 2]:
        raise ValueError(f"forward-model kernel needs (mass, eep, feh) on the grid axes, got {fm.index_order}")
    feh_knots, mass_knots, age_rows, lengths = fm.eep_support
    n_tracks = feh_knots.shape[0] * mass_knots.shape[0]
    if age_rows.dim() != 2 or age_rows.shape[0] != n_tracks or lengths.shape != (n_tracks,):
        raise ValueError(f"EEP support arrays must be ({n_tracks}, n_eep) ages and ({n_tracks},) lengths, got "
                         f"{tuple(age_rows.shape)} and {tuple(lengths.shape)}")
    if age_rows.dtype != dtype or age_rows.device != device:
        raise ValueError(f"EEP support ages must be {dtype} on {device}, got {age_rows.dtype} on {age_rows.device}")
    age_rows = age_rows.contiguous()
    lengths = lengths.to(device=device, dtype=torch.int64).contiguous()
    a = _GenerateArgs()
    a.model_ax[:] = _axes(fm.model, dtype, device, "model")
    a.age_rows, a.lengths = age_rows.data_ptr(), lengths.data_ptr()
    a.n_eep, a.n_tracks = age_rows.shape[1], n_tracks
    a.n_steps = max(1, int(math.ceil(math.log2(max(age_rows.shape[1], 2))))) + 1
    a.eep0 = float(fm.eep0)
    a.io[:] = [int(i) for i in fm.index_order[:3]]
    inv = []
    for k in (feh_knots, mass_knots):
        if k.device != device or k.dtype != dtype or not k.is_contiguous() or k.shape[0] < 1:
            raise ValueError(f"EEP support knots must be non-empty contiguous {dtype} tensors on {device}")
        inv.append(_Axis(k.data_ptr(), k.shape[0], 0.0, 0.0, _KINDS[None], 0))
    a.inv_ax[:] = inv
    keep = [age_rows, lengths]
    a.n_bands = len(bands)
    a.bc_ncols = 4
    if a.n_bands:
        table = compact_table(fm.bc, bands, widths=_BC_WIDTHS)
        a.bc, a.bc_ncols = table.data_ptr(), table.shape[-1]
        a.bc_ax[:] = _axes(fm.bc, dtype, device, "BC")
        keep.append(table)
    if accurate:
        # get_eep_newton(fm.model, fast, age, feh, mass, fm.i_age): the grid's axes are (feh, mass, eep)
        if tuple(int(i) for i in fm.index_order[:3]) != (2, 0, 1):
            raise ValueError(f"the accurate inversion needs the grid axes (feh, mass, eep), got {fm.index_order}")
        if fm.i_age < 0:
            raise ValueError("the accurate inversion needs the model table's age column")
        col, scan, axes = _newton_tables(fm.model, fm.i_age, dtype, device)
        _set_newton(a, col, scan, axes)
        keep += [col, scan]
    return a, keep


def _set_newton(a, col, scan, axes):
    a.newton_col, a.scan, a.n_iter = col.data_ptr(), scan.data_ptr(), _N_ITER
    a.newton_ax[:] = axes


def _check_inputs(xs, names, fn):
    """1-d tensors of one length, below the cap, on one CUDA device in one
    float dtype."""
    x0 = xs[0]
    n = x0.shape[0] if x0.dim() == 1 else -1
    if n >= _MAX_POINTS:
        raise ValueError(f"forward-model kernel takes N < 2**31 points, got {n}")
    if x0.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {x0.device}")
    if x0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fn} takes float32 or float64, got {x0.dtype}")
    for x, name in zip(xs, names):
        if x.dim() != 1 or x.shape[0] != n or x.device != x0.device or x.dtype != x0.dtype:
            raise ValueError(f"{fn}: {name} must be a 1-d {x0.dtype} tensor of {max(n, 0)} points on {x0.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return n


def _launch(call, mode, dt, dev, name):
    lib = _lib()
    fn = lib.generate_f32 if dt == torch.float32 else lib.generate_f64
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(call), mode, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {lib.star_lnlike_error_string(err).decode()} ({err})")


def _point_args(call, xs):
    for k, x in enumerate(xs):
        call.inp[k], call.stride[k] = x.data_ptr(), x.stride(0)


def _forward(fm, mass, age, feh, distance, AV, prop_icols, band_icols, eeps, all_As, accurate, resid_tol, fn):
    refuse_grad(fn, mass, age, feh, distance, AV, eeps)
    prop_icols = tuple(int(c) for c in prop_icols)
    if len(prop_icols) > MAX_PROPS:
        raise ValueError(f"forward-model kernel takes at most {MAX_PROPS} model columns, got {len(prop_icols)}")
    if len(band_icols) > MAX_BANDS:
        raise ValueError(f"forward-model kernel takes at most {MAX_BANDS} bands, got {len(band_icols)}")
    xs = [mass, age, feh, distance, AV] + ([] if eeps is None else [eeps])
    n = _check_inputs(xs, ["mass", "age", "feh", "distance", "AV", "eeps"], fn)
    dt, dev = mass.dtype, mass.device
    n_cols = fm.model.values.shape[-1]
    if any(not 0 <= c < n_cols for c in prop_icols):
        raise ValueError(f"model column outside the table of {n_cols} columns: {prop_icols}")
    call = _GenerateArgs.from_buffer_copy(_template(fm, band_icols, dt, dev, accurate))
    table, order = packed_model(fm, dt, dev)
    prop_cols, call.read_len = pack_layout(order, prop_icols)
    call.model, call.row_len, call.P = table.data_ptr(), table.shape[-1], len(prop_cols)
    call.prop_cols[:len(prop_cols)] = prop_cols
    call.N, call.resid_tol = n, float(resid_tol)
    _point_args(call, xs[:5])
    nb = call.n_bands
    props = torch.empty((n, len(prop_icols)), dtype=dt, device=dev)
    mags = torch.empty((n, nb), dtype=dt, device=dev)
    mags0 = torch.empty((n, nb), dtype=dt, device=dev) if all_As else None
    call.props, call.mags = props.data_ptr(), mags.data_ptr()
    call.mags0 = None if mags0 is None or nb == 0 else mags0.data_ptr()
    if eeps is None:
        eeps = torch.empty((n,), dtype=dt, device=dev)
        call.eep, mode = eeps.data_ptr(), _ACCURATE if accurate else _INVERT
    else:
        eeps = eeps.contiguous()
        call.eeps_in, mode = eeps.data_ptr(), _GIVEN
    _launch(call, mode, dt, dev, "generate")
    return eeps, props, mags, mags0


def generate_cuda(fm: ForwardModel, mass, age, feh, distance, AV, prop_icols, band_icols, eeps=None, all_As=False):
    """``(eeps (N,), props (N, P), mags (N, n_bands), mags at AV = 0 or
    None)`` from one kernel launch: the fast EEP inversion in the kernel, or
    the given ``eeps`` (returned as they are). Raises on anything the kernel
    does not take, and if the launch fails."""
    out = _forward(fm, mass, age, feh, distance, AV, prop_icols, band_icols, eeps, all_As, False, 0.0,
                   "generate_cuda")
    generate_cuda.launches += 1
    return out


def generate_accurate_cuda(fm: ForwardModel, mass, age, feh, distance, AV, prop_icols, band_icols, all_As=False,
                           resid_tol=0.02):
    """:func:`generate_cuda` with the accurate inversion: the fast EEP refined
    by the Newton step and NaN where its residual is ``resid_tol`` or more,
    all in one launch."""
    out = _forward(fm, mass, age, feh, distance, AV, prop_icols, band_icols, None, all_As, True, resid_tol,
                   "generate_accurate_cuda")
    generate_accurate_cuda.launches += 1
    return out


def _eep_only(fm, mass, age, feh, mode, resid_tol, fn):
    refuse_grad(fn, mass, age, feh)
    n = _check_inputs([mass, age, feh], ["mass", "age", "feh"], fn)
    dt, dev = mass.dtype, mass.device
    call = _GenerateArgs.from_buffer_copy(_template(fm, (), dt, dev, mode == _ACCURATE_EEP))
    call.N, call.resid_tol = n, float(resid_tol)
    _point_args(call, [mass, age, feh])
    out = torch.empty((n,), dtype=dt, device=dev)
    call.eep = out.data_ptr()
    _launch(call, mode, dt, dev, "get_eep")
    return out


def get_eep_cuda(fm: ForwardModel, mass, age, feh):
    """The fast EEP inversion ``(N,)`` of 1-d tensors, from one launch of the
    kernel's EEP-only form."""
    out = _eep_only(fm, mass, age, feh, _EEP_ONLY, 0.0, "get_eep_cuda")
    get_eep_cuda.launches += 1
    return out


def get_eep_accurate_cuda(fm: ForwardModel, mass, age, feh, resid_tol=0.02):
    """The accurate EEP inversion ``(N,)`` of 1-d tensors on the track grid:
    the fast estimate, the Newton step on the age column and the
    ``resid_tol`` cut, in one launch."""
    out = _eep_only(fm, mass, age, feh, _ACCURATE_EEP, resid_tol, "get_eep_accurate_cuda")
    get_eep_accurate_cuda.launches += 1
    return out


def eep_newton_cuda(ng: NewtonGrid, seed, target, x0, x1, resid_tol=0.02):
    """get_eep_newton's EEP ``(N,)`` from the seeds ``seed`` for ``target``
    of column ``ng.icol`` at grid coordinates ``(x0, x1, eep)``, then the
    ``resid_tol`` cut (NaN past it), in one launch."""
    refuse_grad("eep_newton_cuda", seed, target, x0, x1)
    n = _check_inputs([target, x0, x1, seed], ["target", "x0", "x1", "seed"], "eep_newton_cuda")
    dt, dev = target.dtype, target.device

    def build():
        col, scan, axes = _newton_tables(ng.grid, ng.icol, dt, dev)
        a = _GenerateArgs()
        _set_newton(a, col, scan, axes)
        return a, [col, scan]

    call = _GenerateArgs.from_buffer_copy(_cached(ng, ("newton", dt, dev), build)[0])
    call.N, call.resid_tol = n, float(resid_tol)
    _point_args(call, [target, x0, x1, seed])
    out = torch.empty((n,), dtype=dt, device=dev)
    call.eep = out.data_ptr()
    _launch(call, _NEWTON, dt, dev, "eep_newton")
    eep_newton_cuda.launches += 1
    return out


#: kernel launches made through each wrapper (reset by callers that count)
generate_cuda.launches = 0
generate_accurate_cuda.launches = 0
get_eep_cuda.launches = 0
get_eep_accurate_cuda.launches = 0
eep_newton_cuda.launches = 0
