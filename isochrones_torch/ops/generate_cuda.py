"""Hand-written CUDA kernel for the forward model.

Replaces the JAX package's XLA-fused forward model, ``_generate_g``
(``isochrones_tpu/models/interpolator.py:109-156``); the source is
``isochrones_torch/csrc/generate.cu``, whose header says what bounds it on the
card and how the design answers that. The plain version it replaces sits
beside it in :mod:`isochrones_torch.ops.generate`.

Two wrappers over the one kernel body: :func:`generate_cuda` (the EEP
inversion, or given EEPs, then the chosen model columns and the magnitudes,
with ``all_As`` also at AV = 0) and :func:`get_eep_cuda` (the EEP alone, the
fast ``get_eep`` of a track grid). Each counts its own launches. The argument
struct (axis kinds and constants, knot and table pointers, the columns to
lerp) is built once per :class:`~isochrones_torch.ops.generate.ForwardModel`,
dtype, device and band list, with the BC table's wanted columns copied into
a compact table (:func:`~.catalog_cuda.compact_table`); each call patches in
its pointers. The inputs are 1-d tensors of one length N, read with their
own strides (a broadcast scalar has stride 0). Caps: 16 bands, 28 model
columns, ``N < 2**31`` points (one thread each). Past a cap it raises a
``ValueError`` that names it; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch

from ._build import load_library
from .catalog_cuda import compact_table
from .generate import ForwardModel
from .star_cuda import _KINDS, _Axis, _axes

__all__ = ["generate_cuda", "get_eep_cuda", "MAX_BANDS", "MAX_PROPS"]

MAX_BANDS = 16
_MAX_COLS = 32
#: model columns a call may ask for, beside the 4 the magnitudes need
MAX_PROPS = _MAX_COLS - 4
_MAX_POINTS = 1 << 31
#: the kernel's Mode
_INVERT, _GIVEN, _EEP_ONLY = 0, 1, 2


class _GenerateArgs(ctypes.Structure):
    """Mirror of ``GenerateArgs`` in ``csrc/generate.cu`` (checked by size)."""

    _fields_ = [
        ("inp", ctypes.c_void_p * 5), ("eeps_in", ctypes.c_void_p), ("model", ctypes.c_void_p),
        ("bc", ctypes.c_void_p), ("age_rows", ctypes.c_void_p), ("lengths", ctypes.c_void_p),
        ("eep", ctypes.c_void_p), ("props", ctypes.c_void_p), ("mags", ctypes.c_void_p), ("mags0", ctypes.c_void_p),
        ("stride", ctypes.c_longlong * 5), ("N", ctypes.c_longlong), ("n_eep", ctypes.c_longlong),
        ("n_tracks", ctypes.c_longlong), ("eep0", ctypes.c_double), ("io", ctypes.c_int * 3),
        ("n_steps", ctypes.c_int), ("row_len", ctypes.c_int), ("ncols", ctypes.c_int), ("P", ctypes.c_int),
        ("n_bands", ctypes.c_int), ("bc_ncols", ctypes.c_int), ("pad", ctypes.c_int),
        ("cols", ctypes.c_int * _MAX_COLS), ("inv_ax", _Axis * 2), ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4),
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


#: per forward model: {(dtype, device, band columns): (argument struct template, tensors it points into)}
_TEMPLATES = weakref.WeakKeyDictionary()


def _template(fm: ForwardModel, band_icols, dtype, device):
    """The argument struct of ``fm`` and these bands, with the tensors it
    points into; raises on what the kernel does not take."""
    key = (dtype, device, tuple(int(c) for c in band_icols))
    per_fm = _TEMPLATES.setdefault(fm, {})
    if key in per_fm:
        return per_fm[key][0]
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
    a.model, a.row_len = fm.model.values.data_ptr(), fm.model.values.shape[-1]
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
    a.n_bands = len(key[2])
    a.bc_ncols = 4
    if a.n_bands:
        table = compact_table(fm.bc, key[2])
        a.bc, a.bc_ncols = table.data_ptr(), table.shape[-1]
        a.bc_ax[:] = _axes(fm.bc, dtype, device, "BC")
        keep.append(table)
    per_fm[key] = (a, keep)
    return a


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


def generate_cuda(fm: ForwardModel, mass, age, feh, distance, AV, prop_icols, band_icols, eeps=None, all_As=False):
    """``(eeps (N,), props (N, P), mags (N, n_bands), mags at AV = 0 or
    None)`` from one kernel launch: the EEP inverted in the kernel, or the
    given ``eeps`` (returned as they are). Raises on anything the kernel does
    not take, and if the launch fails."""
    prop_icols = tuple(int(c) for c in prop_icols)
    if len(prop_icols) > MAX_PROPS:
        raise ValueError(f"forward-model kernel takes at most {MAX_PROPS} model columns, got {len(prop_icols)}")
    if len(band_icols) > MAX_BANDS:
        raise ValueError(f"forward-model kernel takes at most {MAX_BANDS} bands, got {len(band_icols)}")
    xs = [mass, age, feh, distance, AV] + ([] if eeps is None else [eeps])
    n = _check_inputs(xs, ["mass", "age", "feh", "distance", "AV", "eeps"], "generate_cuda")
    dt, dev = mass.dtype, mass.device
    row_len = fm.model.values.shape[-1]
    if any(not 0 <= c < row_len for c in prop_icols):
        raise ValueError(f"model column outside the table of {row_len} columns: {prop_icols}")
    call = _GenerateArgs.from_buffer_copy(_template(fm, band_icols, dt, dev))
    nb = call.n_bands
    cols = tuple(int(c) for c in fm.model_icols) + prop_icols
    call.cols[: len(cols)] = cols
    call.ncols, call.P, call.N = len(cols), len(prop_icols), n
    _point_args(call, xs[:5])
    props = torch.empty((n, len(prop_icols)), dtype=dt, device=dev)
    mags = torch.empty((n, nb), dtype=dt, device=dev)
    mags0 = torch.empty((n, nb), dtype=dt, device=dev) if all_As else None
    call.props, call.mags = props.data_ptr(), mags.data_ptr()
    call.mags0 = None if mags0 is None or nb == 0 else mags0.data_ptr()
    if eeps is None:
        eeps = torch.empty((n,), dtype=dt, device=dev)
        call.eep, mode = eeps.data_ptr(), _INVERT
    else:
        eeps = eeps.contiguous()
        call.eeps_in, mode = eeps.data_ptr(), _GIVEN
    _launch(call, mode, dt, dev, "generate")
    generate_cuda.launches += 1
    return eeps, props, mags, mags0


def get_eep_cuda(fm: ForwardModel, mass, age, feh):
    """The fast EEP inversion ``(N,)`` of 1-d tensors, from one launch of the
    kernel's EEP-only form."""
    n = _check_inputs([mass, age, feh], ["mass", "age", "feh"], "get_eep_cuda")
    dt, dev = mass.dtype, mass.device
    call = _GenerateArgs.from_buffer_copy(_template(fm, (), dt, dev))
    call.N = n
    _point_args(call, [mass, age, feh])
    out = torch.empty((n,), dtype=dt, device=dev)
    call.eep = out.data_ptr()
    _launch(call, _EEP_ONLY, dt, dev, "get_eep")
    get_eep_cuda.launches += 1
    return out


#: kernel launches made through each wrapper (reset by callers that count)
generate_cuda.launches = 0
get_eep_cuda.launches = 0
